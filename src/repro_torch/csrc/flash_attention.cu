// Flash attention (prefill) for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// ::flash_attention_kernel (body _attn_kernel): blocked online-softmax
// attention with end-aligned causal masking, an optional sliding window and
// an optional tanh logit softcap; fully masked kv blocks are skipped.
// Two differences from the TPU kernel: GQA happens inside the kernel (K/V
// arrive un-repeated, (B, Sk, Hkv, D)), and an optional per-row kv_len
// bounds the keys (key positions >= kv_len[b] are masked and the query at
// row i sits at position kv_len[b] - Sq + i).  With kv_len = Sk this is the
// TPU kernel; with kv_len = the paged lengths it is the paged prefill mask.
//
// Bound: operations at long contexts, bytes at short ones.  Design: grid
// (ceil(Sq*G / 64), B*Hkv); a block owns 64 flattened (query, head-in-group)
// rows of one KV head, so each K/V tile is loaded once for all G heads.
// K/V tiles of 32 keys are staged in shared memory as f32; each thread
// holds a 4x4 register tile of scores and a 4 x D/8 slice of the f32
// accumulator; row max and sum are reduced over the 8 threads of a row
// group with warp shuffles.  The next tile is fetched into registers with
// 16-byte loads while the current one is processed, so load latency
// overlaps the arithmetic.  Only tiles that hold a key some row of the
// block may see are visited (kv_len, causal and window bounds), so a row
// with kv_len = 0 writes acc / max(l, 1e-30) = 0.

#include <stddef.h>

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::Pack8;

constexpr int kThreads = 128;
constexpr int kRows = 64;     // flattened (query, head) rows per block
constexpr int kKeys = 32;     // keys per tile

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kRows * (D + 1) + (size_t)kKeys * (D + 1) +
                          (size_t)kKeys * D + (size_t)kRows * (kKeys + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_len, T* __restrict__ out, int Sq, int Sk, int H,
    int Hkv, int causal, int window, float softcap, float scale) {
  constexpr int DJ = D / 8;                 // accumulator columns per thread
  const int G = H / Hkv;
  const int bh = blockIdx.y;
  const int b = bh / Hkv;
  const int kvh = bh - b * Hkv;
  const int nrows = Sq * G;
  const int r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int rg = tid >> 3;                  // row group: rows rg*4 .. rg*4+3
  const int cg = tid & 7;                   // column group

  extern __shared__ float smem[];
  float* Qs = smem;                         // [kRows][D+1]
  float* Ks = Qs + kRows * (D + 1);         // [kKeys][D+1]
  float* Vs = Ks + kKeys * (D + 1);         // [kKeys][D]
  float* Ps = Vs + kKeys * D;               // [kRows][kKeys+1]

  const int len = kv_len[b];
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int fr = r0 + r;
    float val = 0.f;
    if (fr < nrows) {
      const int qi = fr / G;
      const int g = fr - qi * G;
      val = repro::to_f(q[(((size_t)b * Sq + qi) * H + (size_t)kvh * G + g) * D + d]);
    }
    Qs[r * (D + 1) + d] = val;
  }

  int qpos[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int fr = min(r0 + rg * 4 + ii, nrows - 1);
    qpos[ii] = len - Sq + fr / G;
  }
  const int row_hi = min(r0 + kRows, nrows) - 1;
  const int qmin = len - Sq + r0 / G;
  const int qmax = len - Sq + row_hi / G;
  int k_hi = min(len, Sk);
  if (causal) k_hi = min(k_hi, qmax + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, qmin - window + 1);

  float m_i[4], l_i[4], acc[4][DJ];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m_i[ii] = kNegInf;
    l_i[ii] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[ii][j] = 0.f;
  }
  __syncthreads();

  constexpr int kDv = D / 8;                     // Pack8 vectors per row
  constexpr int kLoads = kKeys * kDv / kThreads;  // per thread per tile
  static_assert(kKeys * kDv % kThreads == 0, "tile must split evenly");
  Pack8<T> kr[kLoads], vr[kLoads];
  auto fetch = [&](int kt) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      const int c = i / kDv;
      const int kk = kt + c;
      if (kk < Sk) {
        const size_t off = (((size_t)b * Sk + kk) * Hkv + kvh) * D + (i - c * kDv) * 8;
        kr[j].load(k + off);
        vr[j].load(v + off);
      } else {
        kr[j].zero();
        vr[j].zero();
      }
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      const int c = i / kDv;
      const int d = (i - c * kDv) * 8;
      float kf[8], vf[8];
      kr[j].unpack(kf);
      vr[j].unpack(vf);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        Ks[c * (D + 1) + d + e] = kf[e];
        Vs[c * D + d + e] = vf[e];
      }
    }
  };

  const int kt0 = (k_lo / kKeys) * kKeys;
  if (kt0 < k_hi) fetch(kt0);
  for (int kt = kt0; kt < k_hi; kt += kKeys) {
    stash();
    __syncthreads();
    if (kt + kKeys < k_hi) fetch(kt + kKeys);   // in flight during this tile

    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) qv[ii] = Qs[(rg * 4 + ii) * (D + 1) + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = Ks[(cg * 4 + jj) * (D + 1) + d];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
    }

#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      bool ok[4];
      float mloc = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = kt + cg * 4 + jj;
        float x = s[ii][jj] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const int diff = qpos[ii] - kpos;
        bool valid = kpos < len && kpos < Sk;
        if (causal) valid = valid && diff >= 0;
        if (window > 0) valid = valid && diff < window;
        ok[jj] = valid;
        s[ii][jj] = valid ? x : kNegInf;
        mloc = fmaxf(mloc, s[ii][jj]);
      }
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 4));
      const float mnew = fmaxf(m_i[ii], mloc);
      const float a = expf(m_i[ii] - mnew);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = ok[jj] ? expf(s[ii][jj] - mnew) : 0.f;
        Ps[(rg * 4 + ii) * (kKeys + 1) + cg * 4 + jj] = p;
        psum += p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      l_i[ii] = l_i[ii] * a + psum;
      m_i[ii] = mnew;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[ii][j] *= a;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      float pv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) pv[ii] = Ps[(rg * 4 + ii) * (kKeys + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * D + cg + 8 * j];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) acc[ii][j] = fmaf(pv[ii], vv, acc[ii][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int fr = r0 + rg * 4 + ii;
    if (fr >= nrows) continue;
    const int qi = fr / G;
    const int g = fr - qi * G;
    T* o = out + (((size_t)b * Sq + qi) * H + (size_t)kvh * G + g) * D;
    const float denom = fmaxf(l_i[ii], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) repro::put(o + cg + 8 * j, acc[ii][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* out, int B, int Sq, int Sk, int H,
                   int Hkv, int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool smem_set = false;     // callers hold the Python GIL
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int G = H / Hkv;
  dim3 grid((Sq * G + kRows - 1) / kRows, B * Hkv);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(out), Sq, Sk, H, Hkv, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* kv_len, void* out, int B, int Sq, int Sk,
                       int H, int Hkv, int D, int causal, int window,
                       float softcap, float scale, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, kv_len, out, B, Sq, Sk, H, Hkv, causal,
                         window, softcap, scale, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, kv_len, out, B, Sq, Sk, H, Hkv, causal,
                          window, softcap, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D in {64, 128}.  window <= 0: none;
// softcap <= 0: none.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, const void* kv_len, void* out,
                               int B, int Sq, int Sk, int H, int Hkv, int D,
                               int causal, int window, float softcap,
                               float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, kv_len, out, B, Sq, Sk, H, Hkv, D,
                             causal, window, softcap, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, kv_len, out, B, Sq, Sk, H, Hkv, D,
                                     causal, window, softcap, scale, st);
  return cudaErrorInvalidValue;
}
