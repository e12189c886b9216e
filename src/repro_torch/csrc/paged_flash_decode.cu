// Flash-decode for Hopper (sm_90a), paged and contiguous, plain C interface
// for ctypes.
//
// Replaces two TPU kernels of src/repro/kernels/flash_decode/kernel.py:
// paged_flash_decode_kernel (body _paged_decode_kernel), one-token GQA
// decode attention over a block-paged KV pool, and flash_decode_kernel
// (body _decode_kernel), the same over a contiguous (B, S, Hkv, D) cache
// with a kv_len mask.  One split kernel serves both: kContig selects how a
// tile of keys is addressed (a page id from ptab, or rows b*S + p*page of
// the contiguous cache by stride -- no page table is built for it).
//
// Bound: bytes (each live K/V element is read once for the G = H/Hkv query
// heads of its group, ~4G flops per element).  Pass 1: grid (B*Hkv,
// n_splits); a block owns one (lane, KV head) and a run of pages_per_split
// tiles ("pages").  The next tile's K and V rows are fetched into
// registers with 16-byte loads while the current tile is processed from
// shared memory (f32), so load latency overlaps the G x page scores, the
// online-softmax update (m, l) per query head and the P.V accumulation,
// all in f32.  Tiles at or past kv_len, or wholly below the sliding
// window's lower bound, are never loaded, and a split with no live tile
// exits at once.  A live block writes its partial (m, l, acc).  Pass 2:
// grid (B*Hkv) rescales and sums the partials of the live splits and
// writes acc / max(l, 1e-30) -- zero for kv_len = 0, as the TPU kernels'
// flush.

#include <stddef.h>

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::Pack8;

constexpr int kThreads = 128;
constexpr int kMaxLoads = 4;     // Pack8 fetches per thread per page: page*D <= 4096

// kContig: kp/vp are the (B, S, Hkv, D) cache and tile p of lane b is rows
// [p*page, p*page + page) of that lane (rows past S read as zero); ptab is
// not read.  Otherwise tile p of lane b is physical page ptab[b][p].
template <typename T, bool kContig>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ ptab, const int* __restrict__ kv_len,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    int H, int Hkv, int D, int page, int n_ptab, int S, int pages_per_split,
    int window, float scale) {
  const int G = H / Hkv;
  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int b = bh / Hkv;
  const int kvh = bh - b * Hkv;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* qs = smem;                     // [G][D]
  float* ks = qs + G * D;               // [page][D+1]  (padded: no bank conflicts)
  float* vs = ks + page * (D + 1);      // [page][D]
  float* sc = vs + page * D;            // [G][page]    scores, then probabilities
  float* acc = sc + G * page;           // [G][D]
  float* m = acc + G * D;               // [G]
  float* l = m + G;                     // [G]
  float* alpha = l + G;                 // [G]

  const int len = kv_len[b];
  const int lo = window > 0 ? max(len - window, 0) : 0;
  int p0 = split * pages_per_split;
  int p1 = min(p0 + pages_per_split, n_ptab);
  p0 = max(p0, lo / page);                  // pages wholly below the window
  p1 = min(p1, (len + page - 1) / page);    // pages at or past kv_len
  if (p0 >= p1) return;                     // dead split: the combine skips it

  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = repro::to_f(qb[i]);
    acc[i] = 0.f;
  }
  if (tid < G) {
    m[tid] = kNegInf;
    l[tid] = 0.f;
  }

  const int dv = D / 8;                     // Pack8 vectors per row
  const int nvec = page * dv;
  Pack8<T> kr[kMaxLoads], vr[kMaxLoads];
  auto fetch = [&](int p) {
    const size_t row0 = kContig ? (size_t)b * S + (size_t)p * page
                                : (size_t)ptab[(size_t)b * n_ptab + p] * page;
#pragma unroll
    for (int j = 0; j < kMaxLoads; ++j) {
      const int i = tid + j * kThreads;
      if (i < nvec) {
        const int t = i / dv;
        if (!kContig || p * page + t < S) {
          const size_t off = ((row0 + t) * Hkv + kvh) * D + (i - t * dv) * 8;
          kr[j].load(kp + off);
          vr[j].load(vp + off);
        } else {                              // ragged last tile of the lane
          kr[j].zero();
          vr[j].zero();
        }
      }
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < kMaxLoads; ++j) {
      const int i = tid + j * kThreads;
      if (i < nvec) {
        const int t = i / dv;
        const int d = (i - t * dv) * 8;
        float kf[8], vf[8];
        kr[j].unpack(kf);
        vr[j].unpack(vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ks[t * (D + 1) + d + e] = kf[e];
          vs[t * D + d + e] = vf[e];
        }
      }
    }
  };

  if (p0 < p1) fetch(p0);
  for (int p = p0; p < p1; ++p) {
    __syncthreads();                        // previous page fully consumed
    stash();
    __syncthreads();
    if (p + 1 < p1) fetch(p + 1);           // in flight during this page
    const int k0 = p * page;
    for (int i = tid; i < G * page; i += kThreads) {
      const int g = i / page;
      const int t = i - g * page;
      const float* qr = qs + g * D;
      const float* kr_s = ks + t * (D + 1);
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr_s[d], s);
      const int kpos = k0 + t;
      sc[i] = (kpos < len && kpos >= lo) ? s * scale : kNegInf;
    }
    __syncthreads();
    if (tid < G) {
      const int g = tid;
      float* sr = sc + g * page;
      float mx = m[g];
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, sr[t]);
      const float a = expf(m[g] - mx);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const int kpos = k0 + t;
        const float pv = (kpos < len && kpos >= lo) ? expf(sr[t] - mx) : 0.f;
        sr[t] = pv;
        sum += pv;
      }
      l[g] = l[g] * a + sum;
      m[g] = mx;
      alpha[g] = a;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pr = sc + g * page;
      float a = acc[i] * alpha[g];
      for (int t = 0; t < page; ++t) a = fmaf(pr[t], vs[t * D + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();

  const size_t part = (size_t)bh * n_splits + split;
  float* pa = part_acc + part * G * D;
  for (int i = tid; i < G * D; i += kThreads) pa[i] = acc[i];
  if (tid < G) {
    part_ml[part * 2 * G + tid] = m[tid];
    part_ml[part * 2 * G + G + tid] = l[tid];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ kv_len, T* __restrict__ out, int H, int Hkv, int D,
    int page, int pages_per_split, int n_splits, int window) {
  const int G = H / Hkv;
  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int kvh = bh - b * Hkv;
  // the splits pass 1 ran (the same live-page bounds); none: kv_len = 0 -> 0
  const int len = kv_len[b];
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int s0 = (lo / page) / pages_per_split;
  const int s1 = min(n_splits, ((len + page - 1) / page + pages_per_split - 1) /
                                   pages_per_split);
  T* ob = out + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    float M = kNegInf;
    for (int s = s0; s < s1; ++s)
      M = fmaxf(M, part_ml[((size_t)bh * n_splits + s) * 2 * G + g]);
    float L = 0.f, A = 0.f;
    for (int s = s0; s < s1; ++s) {
      const size_t part = (size_t)bh * n_splits + s;
      const float w = expf(part_ml[part * 2 * G + g] - M);
      L += part_ml[part * 2 * G + G + g] * w;
      A += part_acc[part * G * D + i] * w;
    }
    repro::put(ob + i, A / fmaxf(L, 1e-30f));
  }
}

template <typename T, bool kContig>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ptab, const void* kv_len, void* out,
                   void* part_acc, void* part_ml, int B, int H, int Hkv, int D,
                   int page, int n_ptab, int S, int pages_per_split,
                   int n_splits, int window, float scale, cudaStream_t stream) {
  if (D % 8 != 0 || page * D > kMaxLoads * 8 * kThreads) return cudaErrorInvalidValue;
  const int G = H / Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)2 * G * D + (size_t)page * (2 * D + 1) +
                       (size_t)G * page + 3 * G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T, kContig>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B * Hkv, n_splits);
  decode_split_kernel<T, kContig><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(ptab),
      static_cast<const int*>(kv_len), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), H, Hkv, D, page, n_ptab, S,
      pages_per_split, window, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<T><<<B * Hkv, kThreads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(kv_len), static_cast<T*>(out), H, Hkv, D, page,
      pages_per_split, n_splits, window);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no sliding window.
// D % 8 == 0, page * D <= 4096, K/V pools 16-byte aligned.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int paged_flash_decode(int dtype, const void* q, const void* kp,
                                  const void* vp, const void* ptab,
                                  const void* kv_len, void* out, void* part_acc,
                                  void* part_ml, int B, int H, int Hkv, int D,
                                  int page, int n_ptab, int pages_per_split,
                                  int n_splits, int window, float scale,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(q, kp, vp, ptab, kv_len, out, part_acc,
                                part_ml, B, H, Hkv, D, page, n_ptab, 0,
                                pages_per_split, n_splits, window, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(q, kp, vp, ptab, kv_len, out,
                                        part_acc, part_ml, B, H, Hkv, D, page,
                                        n_ptab, 0, pages_per_split, n_splits,
                                        window, scale, st);
  return cudaErrorInvalidValue;
}

// Contiguous cache k, v (B, S, Hkv, D), read in tiles of `tile` rows
// (tile * D <= 4096, D % 8 == 0, 16-byte aligned); no window.  Same
// partial buffers and return value as paged_flash_decode.
extern "C" int flash_decode(int dtype, const void* q, const void* k,
                            const void* v, const void* kv_len, void* out,
                            void* part_acc, void* part_ml, int B, int H,
                            int Hkv, int D, int S, int tile,
                            int tiles_per_split, int n_splits, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (S + tile - 1) / tile;
  if (dtype == 0)
    return launch<float, true>(q, k, v, nullptr, kv_len, out, part_acc,
                               part_ml, B, H, Hkv, D, tile, n_tiles, S,
                               tiles_per_split, n_splits, -1, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(q, k, v, nullptr, kv_len, out,
                                       part_acc, part_ml, B, H, Hkv, D, tile,
                                       n_tiles, S, tiles_per_split, n_splits,
                                       -1, scale, st);
  return cudaErrorInvalidValue;
}
