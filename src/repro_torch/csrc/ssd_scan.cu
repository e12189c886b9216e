// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// ::ssd_scan_kernel (body _ssd_kernel), and unlike it takes an initial
// state and writes the final state, as models/ssd.py::ssd_chunked does:
//   y_i   = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i.state_prev                      (per chunk)
//   state = state_prev exp(cum_end) + sum_j B_j exp(cum_end - cum_j) dt_j x_j
// with cum the running sum of dt*A inside the chunk.
//
// The TPU grid walks the chunks of a (lane, head block) in order and keeps
// the state in VMEM scratch between grid steps.  Blocks on the card run in
// no order, so the chunk loop lives inside the block: grid (H, batch), one
// block per (lane, head), which keeps its (P, N) f32 state in registers
// (32 values a thread) with a copy in shared memory for the C.state product.
// Per chunk of kL = 32 positions the block stages B and C (kL x N), dt*x
// (kL x P) and dt in shared memory as f32 (16-byte loads), scans dt*A with
// warp shuffles, builds the masked (kL x kL) score-decay matrix, writes y
// and updates the state -- all on the CUDA cores, accumulating in f32.
// Bound: operations at long sequences (the intra-chunk and state products,
// ~2(kL + 2N)P flops per position and head), bytes at short ones (the
// state is read and written once).  With one lane and H = 64 the grid has
// 64 blocks for the card's 132 SMs.

#include <stddef.h>

#include "common.cuh"

namespace {

using repro::Pack8;

constexpr int kThreads = 256;
constexpr int kL = 32;          // positions per chunk inside the block

template <int P, int N>
struct Layout {                 // shared-memory offsets, in floats
  static constexpr int kBs = 0;                      // [kL][N+1]
  static constexpr int kCs = kBs + kL * (N + 1);     // [kL][N+1]
  static constexpr int kXd = kCs + kL * (N + 1);     // [kL][P]   dt*x
  static constexpr int kMs = kXd + kL * P;           // [kL][kL+1] scores*decay
  static constexpr int kSt = kMs + kL * (kL + 1);    // [P][N+1]  state
  static constexpr int kDt = kSt + P * (N + 1);      // [kL]
  static constexpr int kCum = kDt + kL;              // [kL]
  static constexpr int kEnd = kCum + kL;             // [kL] exp(cum_end - cum_j)
  static constexpr int kFloats = kEnd + kL;
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const T* __restrict__ init, T* __restrict__ y,
    T* __restrict__ fin, int S, int H) {
  using Lay = Layout<P, N>;
  static_assert(kL == 32, "the dt*A scan is one warp wide");
  static_assert(kThreads == 256 && P % 16 == 0 && N % 32 == 0, "thread maps");
  constexpr int kRI = kL / 16;     // (i) rows per thread in the score and y tiles
  constexpr int kPJ = P / 16;      // (p) columns per thread in the y tile
  constexpr int kSP = P / 8;       // state rows per thread
  constexpr int kSN = N / 32;      // state columns per thread

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ti = tid >> 4, tj = tid & 15;    // rows ti+16k, columns tj+16k
  const int sp = tid >> 5, sn = tid & 31;    // state rows sp+8k, columns sn+32k

  extern __shared__ float smem[];
  float* Bs = smem + Lay::kBs;
  float* Cs = smem + Lay::kCs;
  float* Xd = smem + Lay::kXd;
  float* Ms = smem + Lay::kMs;
  float* St = smem + Lay::kSt;
  float* dts = smem + Lay::kDt;
  float* cum = smem + Lay::kCum;
  float* dend = smem + Lay::kEnd;

  const float a = A[h];
  const size_t st_off = ((size_t)b * H + h) * P * N;
  float st[kSP][kSN];
#pragma unroll
  for (int r = 0; r < kSP; ++r)
#pragma unroll
    for (int c = 0; c < kSN; ++c) {
      const int pp = sp + 8 * r, nn = sn + 32 * c;
      const float v = init != nullptr ? repro::to_f(init[st_off + pp * N + nn]) : 0.f;
      st[r][c] = v;
      St[pp * (N + 1) + nn] = v;
    }

  for (int c0 = 0; c0 < S; c0 += kL) {
    const int l = min(kL, S - c0);
    __syncthreads();                         // previous chunk fully consumed
    // (a) stage dt, B, C and x of this chunk; rows past l are zero
    if (tid < kL) dts[tid] = tid < l ? dt[((size_t)b * S + c0 + tid) * H + h] : 0.f;
    for (int i = tid; i < kL * (N / 8); i += kThreads) {
      const int r = i / (N / 8);
      const int c8 = (i - r * (N / 8)) * 8;
      float bf[8], cf[8];
      if (r < l) {
        const size_t off = ((size_t)b * S + c0 + r) * N + c8;
        Pack8<T> pb, pc;
        pb.load(Bm + off);
        pc.load(Cm + off);
        pb.unpack(bf);
        pc.unpack(cf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) bf[e] = cf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        Bs[r * (N + 1) + c8 + e] = bf[e];
        Cs[r * (N + 1) + c8 + e] = cf[e];
      }
    }
    for (int i = tid; i < kL * (P / 8); i += kThreads) {
      const int r = i / (P / 8);
      const int c8 = (i - r * (P / 8)) * 8;
      float xf[8];
      if (r < l) {
        Pack8<T> px;
        px.load(x + (((size_t)b * S + c0 + r) * H + h) * P + c8);
        px.unpack(xf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) xf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) Xd[r * P + c8 + e] = xf[e];
    }
    __syncthreads();

    // (b) cum = inclusive scan of dt*A (padded rows add 0, so cum[kL-1] is
    //     the chunk's end value); x *= dt
    if (tid < 32) {
      float v = dts[tid] * a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (tid >= o) v += u;
      }
      cum[tid] = v;
      const float end = __shfl_sync(0xffffffffu, v, 31);
      dend[tid] = tid < l ? expf(end - v) : 0.f;
    }
    for (int i = tid; i < kL * P; i += kThreads) Xd[i] *= dts[i / P];
    __syncthreads();

    // (c) Ms[i][j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0
    {
      float acc[kRI][kRI];
#pragma unroll
      for (int u = 0; u < kRI; ++u)
#pragma unroll
        for (int w = 0; w < kRI; ++w) acc[u][w] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[kRI], bv[kRI];
#pragma unroll
        for (int u = 0; u < kRI; ++u) cv[u] = Cs[(ti + 16 * u) * (N + 1) + n];
#pragma unroll
        for (int w = 0; w < kRI; ++w) bv[w] = Bs[(tj + 16 * w) * (N + 1) + n];
#pragma unroll
        for (int u = 0; u < kRI; ++u)
#pragma unroll
          for (int w = 0; w < kRI; ++w) acc[u][w] = fmaf(cv[u], bv[w], acc[u][w]);
      }
#pragma unroll
      for (int u = 0; u < kRI; ++u)
#pragma unroll
        for (int w = 0; w < kRI; ++w) {
          const int i = ti + 16 * u, j = tj + 16 * w;
          Ms[i * (kL + 1) + j] = j <= i ? acc[u][w] * expf(cum[i] - cum[j]) : 0.f;
        }
    }
    __syncthreads();

    // (d) y_i = sum_j Ms[i][j] Xd[j] + exp(cum_i) C_i . state_prev
    {
      float yd[kRI][kPJ], yo[kRI][kPJ];
#pragma unroll
      for (int u = 0; u < kRI; ++u)
#pragma unroll
        for (int w = 0; w < kPJ; ++w) yd[u][w] = yo[u][w] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kL; ++j) {
        float mv[kRI], xv[kPJ];
#pragma unroll
        for (int u = 0; u < kRI; ++u) mv[u] = Ms[(ti + 16 * u) * (kL + 1) + j];
#pragma unroll
        for (int w = 0; w < kPJ; ++w) xv[w] = Xd[j * P + tj + 16 * w];
#pragma unroll
        for (int u = 0; u < kRI; ++u)
#pragma unroll
          for (int w = 0; w < kPJ; ++w) yd[u][w] = fmaf(mv[u], xv[w], yd[u][w]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[kRI], sv[kPJ];
#pragma unroll
        for (int u = 0; u < kRI; ++u) cv[u] = Cs[(ti + 16 * u) * (N + 1) + n];
#pragma unroll
        for (int w = 0; w < kPJ; ++w) sv[w] = St[(tj + 16 * w) * (N + 1) + n];
#pragma unroll
        for (int u = 0; u < kRI; ++u)
#pragma unroll
          for (int w = 0; w < kPJ; ++w) yo[u][w] = fmaf(cv[u], sv[w], yo[u][w]);
      }
#pragma unroll
      for (int u = 0; u < kRI; ++u) {
        const int i = ti + 16 * u;
        if (i < l) {
          const float e = expf(cum[i]);
          T* yr = y + (((size_t)b * S + c0 + i) * H + h) * P;
#pragma unroll
          for (int w = 0; w < kPJ; ++w)
            repro::put(yr + tj + 16 * w, fmaf(e, yo[u][w], yd[u][w]));
        }
      }
    }
    __syncthreads();                         // every read of St is done

    // (e) state = state exp(cum_end) + sum_j B_j exp(cum_end - cum_j) dt_j x_j
    {
      const float dec = expf(cum[kL - 1]);
#pragma unroll
      for (int r = 0; r < kSP; ++r)
#pragma unroll
        for (int c = 0; c < kSN; ++c) st[r][c] *= dec;
      for (int j = 0; j < l; ++j) {
        const float w = dend[j];
        float xv[kSP], bv[kSN];
#pragma unroll
        for (int r = 0; r < kSP; ++r) xv[r] = w * Xd[j * P + sp + 8 * r];
#pragma unroll
        for (int c = 0; c < kSN; ++c) bv[c] = Bs[j * (N + 1) + sn + 32 * c];
#pragma unroll
        for (int r = 0; r < kSP; ++r)
#pragma unroll
          for (int c = 0; c < kSN; ++c) st[r][c] = fmaf(xv[r], bv[c], st[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kSP; ++r)
#pragma unroll
        for (int c = 0; c < kSN; ++c)
          St[(sp + 8 * r) * (N + 1) + sn + 32 * c] = st[r][c];
    }
  }

#pragma unroll
  for (int r = 0; r < kSP; ++r)
#pragma unroll
    for (int c = 0; c < kSN; ++c)
      repro::put(fin + st_off + (sp + 8 * r) * N + sn + 32 * c, st[r][c]);
}

template <typename T, int P, int N>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, const void* init, void* y, void* fin,
                   int batch, int S, int H, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * Layout<P, N>::kFloats;
  static bool smem_set = false;     // callers hold the Python GIL
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  dim3 grid(H, batch);
  ssd_scan_kernel<T, P, N><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const T*>(init),
      static_cast<T*>(y), static_cast<T*>(fin), S, H);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, init, y, fin); dt and A f32.
// (P, N) = (64, 128) only.  init may be null (zero state).  x, B, C 16-byte
// aligned, everything contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int ssd_scan(int dtype, const void* x, const void* dt, const void* A,
                        const void* B, const void* C, const void* init,
                        void* y, void* fin, int batch, int S, int H, int P,
                        int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P != 64 || N != 128) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, 64, 128>(x, dt, A, B, C, init, y, fin, batch, S, H, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, 64, 128>(x, dt, A, B, C, init, y, fin, batch,
                                          S, H, st);
  return cudaErrorInvalidValue;
}
