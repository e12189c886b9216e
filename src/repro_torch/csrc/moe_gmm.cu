// Grouped MoE SwiGLU for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/kernel.py:45
// ::moe_gmm_kernel (body _moe_kernel), the capacity-buffered expert FFN
//   y[e, c, :] = sum_f silu(x[e, c, :] . Wg[e, :, f]) * (x[e, c, :] . Wu[e, :, f])
//                      * Wd[e, f, :]
// with x (E, C, D), Wg/Wu (E, D, F), Wd (E, F, D) and an f32 accumulator.
//
// Bound on the card: bytes at serving shapes.  The expert weights are
// 3 E D F values (2.82 GB per mixtral layer in bf16) and every decode step
// reads all of them, because with 8 lanes every expert gets tokens: 0.84 ms
// at 3.35 TB/s, against 2 x 3 E C D F flops that reach the tensor cores'
// bound only near C = 400 tokens per expert.
//
// The TPU kernel walks F in grid order and keeps the (C, F) intermediate in
// VMEM.  Here it is two passes of one grouped-GEMM kernel:
//   1. gate/up: H[e, c, f] = silu(x Wg) * (x Wu), both products accumulated
//      in f32 from one staged x tile, H stored in the input type;
//   2. down:    y[e, c, :] = H[e, c, :] Wd[e], accumulated in f32.
// H goes through device memory: E C F values, 3.7 MB in f32 at C = 8 against
// 2.82 GB of weights, so the round trip costs ~0.1% of the bytes at decode
// and lets each pass read its weights once with a grid that fills the card.
// A block owns a (BM tokens x 64 columns) tile of one expert and streams its
// weight columns through a 4-stage cp.async ring of 32-row slices (16-byte
// copies, L1 bypassed).  bf16 runs mma.sync m16n8k16 on the tensor cores
// (ldmatrix, .trans for the row-major weights); f32 runs FMAs on the CUDA
// cores.  The token axis is masked, not padded: rows past C load as zeros
// and are never stored.  x may have expert stride 0 (one copy of the tokens
// for every expert, the dense mix), so no (E, C, D) copy is made.  Blocks
// with the same weight tile and different token tiles are neighbours in the
// grid, so at large C the weights come from L2 after the first tile.

#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;

constexpr int kBN = 64;       // output columns per block
constexpr int kBK = 32;       // reduction depth of one pipeline stage
constexpr int kStages = 4;

template <typename T>
constexpr int kVec = 16 / sizeof(T);    // elements per 16-byte copy (= row pad)

// Token tile and warp layout.  Small: decode (C <= 32), one 16-row mma tile,
// four warps side by side over the 64 columns.  Large: prefill, 128 rows,
// 4 x 2 warps of 32 x 32.
template <int BM_, int WARPS_M_, int WARPS_N_>
struct Tile {
  static constexpr int BM = BM_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = kBN / WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;      // mma tiles per warp
};
using Small = Tile<16, 1, 4>;
using Large = Tile<128, 4, 2>;

// Shared-memory ring, in elements: per stage an A tile [BM][kBK + pad] and
// NMAT weight tiles [kBK][kBN + pad].  The 16-byte pad keeps every row
// 16-byte aligned and spreads ldmatrix's eight rows over distinct banks.
template <typename T, class Cfg, int NMAT>
struct Ring {
  static constexpr int kLdA = kBK + kVec<T>;
  static constexpr int kLdB = kBN + kVec<T>;
  static constexpr int kA = Cfg::BM * kLdA;
  static constexpr int kB = kBK * kLdB;
  static constexpr int kStage = kA + NMAT * kB;
  static constexpr size_t kBytes = sizeof(T) * kStage * kStages;
};

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

// One stage: rows [0, rows) of the A tile (zeros below), NMAT weight slices.
template <typename T, class Cfg, int NMAT>
__device__ __forceinline__ void load_stage(T* st, const T* a, int lda, int rows,
                                           const T* const* b, int ldb,
                                           int k0, int tid) {
  using R = Ring<T, Cfg, NMAT>;
  constexpr int V = kVec<T>;
  constexpr int kAChunks = Cfg::BM * kBK / V;
  for (int i = tid; i < kAChunks; i += Cfg::kThreads) {
    const int r = i / (kBK / V), c = (i % (kBK / V)) * V;
    const bool ok = r < rows;
    cp_async16(st + r * R::kLdA + c, ok ? a + (size_t)r * lda + k0 + c : a,
               ok ? 16 : 0);
  }
  constexpr int kBChunks = kBK * kBN / V;
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
    for (int i = tid; i < kBChunks; i += Cfg::kThreads) {
      const int r = i / (kBN / V), c = (i % (kBN / V)) * V;
      cp_async16(st + R::kA + m * R::kB + r * R::kLdB + c,
                 b[m] + (size_t)(k0 + r) * ldb + c, 16);
    }
}

// Per-thread accumulators: bf16 holds mma fragments, f32 a column strip.
template <typename T, class Cfg, int NMAT>
struct Acc;

template <class Cfg, int NMAT>
struct Acc<bf16, Cfg, NMAT> {
  float v[NMAT][Cfg::MT][Cfg::NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
        for (int j = 0; j < Cfg::NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) v[m][i][j][q] = 0.f;
  }

  __device__ __forceinline__ void stage(const bf16* st, int tid) {
    using R = Ring<bf16, Cfg, NMAT>;
    const int lane = tid & 31, warp = tid >> 5;
    const int wm = (warp / Cfg::WARPS_N) * Cfg::WM, wn = (warp % Cfg::WARPS_N) * Cfg::WN;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[Cfg::MT][4];
#pragma unroll
      for (int i = 0; i < Cfg::MT; ++i)
        ldmatrix_x4(af[i], st + (wm + i * 16 + (lane & 15)) * R::kLdA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int m = 0; m < NMAT; ++m)
#pragma unroll
        for (int j = 0; j < Cfg::NT; j += 2) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, st + R::kA + m * R::kB + (kk + (lane & 15)) * R::kLdB
                                     + wn + j * 8 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < Cfg::MT; ++i) {
            mma_bf16(v[m][i][j], af[i], bfr[0], bfr[1]);
            mma_bf16(v[m][i][j + 1], af[i], bfr[2], bfr[3]);
          }
        }
    }
  }

  // Fragment (i, j, q): row wm + 16 i + lane / 4 + 8 (q / 2), column
  // wn + 8 j + 2 (lane % 4) + q % 2.
  __device__ __forceinline__ void store(bf16* out, int ldo, int rows, int tid) const {
    const int lane = tid & 31, warp = tid >> 5;
    const int wm = (warp / Cfg::WARPS_N) * Cfg::WM, wn = (warp % Cfg::WARPS_N) * Cfg::WN;
#pragma unroll
    for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
      for (int j = 0; j < Cfg::NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm + i * 16 + (lane >> 2) + 8 * h;
          if (r >= rows) continue;
          const int c = wn + j * 8 + 2 * (lane & 3);
          float o0 = v[0][i][j][2 * h], o1 = v[0][i][j][2 * h + 1];
          if (NMAT == 2) {
            o0 = silu(o0) * v[NMAT - 1][i][j][2 * h];
            o1 = silu(o1) * v[NMAT - 1][i][j][2 * h + 1];
          }
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * ldo + c) =
              __floats2bfloat162_rn(o0, o1);
        }
  }
};

template <class Cfg, int NMAT>
struct Acc<float, Cfg, NMAT> {
  static constexpr int kRows = Cfg::BM * kBN / Cfg::kThreads;   // rows per thread
  float v[NMAT][kRows];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[m][r] = 0.f;
  }

  // Thread t owns column t % 64 of rows (t / 64) kRows ..; a warp shares its
  // rows (broadcast reads of A) and spans 32 columns (no bank conflicts).
  __device__ __forceinline__ void stage(const float* st, int tid) {
    using R = Ring<float, Cfg, NMAT>;
    const int col = tid % kBN, row0 = (tid / kBN) * kRows;
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float b[NMAT];
#pragma unroll
      for (int m = 0; m < NMAT; ++m) b[m] = st[R::kA + m * R::kB + k * R::kLdB + col];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float a = st[(row0 + r) * R::kLdA + k];
#pragma unroll
        for (int m = 0; m < NMAT; ++m) v[m][r] = fmaf(a, b[m], v[m][r]);
      }
    }
  }

  __device__ __forceinline__ void store(float* out, int ldo, int rows, int tid) const {
    const int col = tid % kBN, row0 = (tid / kBN) * kRows;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row0 + r >= rows) break;
      const float o = NMAT == 2 ? silu(v[0][r]) * v[NMAT - 1][r] : v[0][r];
      out[(size_t)(row0 + r) * ldo + col] = o;
    }
  }
};

// out[e, m, n] = epilogue(A[e, m, :] . B_j[e, :, n]) for one (BM x 64) tile
// per block; grid (token tiles, N / 64, E).  A rows are K long (lda = K),
// weights (E, K, N) contiguous, out (E, M, N) contiguous.  NMAT = 2 is the
// gate/up pass (epilogue silu(g) * u), NMAT = 1 the down pass.
template <typename T, class Cfg, int NMAT>
__global__ void __launch_bounds__(Cfg::kThreads)
    moe_gmm_kernel(const T* __restrict__ a, long long a_se, int M, int K, int N,
                   const T* __restrict__ b0, const T* __restrict__ b1,
                   T* __restrict__ out) {
  using R = Ring<T, Cfg, NMAT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * Cfg::BM, n0 = blockIdx.y * kBN, e = blockIdx.z;
  const int rows = M - m0;
  const T* A = a + (size_t)e * a_se + (size_t)m0 * K;
  const size_t wofs = (size_t)e * K * N + n0;
  const T* B[NMAT];
  B[0] = b0 + wofs;
  if constexpr (NMAT == 2) B[1] = b1 + wofs;
  const int KT = K / kBK;

  Acc<T, Cfg, NMAT> acc;
  acc.zero();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage<T, Cfg, NMAT>(ring + s * R::kStage, A, K, rows, B, N, s * kBK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();     // stage kt has landed (this thread's copies)
    __syncthreads();                  // ... everyone's; stage kt - 1 is free
    const int nk = kt + kStages - 1;
    if (nk < KT)
      load_stage<T, Cfg, NMAT>(ring + (nk % kStages) * R::kStage, A, K, rows, B, N,
                               nk * kBK, tid);
    cp_async_commit();
    acc.stage(ring + (kt % kStages) * R::kStage, tid);
  }
  acc.store(out + ((size_t)e * M + m0) * N + n0, N, rows, tid);
}

template <typename T, class Cfg, int NMAT>
cudaError_t launch(const T* a, long long a_se, int E, int M, int K, int N, const T* b0,
                   const T* b1, T* out, cudaStream_t stream) {
  constexpr size_t smem = Ring<T, Cfg, NMAT>::kBytes;
  static bool smem_set = false;       // callers hold the Python GIL
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(moe_gmm_kernel<T, Cfg, NMAT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  dim3 grid((M + Cfg::BM - 1) / Cfg::BM, N / kBN, E);
  moe_gmm_kernel<T, Cfg, NMAT><<<grid, Cfg::kThreads, smem, stream>>>(a, a_se, M, K, N, b0,
                                                                      b1, out);
  return cudaGetLastError();
}

template <typename T, class Cfg>
cudaError_t run(const void* x, long long x_se, const void* wg, const void* wu,
                const void* wd, void* h, void* y, int E, int C, int D, int F,
                cudaStream_t stream) {
  cudaError_t err = launch<T, Cfg, 2>(static_cast<const T*>(x), x_se, E, C, D, F,
                                      static_cast<const T*>(wg), static_cast<const T*>(wu),
                                      static_cast<T*>(h), stream);
  if (err != cudaSuccess) return err;
  return launch<T, Cfg, 1>(static_cast<const T*>(h), (long long)C * F, E, C, F, D,
                           static_cast<const T*>(wd), nullptr, static_cast<T*>(y),
                           stream);
}

template <typename T>
cudaError_t run_any(const void* x, long long x_se, const void* wg, const void* wu,
                    const void* wd, void* h, void* y, int E, int C, int D, int F,
                    cudaStream_t stream) {
  if (C <= 32) return run<T, Small>(x, x_se, wg, wu, wd, h, y, E, C, D, F, stream);
  return run<T, Large>(x, x_se, wg, wu, wd, h, y, E, C, D, F, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor).  x (E, C, D) with rows
// contiguous and expert stride x_se elements (0: one copy for all experts);
// wg, wu (E, D, F), wd (E, F, D), h (E, C, F) scratch and y (E, C, D)
// contiguous, all 16-byte aligned; D and F multiples of 64; C >= 1.
// Returns cudaGetLastError() after each of the two launches.
extern "C" int moe_gmm(int dtype, const void* x, long long x_se, const void* wg,
                       const void* wu, const void* wd, void* h, void* y, int E, int C,
                       int D, int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || C < 1 || D % kBN || F % kBN) return cudaErrorInvalidValue;
  if (dtype == 0) return run_any<float>(x, x_se, wg, wu, wd, h, y, E, C, D, F, st);
  if (dtype == 1) return run_any<bf16>(x, x_se, wg, wu, wd, h, y, E, C, D, F, st);
  return cudaErrorInvalidValue;
}
