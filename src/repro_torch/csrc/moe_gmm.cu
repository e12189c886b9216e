// Grouped MoE SwiGLU for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/kernel.py:45
// ::moe_gmm_kernel (body _moe_kernel), the capacity-buffered expert FFN
//   y[e, c, :] = sum_f silu(x[e, c, :] . Wg[e, :, f]) * (x[e, c, :] . Wu[e, :, f])
//                      * Wd[e, f, :]
// with x (E, C, D), Wg/Wu (E, D, F), Wd (E, F, D) and an f32 accumulator.
//
// Bound on the card: bytes at decode, operations at dense prefill.  The
// expert weights are 3 E D F values (2.82 GB per mixtral layer in bf16)
// and every call reads all of them: 0.84 ms at 3.35 TB/s, against
// 2 x 3 E C D F flops that pass it near C = 400 tokens per expert (C 512:
// 1.44e12 flops, 1.46 ms at 989 TFLOP/s).
//
// The TPU kernel walks F in grid order and keeps the (C, F) intermediate in
// VMEM.  Here it is two passes, two launches:
//   1. gate/up: H[e, c, f] = silu(x Wg) * (x Wu), both products accumulated
//      in f32 from one staged x tile, H rounded once to the input type;
//   2. down:    y[e, c, :] = H[e, c, :] Wd[e], accumulated in f32.
// H goes through device memory (117 MB of bf16 at C 512, a ~0.07 ms round
// trip) so that each pass reads its weights once.  The token axis is
// masked, not padded, and x may have expert stride 0 (one copy of the
// tokens for every expert, the dense mix), so no (E, C, D) copy is made.
//
// Three bodies:
// * bf16 with C > 32 (prefill), namespace tc: wgmma fed by TMA.  Persistent
//   clusters of two blocks walk a static order of pair tiles in which the
//   pairs of one (expert, column tile) are neighbours, so each weight tile
//   comes from HBM once and then from L2; the two blocks of a cluster share
//   each 64-deep stage through a TMA multicast (token pairs: the weights;
//   column pairs: the token rows; see there).  In each block one producer
//   thread keeps a 4-stage ring full through full/empty mbarriers (a stage
//   is refilled when the consumers of both blocks have released it), and
//   consumer warpgroups of 64 token rows run wgmma with the weights read
//   N-major, straight from their row-major layout, through the transpose
//   bit.  The epilogue stages the tile in shared memory in the 128-byte
//   swizzle and TMA-stores it; rows past C, which TMA read as zeros, are
//   clipped by the store, and a 64-row part wholly past C is idle.
// * bf16 with C <= 32 (decode), namespace dec: the swapped product
//   out^T = W^T x^T on wgmma fed by TMA, byte-bound; see there.
// * f32 (the card's checks against f32 references): a (BM tokens x 64
//   columns) tile per block streams its weight columns through a 4-stage
//   cp.async ring of 32-row slices and multiplies on the CUDA cores.

#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;

constexpr int kBN = 64;       // output columns per block
constexpr int kBK = 32;       // reduction depth of one pipeline stage
constexpr int kStages = 4;

template <typename T>
constexpr int kVec = 16 / sizeof(T);    // elements per 16-byte copy (= row pad)

// Token tile and warps of the f32 body.  Small: C <= 32, 16 rows, four
// warps.  Large: 128 rows, eight warps.
template <int BM_, int WARPS_M_, int WARPS_N_>
struct Tile {
  static constexpr int BM = BM_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
};
using Small = Tile<16, 1, 4>;
using Large = Tile<128, 4, 2>;

// Shared-memory ring, in elements: per stage an A tile [BM][kBK + pad] and
// NMAT weight tiles [kBK][kBN + pad].  The 16-byte pad keeps every row
// 16-byte aligned.
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

// Per-thread accumulators: a column strip.
template <typename T, class Cfg, int NMAT>
struct Acc;

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
__device__ __forceinline__ void gmm_tile(const T* __restrict__ a, long long a_se, int M, int K,
                                         int N, const T* __restrict__ b0,
                                         const T* __restrict__ b1, T* __restrict__ out) {
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

template <typename T, class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads)
    moe_gmm_gate_up_kernel(const T* __restrict__ a, long long a_se, int M, int K, int N,
                           const T* __restrict__ b0, const T* __restrict__ b1,
                           T* __restrict__ out) {
  gmm_tile<T, Cfg, 2>(a, a_se, M, K, N, b0, b1, out);
}

template <typename T, class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads)
    moe_gmm_down_kernel(const T* __restrict__ a, long long a_se, int M, int K, int N,
                        const T* __restrict__ b0, T* __restrict__ out) {
  gmm_tile<T, Cfg, 1>(a, a_se, M, K, N, b0, nullptr, out);
}

using repro::current_device;
using repro::kMaxDevices;

template <typename T, class Cfg, int NMAT>
cudaError_t launch(const T* a, long long a_se, int E, int M, int K, int N, const T* b0,
                   const T* b1, T* out, cudaStream_t stream) {
  constexpr size_t smem = Ring<T, Cfg, NMAT>::kBytes;
  const auto kernel = [] {
    if constexpr (NMAT == 2) return moe_gmm_gate_up_kernel<T, Cfg>;
    else return moe_gmm_down_kernel<T, Cfg>;
  }();
  static bool smem_set[kMaxDevices] = {};
  const cudaError_t err = repro::allow_smem(smem_set, (const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + Cfg::BM - 1) / Cfg::BM, N / kBN, E);
  if constexpr (NMAT == 2)
    kernel<<<grid, Cfg::kThreads, smem, stream>>>(a, a_se, M, K, N, b0, b1, out);
  else
    kernel<<<grid, Cfg::kThreads, smem, stream>>>(a, a_se, M, K, N, b0, out);
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

// SMs of the current device, asked once per device (0 on failure).
int sm_count() {
  static int counts[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return 0;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    counts[dev] = 0;
  return counts[dev];
}

// --- bf16 prefill (C > 32): wgmma fed by TMA ------------------------------ //

namespace tc {

using namespace repro::hopper;
using repro::smem_addr;

constexpr int kWgRows = 64;               // token rows of a consumer warpgroup (wgmma M)
constexpr int kBK = 64;                   // K of a stage: one 128-byte swizzle row of bf16
constexpr int kWN = 128;                  // columns of a weight tile, of an epilogue round
constexpr int kBox = 64 * 64 * 2;         // bytes of one 64 x 64 TMA box
constexpr int kSmemMax = 232448;          // dynamic shared memory a block may use
constexpr int kProducerRegs = 40;

// Output columns of a pair tile: 128 of F (gate/up), 256 of D (down).
template <int NMAT>
constexpr int kCols = NMAT == 2 ? kWN : 2 * kWN;

// The blocks of a pass run in clusters of two, in one of two shapes.  The
// two blocks of a cluster compute one pair tile in lockstep, sharing each
// stage through a TMA multicast, and a stage is refilled only when the
// consumers of both blocks have released it.
// * Token pairs (C > 192): each block owns 128 token rows (two consumer
//   warpgroups), block `rank` token tile 2 mp + rank of one weight tile;
//   each loads its own rows and half of the stage's weight boxes, multicast
//   to both.  So a stage's weights cross from L2 once per pair.
// * Column pairs (C <= 192): each block owns all the token rows (three
//   consumer warpgroups of 64, the ones wholly past C idle) and half of the
//   tile's columns; each loads its own weight columns and half of the token
//   rows, multicast to both.  Token pairs would leave a block idle, or half
//   idle, at these C (C 160: 128 + 32 rows).
// Shared memory, from a 1024-byte aligned base: kStages stages of [A: kWG
// boxes of 64 rows x 64 of K][B: kBBoxes boxes of 64 of K x 64 columns],
// then the output staging (64 rows x 128 columns per consumer warpgroup),
// then the full and empty barriers.  Every box is 1024-byte aligned, as the
// 128-byte swizzle's 8-row atoms need.  kernels/moe_gmm/plan.py mirrors it.
template <bool COLUMNS>
struct Shape {
  static constexpr bool kColumns = COLUMNS;
  static constexpr int kWG = COLUMNS ? 3 : 2;          // consumer warpgroups
  static constexpr int kBM = kWgRows * kWG;            // token rows staged per block
  static constexpr int kBBoxes = COLUMNS ? 2 : 4;      // weight boxes of a stage
  static constexpr int kN = 64 * kBBoxes;              // wgmma N
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kConsumerRegs = COLUMNS ? 152 : 232;
  static constexpr int kA = kWG * kBox;
  static constexpr int kB = kBBoxes * kBox;
  static constexpr int kStage = kA + kB;
  static constexpr int kEpi = kWgRows * kWN * 2;       // per consumer warpgroup
  static constexpr int kBar = 256;
  static constexpr int kStages = (kSmemMax - 1024 - kBar - kWG * kEpi) / kStage;
  static constexpr int kSmem = 1024 + kStages * kStage + kWG * kEpi + kBar;
  static_assert(kStages >= 3 && kSmem <= kSmemMax && 16 * kStages <= kBar, "ring");
  static_assert(128 * kWG * kConsumerRegs + 128 * kProducerRegs <= 65536, "registers");
};
using TokenPairs = Shape<false>;
using ColumnPairs = Shape<true>;
constexpr int kCluster = 2;

// The cluster shape by C, the one rule (kernels/moe_gmm/plan.py mirrors it).
__host__ __device__ constexpr bool splits_columns(int C) { return C <= 192; }

// Consumer warpgroups (of WG) that compute a block's tile with rows_left
// token rows from its first to C: a 64-row part that lies wholly past C is
// idle (no load, no product, no store), so no tile computes more than 63
// rows past C.
template <int WG>
__host__ __device__ constexpr int live_warpgroups(int rows_left) {
  return rows_left <= 0 ? 0 : rows_left >= kWgRows * WG ? WG : (rows_left + kWgRows - 1) / kWgRows;
}

// Pair tile p of a pass: pair mp of the token tiles (column pairs: the only
// one) of column tile n of expert e, numbered so that the MP pairs of one
// (e, n) are consecutive.
__host__ __device__ __forceinline__ void pair_of(int p, int MP, int NT, int& e, int& n,
                                                 int& mp) {
  mp = p % MP;
  n = (p / MP) % NT;
  e = p / (MP * NT);
}

// The pair tile that cluster c of G computes in its round r: rounds run
// forward and backward in turn (c, then G - 1 - c), so pair tiles of
// unequal size (one with idle warpgroups) are shared out evenly.  Pair
// tiles of one round run together, so the pairs of one weight tile,
// neighbours in the order, read it from L2 at about the same time.
__host__ __device__ __forceinline__ int tile_at(int r, int c, int G) {
  return r * G + (r % 2 ? G - 1 - c : c);
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b,
                                           int accumulate) {
  if constexpr (N == 256)
    wgmma_m64n256k16_bf16(d, a, b, accumulate);
  else
    wgmma_m64n128k16_bf16(d, a, b, accumulate);
}

// out[e, m, n] = epilogue(A[e, m, :] . B_j[e, :, n]) for every tile of a
// pass.  A is (E or 1, M, K), the weights (E, K, N), out (E, M, N), all
// through their tensor maps.  NMAT = 2: gate/up (b0 = Wg, b1 = Wu,
// epilogue silu(g) * u); NMAT = 1: down (b0 = Wd).  Warpgroup 0 is the
// producer, 1..kWG the consumers; an idle consumer still walks the ring
// (waits each full stage, releases it), so both blocks of the cluster
// release every stage they share.
template <class S, int NMAT>
__device__ __forceinline__ void wgmma_pass(const CUtensorMap& tm_a, const CUtensorMap& tm_b0,
                                           const CUtensorMap& tm_b1, const CUtensorMap& tm_out,
                                           int a_shared, int E, int M, int K, int N) {
  // output columns of a block's tile; the accumulator holds x Wg | x Wu
  // (gate/up) or the columns of y (down) side by side
  constexpr int kOut = S::kColumns ? kCols<NMAT> / 2 : kCols<NMAT>;
  static_assert(S::kN == (NMAT == 2 ? 2 * kOut : kOut), "accumulator width");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* base = tc_smem + ((1024 - (smem_addr(tc_smem) & 1023)) & 1023);
  unsigned char* epi = base + S::kStages * S::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + S::kWG * S::kEpi);
  uint64_t* empty = full + S::kStages;
  const int tid = threadIdx.x, wg = tid / 128;
  const uint32_t rank = cluster_rank();
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  const int MT = S::kColumns ? 1 : (M + S::kBM - 1) / S::kBM;
  const int MP = (MT + kCluster - 1) / kCluster;
  const int NT = (N + kCols<NMAT> - 1) / kCols<NMAT>, KT = K / kBK;
  const int total = E * NT * MP;
  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kCluster * 4 * S::kWG);   // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  cluster_sync();

  if (wg == 0) {
    // --- producer: one thread keeps the ring full --------------------------
    reg_dealloc<kProducerRegs>();
    if (tid != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int r = 0, p; (p = tile_at(r, cluster, clusters)) < total; ++r) {
      int e, n, mp;
      pair_of(p, MP, NT, e, n, mp);
      const int m = S::kColumns ? 0 : kCluster * mp + rank;
      const int col0 = n * kCols<NMAT> + (S::kColumns ? rank * kOut : 0);
      const int ea = a_shared ? 0 : e;
      const int live = live_warpgroups<S::kWG>(M - m * S::kBM);
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(empty + stage, phase ^ 1);      // released in both blocks
        unsigned char* st = base + stage * S::kStage;
        mbar_expect_tx(full + stage, live * kBox + S::kB);
        if constexpr (S::kColumns) {
          // token boxes h = rank, rank + 2 to both; own weight columns
          for (int h = rank; h < live; h += kCluster)
            tma_load_3d_multicast(st + h * kBox, &tm_a, full + stage, (1 << kCluster) - 1,
                                  kt * kBK, h * kWgRows, ea);
#pragma unroll
          for (int q = 0; q < S::kBBoxes; ++q)
            tma_load_3d(st + S::kA + q * kBox, NMAT == 2 && q == 1 ? &tm_b1 : &tm_b0,
                        full + stage, col0 + (NMAT == 2 ? 0 : q * 64), kt * kBK, e);
        } else {
          // own token rows; weight boxes q = rank, rank + 2 of [Wg 0:64,
          // 64:128 | Wu 0:64, 64:128] (gate/up) or of Wd's 256 columns
          for (int h = 0; h < live; ++h)
            tma_load_3d(st + h * kBox, &tm_a, full + stage, kt * kBK,
                        m * S::kBM + h * kWgRows, ea);
          for (int q = rank; q < S::kBBoxes; q += kCluster)
            tma_load_3d_multicast(st + S::kA + q * kBox, NMAT == 2 && q >= 2 ? &tm_b1 : &tm_b0,
                                  full + stage, (1 << kCluster) - 1,
                                  col0 + (NMAT == 2 ? q % 2 : q) * 64, kt * kBK, e);
        }
        if (++stage == S::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    // Stay until both blocks' consumers have released every stage: the
    // other block still multicasts into this one and arrives on its barriers.
    for (int s = 0; s < S::kStages; ++s) {
      mbar_wait(empty + stage, phase ^ 1);
      if (++stage == S::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // --- consumers: 64 token rows each -------------------------------------
    reg_alloc<S::kConsumerRegs>();
    const int cw = wg - 1, wtid = tid % 128, warp = wtid / 32, lane = tid % 32;
    unsigned char* stage_out = epi + cw * S::kEpi;
    float acc[S::kN / 2];
    int stage = 0;
    uint32_t phase = 0;
    auto release = [&](int s) {       // lane b arrives in block b of the cluster
      if (lane < kCluster) mbar_arrive_cluster(empty + s, lane);
    };
    for (int r = 0, p; (p = tile_at(r, cluster, clusters)) < total; ++r) {
      int e, n, mp;
      pair_of(p, MP, NT, e, n, mp);
      const int m = S::kColumns ? 0 : kCluster * mp + rank;
      const int col0 = n * kCols<NMAT> + (S::kColumns ? rank * kOut : 0);
      if (cw >= live_warpgroups<S::kWG>(M - m * S::kBM)) {   // idle: release each stage
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(full + stage, phase);
          release(stage);
          if (++stage == S::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        continue;
      }
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(full + stage, phase);
        const unsigned char* st = base + stage * S::kStage;
        const uint64_t da = sw128_desc(st + cw * kBox, 16, 1024);
        const uint64_t db = sw128_desc(st + S::kA, kBox, 1024);   // the weight boxes
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_bf16<S::kN>(acc, da + 2 * kk, db + 128 * kk, (kt | kk) != 0);
        wgmma_commit();
        if (kt > 0) {                 // the previous stage's products are done
          wgmma_wait<1>();
          release(prev);
        }
        prev = stage;
        if (++stage == S::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      release(prev);
      fence_regs(acc);

      // Epilogue: up to 128 columns per round into the staging buffer in
      // the 128-byte swizzle, then one 64 x 64 TMA store per 64 columns.
      constexpr int kRoundCols = kOut < kWN ? kOut : kWN;
#pragma unroll
      for (int q = 0; q < kOut / kRoundCols; ++q) {
        if (wtid == 0) bulk_wait_read<0>();   // the last stores have read it
        named_sync(1 + cw, 128);
#pragma unroll
        for (int j = 0; j < kRoundCols / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h;
            float o0, o1;
            if constexpr (NMAT == 2) {       // g in the first half, u in the second
              o0 = silu(acc[i]) * acc[S::kN / 4 + i];
              o1 = silu(acc[i + 1]) * acc[S::kN / 4 + i + 1];
            } else {
              o0 = acc[64 * q + i];
              o1 = acc[64 * q + i + 1];
            }
            const int row = warp * 16 + lane / 4 + 8 * h;
            const int off = (j / 8) * kBox + row * 128 + (((j % 8) ^ (row % 8)) << 4) + (lane % 4) * 4;
            *reinterpret_cast<__nv_bfloat162*>(stage_out + off) = __floats2bfloat162_rn(o0, o1);
          }
        fence_proxy_async();
        named_sync(1 + cw, 128);
        if (wtid == 0) {
          const int col = col0 + q * kRoundCols;
#pragma unroll
          for (int c = 0; c < kRoundCols / 64; ++c)
            if (col + c * 64 < N)
              tma_store_3d(&tm_out, stage_out + c * kBox, col + c * 64,
                           m * S::kBM + cw * kWgRows, e);
          bulk_commit();
        }
      }
    }
    if (wtid == 0) bulk_wait<0>();
  }
}

template <class S>
__global__ void __launch_bounds__(S::kThreads, 1)
    moe_gmm_gate_up_wgmma_kernel(const __grid_constant__ CUtensorMap x,
                                 const __grid_constant__ CUtensorMap wg,
                                 const __grid_constant__ CUtensorMap wu,
                                 const __grid_constant__ CUtensorMap h, int x_shared, int E,
                                 int C, int D, int F) {
  wgmma_pass<S, 2>(x, wg, wu, h, x_shared, E, C, D, F);
}

template <class S>
__global__ void __launch_bounds__(S::kThreads, 1)
    moe_gmm_down_wgmma_kernel(const __grid_constant__ CUtensorMap h,
                              const __grid_constant__ CUtensorMap wd,
                              const __grid_constant__ CUtensorMap y, int E, int C, int D,
                              int F) {
  wgmma_pass<S, 1>(h, wd, wd, y, 0, E, C, F, D);
}

// Clusters of shape S of pass NMAT that fit on device `dev` at once, found
// at the pass's first launch there (0 before): an SM that cannot pair within
// its GPC holds none, so this is not simply SMs / 2.
template <class S, int NMAT>
int& resident(int dev) {
  static int n[kMaxDevices] = {};
  return n[dev];
}

// Launch pass NMAT in clusters of shape S, as many clusters as pair tiles
// and no more than fit at once.
template <class S, int NMAT, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Args...), int pairs, cudaStream_t stream,
                            Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  int& fit = resident<S, NMAT>(dev);
  if (fit == 0) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           S::kSmem);
    if (err != cudaSuccess) return err;
    const int sms = sm_count();
    if (sms < kCluster) return cudaErrorInvalidDevice;
    cfg.gridDim = dim3(sms / kCluster * kCluster);
    err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
  }
  cfg.gridDim = dim3(kCluster * std::min(pairs, fit));
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <class S>
cudaError_t run(const void* x, long long x_se, const void* wg, const void* wu, const void* wd,
                void* h, void* y, int E, int C, int D, int F, cudaStream_t stream) {
  // x has one expert when it is shared (expert coordinate 0), never a zero
  // stride.
  CUtensorMap mx, mg, mu, mh, md, my;
  const uint64_t CD = (uint64_t)C * D, CF = (uint64_t)C * F, DF = (uint64_t)D * F;
  int err = encode_bf16_3d(&mx, x, D, C, x_se ? E : 1, D, CD);
  if (!err) err = encode_bf16_3d(&mg, wg, F, D, E, F, DF);
  if (!err) err = encode_bf16_3d(&mu, wu, F, D, E, F, DF);
  if (!err) err = encode_bf16_3d(&mh, h, F, C, E, F, CF);
  if (!err) err = encode_bf16_3d(&md, wd, D, F, E, D, DF);
  if (!err) err = encode_bf16_3d(&my, y, D, C, E, D, CD);
  if (err) return static_cast<cudaError_t>(err);
  const int MP = S::kColumns ? 1 : ((C + S::kBM - 1) / S::kBM + kCluster - 1) / kCluster;
  const int up_pairs = E * MP * ((F + kCols<2> - 1) / kCols<2>);
  const int down_pairs = E * MP * ((D + kCols<1> - 1) / kCols<1>);
  cudaError_t e = launch_clusters<S, 2>(moe_gmm_gate_up_wgmma_kernel<S>, up_pairs, stream, mx,
                                        mg, mu, mh, (int)(x_se == 0), E, C, D, F);
  if (e != cudaSuccess) return e;
  return launch_clusters<S, 1>(moe_gmm_down_wgmma_kernel<S>, down_pairs, stream, mh, md, my, E,
                               C, D, F);
}

}  // namespace tc

// --- bf16 decode (C <= 32): the swapped product on wgmma, fed by TMA ------- //
//
// Decode reads every weight once per call and is bound by the bytes.  The
// product runs transposed, out^T = W^T x^T: the weights are wgmma's 64-row
// A operand (read N-major through the transpose bit) and the tokens, padded
// to 32 by TMA's zero fill, its N.  A persistent grid, one block per SM,
// walks (expert, 128-column tile) in order; one producer thread streams the
// tile's weights in 64-deep stages through a ring as deep as shared memory
// allows, and one consumer warpgroup multiplies and stores the C live
// tokens straight from its accumulators.

namespace dec {

using namespace repro::hopper;
using repro::smem_addr;
using tc::kBK;
using tc::kBox;
using tc::kSmemMax;

constexpr int kTok = 32;                  // token columns of the product (wgmma N)
constexpr int kTileCols = 128;            // output columns of a tile: two 64-row blocks
constexpr int kTokBox = kTok * 64 * 2;    // the stage's 32 token rows
constexpr int kThreads = 256;             // the producer warpgroup and one consumer

// Shared memory, from a 1024-byte aligned base: kStages stages of [tokens
// 32 x 64][NMAT weight tiles, each two 64 x 64 boxes], then the barriers.
template <int NMAT>
struct Ring {
  static constexpr int kStage = kTokBox + NMAT * 2 * kBox;
  static constexpr int kBar = 256;
  static constexpr int kStages = (kSmemMax - 1024 - kBar) / kStage;
  static constexpr int kBytes = 1024 + kStages * kStage + kBar;
  static_assert(kStages >= 4 && 16 * kStages <= kBar, "ring");
};

// out[e, c, n] = epilogue(sum_k A[e, c, k] W_j[e, k, n]) for c < M, every
// 128-column tile of every expert; block b takes tiles b, b + grid, ...
// A (E or 1, M, K) and the weights (E, K, N) through their tensor maps, out
// (E, M, N) contiguous.  NMAT = 2: gate/up (silu(x Wg) * (x Wu)); NMAT = 1:
// down.
template <int NMAT>
__device__ __forceinline__ void swap_pass(const CUtensorMap& tm_a, const CUtensorMap& tm_w0,
                                          const CUtensorMap& tm_w1, bf16* __restrict__ out,
                                          int a_shared, int E, int M, int K, int N) {
  using R = Ring<NMAT>;
  extern __shared__ __align__(16) unsigned char dec_smem[];
  unsigned char* base = dec_smem + ((1024 - (smem_addr(dec_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + R::kStages * R::kStage);
  uint64_t* empty = full + R::kStages;
  const int tid = threadIdx.x, wg = tid / 128;
  const int NT = (N + kTileCols - 1) / kTileCols, KT = K / kBK, total = E * NT;
  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);                // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // --- producer ----------------------------------------------------------
    if (tid != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const int e = t / NT, n = t % NT;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(empty + stage, phase ^ 1);
        unsigned char* st = base + stage * R::kStage;
        mbar_expect_tx(full + stage, R::kStage);
        tma_load_3d(st, &tm_a, full + stage, kt * kBK, 0, a_shared ? 0 : e);
#pragma unroll
        for (int q = 0; q < 2 * NMAT; ++q)
          tma_load_3d(st + kTokBox + q * kBox, q >= 2 ? &tm_w1 : &tm_w0, full + stage,
                      n * kTileCols + (q % 2) * 64, kt * kBK, e);
        if (++stage == R::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // --- consumer: acc[2 mat + i] is 64-column block i of weight mat -------
    const int warp = (tid % 128) / 32, lane = tid % 32;
    float acc[2 * NMAT][16];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const int e = t / NT, n = t % NT;
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(full + stage, phase);
        const unsigned char* st = base + stage * R::kStage;
        const uint64_t db = sw128_desc(st, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int q = 0; q < 2 * NMAT; ++q)
            wgmma_m64n32k16_bf16_ta(acc[q], sw128_desc(st + kTokBox + q * kBox, kBox, 1024) + 128 * kk,
                                    db + 2 * kk, (kt | kk) != 0);
        wgmma_commit();
        if (kt > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty + prev);
        }
        prev = stage;
        if (++stage == R::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + prev);
#pragma unroll
      for (int q = 0; q < 2 * NMAT; ++q) fence_regs(acc[q]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n * kTileCols + i * 64 + warp * 16 + lane / 4 + 8 * h;
          if (col >= N) continue;
#pragma unroll
          for (int j = 0; j < kTok / 8; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int tok = 8 * j + 2 * (lane % 4) + c, r = 4 * j + 2 * h + c;
              if (tok >= M) continue;
              const float v = NMAT == 2 ? silu(acc[i][r]) * acc[2 + i][r] : acc[i][r];
              out[((size_t)e * M + tok) * N + col] = __float2bfloat16(v);
            }
        }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    moe_gmm_gate_up_swap_kernel(const __grid_constant__ CUtensorMap x,
                                const __grid_constant__ CUtensorMap wg,
                                const __grid_constant__ CUtensorMap wu, bf16* h, int x_shared,
                                int E, int C, int D, int F) {
  swap_pass<2>(x, wg, wu, h, x_shared, E, C, D, F);
}

__global__ void __launch_bounds__(kThreads, 1)
    moe_gmm_down_swap_kernel(const __grid_constant__ CUtensorMap h,
                             const __grid_constant__ CUtensorMap wd, bf16* y, int E, int C,
                             int D, int F) {
  swap_pass<1>(h, wd, wd, y, 0, E, C, F, D);
}

cudaError_t run(const void* x, long long x_se, const void* wg, const void* wu, const void* wd,
                void* h, void* y, int E, int C, int D, int F, cudaStream_t stream) {
  static bool up_set[kMaxDevices] = {}, down_set[kMaxDevices] = {};
  cudaError_t set =
      repro::allow_smem(up_set, (const void*)moe_gmm_gate_up_swap_kernel, Ring<2>::kBytes);
  if (set == cudaSuccess)
    set = repro::allow_smem(down_set, (const void*)moe_gmm_down_swap_kernel, Ring<1>::kBytes);
  if (set != cudaSuccess) return set;
  CUtensorMap mx, mg, mu, mh, md;
  const uint64_t CD = (uint64_t)C * D, CF = (uint64_t)C * F, DF = (uint64_t)D * F;
  int err = encode_bf16_3d(&mx, x, D, C, x_se ? E : 1, D, CD, kTok);
  if (!err) err = encode_bf16_3d(&mg, wg, F, D, E, F, DF);
  if (!err) err = encode_bf16_3d(&mu, wu, F, D, E, F, DF);
  if (!err) err = encode_bf16_3d(&mh, h, F, C, E, F, CF, kTok);
  if (!err) err = encode_bf16_3d(&md, wd, D, F, E, D, DF);
  if (err) return static_cast<cudaError_t>(err);
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int up_grid = std::min(E * ((F + kTileCols - 1) / kTileCols), sms);
  const int down_grid = std::min(E * ((D + kTileCols - 1) / kTileCols), sms);
  moe_gmm_gate_up_swap_kernel<<<up_grid, kThreads, Ring<2>::kBytes, stream>>>(
      mx, mg, mu, static_cast<bf16*>(h), x_se == 0, E, C, D, F);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  moe_gmm_down_swap_kernel<<<down_grid, kThreads, Ring<1>::kBytes, stream>>>(
      mh, md, static_cast<bf16*>(y), E, C, D, F);
  return cudaGetLastError();
}

}  // namespace dec

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor).  x (E, C, D) with rows
// contiguous and expert stride x_se elements (0: one copy for all experts);
// wg, wu (E, D, F), wd (E, F, D), h (E, C, F) scratch and y (E, C, D)
// contiguous, all 16-byte aligned; D and F multiples of 64; C >= 1.
// Returns the first nonzero of: a tensor map's encoding (bf16, C > 32), and
// cudaGetLastError() after each of the two launches.
extern "C" int moe_gmm(int dtype, const void* x, long long x_se, const void* wg,
                       const void* wu, const void* wd, void* h, void* y, int E, int C,
                       int D, int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || C < 1 || D % kBN || F % kBN) return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (C <= 32) return run<float, Small>(x, x_se, wg, wu, wd, h, y, E, C, D, F, st);
    return run<float, Large>(x, x_se, wg, wu, wd, h, y, E, C, D, F, st);
  }
  if (dtype == 1) {
    if (C <= 32) return dec::run(x, x_se, wg, wu, wd, h, y, E, C, D, F, st);
    if (tc::splits_columns(C))
      return tc::run<tc::ColumnPairs>(x, x_se, wg, wu, wd, h, y, E, C, D, F, st);
    return tc::run<tc::TokenPairs>(x, x_se, wg, wu, wd, h, y, E, C, D, F, st);
  }
  return cudaErrorInvalidValue;
}

// Clusters that the prefill body runs at most for pass `which` (0 gate/up,
// 1 down) in the shape of `columns` (0: token pairs, 1: column pairs):
// found at that pass's first launch in that shape on the current device, 0
// before.
extern "C" int moe_gmm_resident_clusters(int which, int columns) {
  const int dev = current_device();
  if (dev < 0) return 0;
  if (columns)
    return which == 0 ? tc::resident<tc::ColumnPairs, 2>(dev)
                      : tc::resident<tc::ColumnPairs, 1>(dev);
  return which == 0 ? tc::resident<tc::TokenPairs, 2>(dev) : tc::resident<tc::TokenPairs, 1>(dev);
}
