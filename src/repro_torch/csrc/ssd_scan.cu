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
// no order, so the chunk loop lives inside the block and the state in its
// registers.  Bound: bytes at the serving shapes (the state, P x N per
// head, is read and written once; x once; B and C once per lane), and
// short of either bound the time is latency: one 64-token chunk of one
// lane is a few dependent products per block.
//
// bf16 (tensor cores).  y's columns and the state's rows depend only on
// their own p, so a block owns kPb of them: grid (H, P / kPb, batch), 128
// blocks for one lane of mamba2 (H 64, P 64) on 132 SMs (kPb = 16, 256
// blocks at two a SM, was slower: every block recomputes C.B^T).  Four
// warps; per chunk of kChunk = 64 positions:
//   * cp.async brings dt, B and C, x and the state slice in separate
//     groups, and the block waits on each just before the step that needs
//     it (dt for the scan, B and C for C.B^T, x for M.x, the state for
//     C.state^T); for S > 64 the next chunk's dt, B, C and x land in a
//     second stage behind this chunk's products.  Rows past S are zeros.
//   * warp 0 scans dt*A over the 64 positions (two a lane, shuffles) while
//     B and C land.
//   * four products on mma.sync.m16n8k16 (bf16 in, f32 accumulate), each
//     warp 16 rows of the chunk: G = C.B^T (C's fragments stay in
//     registers), M = G o exp(cum_i - cum_j) dt_j masked to j <= i,
//     y = M.x + exp(cum_i) C.state^T; and each warp a quarter of the
//     state's columns, state = state exp(cum_end) + (w x)^T.B with
//     w_j = dt_j exp(cum_end - cum_j).  x, B and C enter as they are; the
//     f32 factors M, w x and the state enter as bf16 hi + lo halves (two
//     products each), so they keep ~16 bits, near the f32 path's accuracy.
//   * the state is the f32 accumulator of the update product, in
//     registers across chunks; its hi + lo halves go to shared memory for
//     the next chunk's C.state^T, and it is written once, at the end, in
//     x's dtype.
// The time of one chunk is the chain of these steps in one warp, so the
// loops have no branch inside (a branch per tile cut them into blocks the
// compiler could not schedule across: 1.5x slower) and every warp computes
// all 64 keys, the last warp's share.
// f32 (CUDA cores, held to 2e-5, which bf16 halves would not meet): grid
// (H, batch), one block per (lane, head) keeps the whole (P, N) state in
// registers with a copy in shared memory; per chunk of 32 positions it
// stages B, C, dt*x and dt as f32, scans dt*A with warp shuffles and runs
// the products as FMAs from shared memory.

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

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

// --------------------------------------------------------------------------
// f32: CUDA cores
// --------------------------------------------------------------------------
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


// --------------------------------------------------------------------------
// bf16: tensor cores
// --------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::split_bf16;

constexpr int kThreads = 128;   // four warps
constexpr int kChunk = 64;      // positions per chunk
constexpr int kPb = 32;         // state rows (y columns) per block
constexpr int kPad = 8;         // bf16 padding of a shared row: 16 bytes, so
                                // ldmatrix's eight rows hit distinct banks

// Shared memory, in bytes: two stages of {dt (f32), B, C, x}, then the
// state's bf16 hi and lo halves and the chunk's cum and w (f32).
template <int N>
struct Layout {
  static constexpr int kLdN = N + kPad;       // B, C and state rows
  static constexpr int kLdP = kPb + kPad;     // x rows
  static constexpr int kDt = 0;
  static constexpr int kB = kDt + 4 * kChunk;
  static constexpr int kC = kB + 2 * kChunk * kLdN;
  static constexpr int kX = kC + 2 * kChunk * kLdN;
  static constexpr int kStage = kX + 2 * kChunk * kLdP;
  static constexpr int kStHi = 2 * kStage;
  static constexpr int kStLo = kStHi + 2 * kPb * kLdN;
  static constexpr int kCum = kStLo + 2 * kPb * kLdN;
  static constexpr int kW = kCum + 4 * kChunk;
  static constexpr int kBytes = kW + 4 * kChunk;
  static_assert(kB % 16 == 0 && kC % 16 == 0 && kX % 16 == 0 && kStage % 16 == 0 &&
                    kStLo % 16 == 0 && kCum % 16 == 0,
                "cp.async and ldmatrix need 16-byte rows");
};

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Warp w owns chunk rows [16 w, 16 w + 16) of G, M and y (all kPb y
// columns), and state columns [w N / 4, (w + 1) N / 4) (all kPb state
// rows).  The products' loops are unrolled with no branch inside: a warp
// computes all 64 keys of G and M.x (M is zero past the diagonal), since
// a branch per tile cuts the code into blocks that the compiler cannot
// schedule across, and the last warp needs every tile anyway.
template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_scan_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, const bf16* __restrict__ init,
    bf16* __restrict__ y, bf16* __restrict__ fin, int S, int H) {
  using L = Layout<N>;
  constexpr int KN = N / 16;       // k-steps over the state width
  constexpr int KC = kChunk / 16;  // k-steps over the chunk
  constexpr int PT = kPb / 8;      // y column tiles of a warp
  constexpr int MT = kPb / 16;     // state row tiles of a warp
  constexpr int NW = N / 4;        // state columns of a warp
  constexpr int NT = NW / 8;       // state column tiles of a warp
  constexpr int CT = kChunk / 8;   // key column tiles of G
  static_assert(P % kPb == 0 && PT % 2 == 0 && NT % 2 == 0, "tile maps");

  const int h = blockIdx.x, p0 = blockIdx.y * kPb, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * 16;        // the warp's chunk rows
  const int n0 = warp * NW;        // the warp's state columns
  const int nch = repro::cdiv(S, kChunk);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  bf16* st_hi = reinterpret_cast<bf16*>(smem + L::kStHi);
  bf16* st_lo = reinterpret_cast<bf16*>(smem + L::kStLo);
  float* cum = reinterpret_cast<float*>(smem + L::kCum);
  float* wj = reinterpret_cast<float*>(smem + L::kW);
  auto dts_of = [&](int st) { return reinterpret_cast<float*>(smem + st * L::kStage + L::kDt); };
  auto bs_of = [&](int st) { return reinterpret_cast<bf16*>(smem + st * L::kStage + L::kB); };
  auto cs_of = [&](int st) { return reinterpret_cast<bf16*>(smem + st * L::kStage + L::kC); };
  auto xs_of = [&](int st) { return reinterpret_cast<bf16*>(smem + st * L::kStage + L::kX); };

  // copies of chunk c into stage st; positions past S are zeros (the
  // source is then not read, but must be a valid address).  Warp 0 copies
  // dt itself, so it can scan as soon as its own copies land.
  auto load_dt = [&](int c, int st) {
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = 2 * lane + k, pos = c * kChunk + r;
        const bool ok = pos < S;
        cp_async4(dts_of(st) + r, dt + (ok ? ((size_t)b * S + pos) * H + h : 0), ok ? 4 : 0);
      }
    }
  };
  auto load_bc = [&](int c, int st) {
    constexpr int CPR = N / 8;                   // 16-byte pieces of a row
    bf16* bs = bs_of(st);
    bf16* cs = cs_of(st);
#pragma unroll 4
    for (int i = tid; i < kChunk * CPR; i += kThreads) {
      const int r = i / CPR, q = (i % CPR) * 8;
      const int pos = c * kChunk + r;
      const bool ok = pos < S;
      const size_t off = ok ? ((size_t)b * S + pos) * N + q : 0;
      cp_async16(bs + r * L::kLdN + q, Bm + off, ok ? 16 : 0);
      cp_async16(cs + r * L::kLdN + q, Cm + off, ok ? 16 : 0);
    }
  };
  auto load_x = [&](int c, int st) {
    constexpr int CPR = kPb / 8;
    bf16* xs = xs_of(st);
#pragma unroll
    for (int i = tid; i < kChunk * CPR; i += kThreads) {
      const int r = i / CPR, q = (i % CPR) * 8;
      const int pos = c * kChunk + r;
      const bool ok = pos < S;
      const size_t off = ok ? (((size_t)b * S + pos) * H + h) * P + p0 + q : 0;
      cp_async16(xs + r * L::kLdP + q, x + off, ok ? 16 : 0);
    }
  };

  // the first chunk in four groups, the second in a fifth (empty if none)
  load_dt(0, 0);
  cp_async_commit();
  load_bc(0, 0);
  cp_async_commit();
  load_x(0, 0);
  cp_async_commit();
  {
    constexpr int CPR = N / 8;
    const size_t base = (((size_t)b * H + h) * P + p0) * N;
#pragma unroll
    for (int i = tid; i < kPb * CPR; i += kThreads) {
      const int r = i / CPR, q = (i % CPR) * 8;
      const bool ok = init != nullptr;
      cp_async16(st_hi + r * L::kLdN + q, ok ? init + base + (size_t)r * N + q : Bm,
                 ok ? 16 : 0);
    }
  }
  cp_async_commit();
  if (nch > 1) {
    load_dt(1, 1);
    load_bc(1, 1);
    load_x(1, 1);
  }
  cp_async_commit();
  // the initial state is bf16 already: its lo half is zero
  for (int i = tid; i < kPb * L::kLdN / 8; i += kThreads)
    reinterpret_cast<uint4*>(st_lo)[i] = make_uint4(0u, 0u, 0u, 0u);

  const float a = __ldg(A + h);
  const int i0 = r0 + (lane >> 2);              // the thread's rows i0, i0 + 8
  const int jl = 2 * (lane & 3);                // and its columns jl, jl + 1 of a tile
  // the warp's state: rows 16 mt + lane / 4 (+ 8), columns n0 + 8 nt + jl
  // (+ 1) -- the accumulator fragments of the update product
  float sacc[MT][NT][4];

  for (int c = 0; c < nch; ++c) {
    const int st = c & 1;
    const int l = min(kChunk, S - c * kChunk);   // live rows of the chunk
    const float* dts = dts_of(st);
    const bf16* bs = bs_of(st);
    const bf16* cs = cs_of(st);
    const bf16* xs = xs_of(st);
    if (c == 0) {
      cp_async_wait<4>();                        // dt (warp 0's own copies)
    } else {
      if (c + 1 < nch) {                         // stage st ^ 1 is free
        load_dt(c + 1, st ^ 1);
        load_bc(c + 1, st ^ 1);
        load_x(c + 1, st ^ 1);
      }
      cp_async_commit();
      cp_async_wait<1>();                        // all of chunk c
    }

    // warp 0, while B and C land: cum = inclusive scan of dt*A (rows past
    // l add 0, so cum[63] is the chunk's end); w_j = dt_j exp(cum_end - cum_j)
    if (warp == 0) {
      __syncwarp();                              // the warp's dt copies are visible

      const float2 d = *reinterpret_cast<const float2*>(dts + 2 * lane);
      const float v0 = d.x * a, v1 = v0 + d.y * a;
      float incl = v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float end = __shfl_sync(0xffffffffu, incl, 31);
      const float c0 = excl + v0, c1 = excl + v1;
      *reinterpret_cast<float2*>(cum + 2 * lane) = make_float2(c0, c1);
      *reinterpret_cast<float2*>(wj + 2 * lane) =
          make_float2(d.x * __expf(end - c0), d.y * __expf(end - c1));
    }
    if (c == 0) cp_async_wait<3>();              // B, C
    __syncthreads();                             // B, C, cum and w are visible

    // G = C.B^T over the warp's 16 rows; C's fragments stay for C.state^T
    uint32_t cf[KN][4];
    float g[CT][4];
#pragma unroll
    for (int j = 0; j < CT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) g[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk)
      ldmatrix_x4(cf[kk], cs + (r0 + (lane & 15)) * L::kLdN + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      uint32_t bk[CT / 2][4];
#pragma unroll
      for (int jt = 0; jt < CT; jt += 2)
        ldmatrix_x4(bk[jt / 2], bs + (jt * 8 + (lane & 7) + ((lane >> 4) << 3)) * L::kLdN +
                                    kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int jt = 0; jt < CT; jt += 2) {
        mma_bf16(g[jt], cf[kk], bk[jt / 2][0], bk[jt / 2][1]);
        mma_bf16(g[jt + 1], cf[kk], bk[jt / 2][2], bk[jt / 2][3]);
      }
    }
    // M = G o exp(cum_i - cum_j) dt_j for j <= i, else 0 (the exponent is
    // at most 0 there: __expf's few ulps are far below the bf16 hi + lo
    // split's 16 bits)
    {
      const float ci[2] = {cum[i0], cum[i0 + 8]};
#pragma unroll
      for (int jt = 0; jt < CT; ++jt) {
        const float2 cj = *reinterpret_cast<const float2*>(cum + jt * 8 + jl);
        const float2 dj = *reinterpret_cast<const float2*>(dts + jt * 8 + jl);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + 8 * (e >> 1), j = jt * 8 + jl + (e & 1);
          const float m = g[jt][e] * __expf(ci[e >> 1] - ((e & 1) ? cj.y : cj.x)) *
                          ((e & 1) ? dj.y : dj.x);
          g[jt][e] = j <= i ? m : 0.f;
        }
      }
    }

    if (c == 0) {                                // x
      cp_async_wait<2>();
      __syncthreads();
    }
    // y_diag = M.x: the accumulators of keys 16 kc .. 16 kc + 15 are the A
    // fragment of k-step kc, as bf16 hi + lo halves.  (mma.sync is
    // volatile asm, issued in the order written: each k-step's hi products
    // go before its lo ones, so no product waits on the one just before it.)
    float yd[PT][4], yo[PT][4];
#pragma unroll
    for (int n = 0; n < PT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) yd[n][e] = yo[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t mh[4], ml[4];
      split_bf16(g[2 * kc][0], g[2 * kc][1], mh[0], ml[0]);
      split_bf16(g[2 * kc][2], g[2 * kc][3], mh[1], ml[1]);
      split_bf16(g[2 * kc + 1][0], g[2 * kc + 1][1], mh[2], ml[2]);
      split_bf16(g[2 * kc + 1][2], g[2 * kc + 1][3], mh[3], ml[3]);
      uint32_t bv[PT / 2][4];
#pragma unroll
      for (int n = 0; n < PT; n += 2)
        ldmatrix_x4_trans(bv[n / 2],
                          xs + (kc * 16 + (lane & 15)) * L::kLdP + n * 8 + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < PT; n += 2) {
        mma_bf16(yd[n], mh, bv[n / 2][0], bv[n / 2][1]);
        mma_bf16(yd[n + 1], mh, bv[n / 2][2], bv[n / 2][3]);
      }
#pragma unroll
      for (int n = 0; n < PT; n += 2) {
        mma_bf16(yd[n], ml, bv[n / 2][0], bv[n / 2][1]);
        mma_bf16(yd[n + 1], ml, bv[n / 2][2], bv[n / 2][3]);
      }
    }

    if (c == 0) {                                // the state
      cp_async_wait<1>();
      __syncthreads();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int pr = 16 * mt + (lane >> 2) + 8 * hh;
            const float2 v = unpack_bf16(
                *reinterpret_cast<const uint32_t*>(st_hi + pr * L::kLdN + n0 + 8 * nt + jl));
            sacc[mt][nt][2 * hh] = v.x;
            sacc[mt][nt][2 * hh + 1] = v.y;
          }
    }
    // y_off = C.state^T, the state as bf16 hi + lo halves (B operands)
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      uint32_t sh[PT / 2][4], sl[PT / 2][4];
#pragma unroll
      for (int n = 0; n < PT; n += 2) {
        const int off = (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * L::kLdN + kk * 16 +
                        ((lane >> 3) & 1) * 8;
        ldmatrix_x4(sh[n / 2], st_hi + off);
        ldmatrix_x4(sl[n / 2], st_lo + off);
      }
#pragma unroll
      for (int n = 0; n < PT; n += 2) {
        mma_bf16(yo[n], cf[kk], sh[n / 2][0], sh[n / 2][1]);
        mma_bf16(yo[n + 1], cf[kk], sh[n / 2][2], sh[n / 2][3]);
      }
#pragma unroll
      for (int n = 0; n < PT; n += 2) {
        mma_bf16(yo[n], cf[kk], sl[n / 2][0], sl[n / 2][1]);
        mma_bf16(yo[n + 1], cf[kk], sl[n / 2][2], sl[n / 2][3]);
      }
    }
    // y = y_diag + exp(cum_i) y_off, live rows only
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = i0 + 8 * hh;
      const float e = __expf(cum[i]);
      if (i < l) {
        bf16* yr = y + (((size_t)b * S + c * kChunk + i) * H + h) * P + p0 + jl;
#pragma unroll
        for (int n = 0; n < PT; ++n)
          *reinterpret_cast<__nv_bfloat162*>(yr + n * 8) = __floats2bfloat162_rn(
              fmaf(e, yo[n][2 * hh], yd[n][2 * hh]), fmaf(e, yo[n][2 * hh + 1], yd[n][2 * hh + 1]));
      }
    }

    // state = state exp(cum_end) + (w x)^T.B: x^T's fragments come from
    // ldmatrix.trans, are scaled by w_j in f32 and enter as bf16 hi + lo
    // halves; B enters as it is (rows past l have w = 0)
    const float dec = __expf(cum[kChunk - 1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[mt][nt][e] *= dec;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const float2 w0 = *reinterpret_cast<const float2*>(wj + kc * 16 + jl);
      const float2 w1 = *reinterpret_cast<const float2*>(wj + kc * 16 + 8 + jl);
      uint32_t bb[NT / 2][4], ah[MT][4], al[MT][4];
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2)
        ldmatrix_x4_trans(bb[nt / 2],
                          bs + (kc * 16 + (lane & 15)) * L::kLdN + n0 + nt * 8 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int q = lane >> 3;
        uint32_t xr[4];
        ldmatrix_x4_trans(xr, xs + (kc * 16 + (q >> 1) * 8 + (lane & 7)) * L::kLdP + 16 * mt +
                                  (q & 1) * 8);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 f = unpack_bf16(xr[r]);
          const float2 w = r < 2 ? w0 : w1;
          split_bf16(f.x * w.x, f.y * w.y, ah[mt][r], al[mt][r]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          mma_bf16(sacc[mt][nt], ah[mt], bb[nt / 2][0], bb[nt / 2][1]);
          mma_bf16(sacc[mt][nt + 1], ah[mt], bb[nt / 2][2], bb[nt / 2][3]);
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          mma_bf16(sacc[mt][nt], al[mt], bb[nt / 2][0], bb[nt / 2][1]);
          mma_bf16(sacc[mt][nt + 1], al[mt], bb[nt / 2][2], bb[nt / 2][3]);
        }
    }
    __syncthreads();                             // every read of this stage and the state
    if (c + 1 < nch) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int off = (16 * mt + (lane >> 2) + 8 * hh) * L::kLdN + n0 + 8 * nt + jl;
            uint32_t hi, lo;
            split_bf16(sacc[mt][nt][2 * hh], sacc[mt][nt][2 * hh + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(st_hi + off) = hi;
            *reinterpret_cast<uint32_t*>(st_lo + off) = lo;
          }
    }
  }

  bf16* fr = fin + (((size_t)b * H + h) * P + p0) * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<__nv_bfloat162*>(fr + (16 * mt + (lane >> 2) + 8 * hh) * N + n0 +
                                           8 * nt + jl) =
            __floats2bfloat162_rn(sacc[mt][nt][2 * hh], sacc[mt][nt][2 * hh + 1]);
}

}  // namespace tc

template <typename T, int P, int N>
constexpr size_t smem_bytes() {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) return tc::Layout<N>::kBytes;
  else return sizeof(float) * Layout<P, N>::kFloats;
}

template <typename T, int P, int N>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, const void* init, void* y, void* fin,
                   int batch, int S, int H, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, P, N>();
  void (*kernel)(const T*, const float*, const float*, const T*, const T*, const T*, T*, T*,
                 int, int);
  dim3 grid, block;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    kernel = tc::ssd_scan_tc_kernel<P, N>;
    grid = dim3(H, P / tc::kPb, batch);
    block = dim3(tc::kThreads);
  } else {
    kernel = ssd_scan_kernel<T, P, N>;
    grid = dim3(H, batch);
    block = dim3(kThreads);
  }
  static bool smem_set[repro::kMaxDevices] = {};
  const cudaError_t set = repro::allow_smem(smem_set, (const void*)kernel, smem);
  if (set != cudaSuccess) return set;
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const T*>(init),
      static_cast<T*>(y), static_cast<T*>(fin), S, H);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t dispatch(int dtype, const void* x, const void* dt, const void* A, const void* B,
                     const void* C, const void* init, void* y, void* fin, int batch, int S,
                     int H, cudaStream_t st) {
  if (dtype == 0)
    return launch<float, P, N>(x, dt, A, B, C, init, y, fin, batch, S, H, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, P, N>(x, dt, A, B, C, init, y, fin, batch, S, H, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, init, y, fin); dt and A f32.
// (P, N) in {(64, 128), (64, 64)}.  init may be null (zero state).  x, B, C
// and init 16-byte aligned, everything contiguous.  Returns
// cudaGetLastError() after the launch.
extern "C" int ssd_scan(int dtype, const void* x, const void* dt, const void* A,
                        const void* B, const void* C, const void* init,
                        void* y, void* fin, int batch, int S, int H, int P,
                        int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 128)
    return dispatch<64, 128>(dtype, x, dt, A, B, C, init, y, fin, batch, S, H, st);
  if (P == 64 && N == 64)
    return dispatch<64, 64>(dtype, x, dt, A, B, C, init, y, fin, batch, S, H, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory per block (bytes), from the layouts above; 0 for an
// unsupported (dtype, P, N).
extern "C" int ssd_scan_smem_bytes(int dtype, int P, int N) {
  if (P == 64 && N == 128)
    return dtype == 0 ? (int)smem_bytes<float, 64, 128>()
                      : dtype == 1 ? (int)smem_bytes<__nv_bfloat16, 64, 128>() : 0;
  if (P == 64 && N == 64)
    return dtype == 0 ? (int)smem_bytes<float, 64, 64>()
                      : dtype == 1 ? (int)smem_bytes<__nv_bfloat16, 64, 64>() : 0;
  return 0;
}
