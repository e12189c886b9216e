// Flash attention (prefill) for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:83
// ::flash_attention_kernel (body _attn_kernel): blocked online-softmax
// attention with end-aligned causal masking, an optional sliding window and
// an optional tanh logit softcap; fully masked kv blocks are skipped.
// Beyond the TPU kernel: GQA happens inside the kernel (K/V arrive
// un-repeated), an optional per-row kv_len bounds the keys (query i of row b
// sits at position kv_len[b] - Sq + i, keys >= kv_len[b] are masked; a row
// that sees no key writes 0), and K/V are addressed in one of two modes:
//   contiguous  k, v (B, Sk, Hkv, D): key j of row b is row b*Sk + j;
//   paged       k, v (P, page, Hkv, D) page pools and ptab (B, n_ptab):
//               key j of row b is row j % page of page ptab[b][j / page],
//               read inside the kernel, so no gathered copy is made.
//
// Bound: bytes at the serving contexts (each live K/V element is read once
// from device memory for the G = H/Hkv query heads of its group, ~4 G Sq'
// flops per element for Sq' queries that see it), operations only at long
// contexts with long chunks.  At the paths' shapes (a 64-token chunk
// against <= 2048 keys) neither is close: the kernel's time is latency, the
// length of the longest chain of dependent tile steps in one block, and the
// number of blocks that have work at all.  The design answers both:
//
// * Tensor cores (bf16).  A block owns 64 flattened (query, head-in-group)
//   rows of one KV head, so each K/V tile serves the whole GQA group; each
//   of its 4 warps owns 16 rows.  S = Q K^T and O += P V run as
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate): Q fragments are loaded
//   once into registers with ldmatrix, K/V tiles of 64 keys stay bf16 in a
//   2-stage cp.async ring in shared memory (rows padded by 16 bytes so
//   ldmatrix's eight rows hit distinct banks) and are read with ldmatrix
//   (.trans for V).  P goes from the score accumulators straight into the
//   A fragments of P V in registers, as a bf16 hi part and a bf16 lo part
//   (two products), so P keeps ~16 bits, near the f32 path's accuracy
//   (P rounded to bf16 once put a card-vs-CPU logit past the bf16
//   tolerance of the whole-model check).  The online softmax (in log2 units),
//   the masks and the softcap run in f32 registers; only tiles that touch a
//   boundary (kv_len, the diagonal, the window) are masked element-wise.
// * f32 keeps a CUDA-core path (FMAs from shared memory, 32-key sub-tiles),
//   since f32 is held to 2e-5, which TF32 would not meet.
// * A key split.  The grid alone, (row blocks x lanes x KV heads), leaves
//   most of the 132 SMs idle when one lane has work (a serving prefill
//   chunk: 12 blocks with work for qwen2) and makes the longest lane's
//   blocks walk all its tiles in series.  Every block reads kv_len and
//   computes the same plan: T_b live key tiles of lane b,
//   W = pairs * sum_b T_b tile visits (pairs = row blocks x KV heads),
//   per = max(1, ceil(W / target)) tiles per split (target: one wave of
//   2 blocks per SM, what the bf16 kernel's shared memory and registers
//   allow), and n_b = ceil(T_b / per) splits for every (row block, KV head) of
//   lane b, each dividing its own live tiles evenly over n_b.  Work items
//   are numbered lane by lane, so the grid is the host's bound
//   target + pairs * B and blocks past the last item exit at once.  A
//   split writes a partial (m, l, acc) in f32 to scratch and a combine pass
//   finishes the rows; with n_b <= 1 the block writes the output directly,
//   and when the host can tell that no lane will split (the grid already
//   fills the card, or Sk fits one tile) no combine is launched.  The plan
//   is computed on the card from kv_len, so no length crosses to the host;
//   its arithmetic lives in common.cuh, shared with the decode kernels
//   (n_cap never binds here: pairs * n_cap >= target).
// * Head dims 64, 112, 128 and 256.  D 112 (zamba2) is 14 16-byte chunks
//   and 7 k16 steps a row: every loop steps D by 16 (one ldmatrix_x4 per
//   k-step of S, and per 16 output columns of P V), and rows are padded, not
//   swizzled, so no step assumes a power of two.  At D 256 (gemma2) the
//   64 x 256 f32 O accumulator alone takes 128 registers a thread, so the
//   Q fragments are read from shared memory at each k-step instead of being
//   held (D <= 128 holds them); Q plus a 2-stage K/V ring is 165 KB, one
//   block per SM, and the host's plan target follows the shared memory
//   (kernels/split_plan.py::target).  The f32 body at
//   D 256 loads each sub-tile straight into shared memory instead of through
//   registers, which would not hold a sub-tile next to the accumulator.

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::cdiv;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::kNegInf;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::Pack8;
using repro::split_bf16;
using repro::tiles_of;

constexpr int kThreads = 128;
constexpr int kRows = 64;     // flattened (query, head-in-group) rows per block
constexpr int kTile = repro::kPlanTile;   // keys per tile, the unit of the split plan
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* ptab;          // nullptr: contiguous mode
  const int* kv_len;
  void* out;
  float* part_acc;          // [slot][kRows][D]
  float* part_ml;           // [slot][kRows][2]: m (natural units), l
  int B, Sq, Sk, H, Hkv, D, page_shift, n_ptab, causal, window;
  int target;               // blocks the plan aims at (one wave: 2 per SM)
  int n_cap;                // most splits of a lane; 1: none (no combine pass)
  float softcap, scale;
};

// The launch's split plan (common.cuh) with `pairs` (row block, KV head)
// pairs per lane.
__device__ __forceinline__ repro::Plan plan_of(const Args& a, int pairs) {
  return repro::Plan{a.kv_len, a.B, a.Sq, a.Sk, a.window, pairs, a.target, a.n_cap};
}

// Keys [lo, hi) that some query at positions [qmin, qmax] of a row with
// kv_len = len may see.
__device__ __forceinline__ void key_range(const Args& a, int len, int qmin, int qmax,
                                          int& lo, int& hi) {
  hi = min(len, a.Sk);
  if (a.causal) hi = min(hi, qmax + 1);
  lo = a.window > 0 ? max(0, qmin - a.window + 1) : 0;
}

// One work item: rows [r0, r0 + 64) of KV head kvh of lane b, key tiles
// [t_begin, t_end); slot < 0 writes the output, else partial slot `slot`.
struct Work {
  int b, kvh, r0, nrows, G, len;
  int k_lo, k_hi;
  int t_begin, t_end;
  int slot;
};

// Row block rb, KV head kvh, lane b with n splits: its key range and tiles.
__device__ __forceinline__ void block_range(const Args& a, Work& w, int rb, int n, int s,
                                            int slot0) {
  w.r0 = rb * kRows;
  const int r1 = min(w.r0 + kRows, w.nrows);
  key_range(a, w.len, w.len - a.Sq + w.r0 / w.G, w.len - a.Sq + (r1 - 1) / w.G,
            w.k_lo, w.k_hi);
  repro::split_tiles(w.k_lo / kTile, tiles_of(w.k_lo, w.k_hi), n, s, w.t_begin, w.t_end);
  w.slot = n <= 1 ? -1 : slot0 + s;
}

// Work item v of the launch (items numbered lane by lane, then (row block,
// KV head), then split).  Returns false past the last item or for an empty
// split.
__device__ bool plan_item(const Args& a, int v, Work& w) {
  w.G = a.H / a.Hkv;
  w.nrows = a.Sq * w.G;
  const int pairs = cdiv(w.nrows, kRows) * a.Hkv;
  repro::PlanItem it;
  if (!repro::plan_item(plan_of(a, pairs), v, it)) return false;
  w.b = it.b;
  w.len = it.len;
  w.kvh = it.pair % a.Hkv;
  block_range(a, w, it.pair / a.Hkv, it.n, it.s, it.slot0);
  return w.slot < 0 || w.t_begin < w.t_end;
}

// Offset of key j's row of KV head kvh in k/v (elements).
__device__ __forceinline__ size_t kv_offset(const Args& a, int b, int kvh, int j) {
  size_t row;
  if (a.ptab) {
    const int pg = __ldg(a.ptab + (size_t)b * a.n_ptab + (j >> a.page_shift));
    row = ((size_t)pg << a.page_shift) + (j & ((1 << a.page_shift) - 1));
  } else {
    row = (size_t)b * a.Sk + j;
  }
  return (row * a.Hkv + kvh) * a.D;
}

__device__ __forceinline__ size_t q_offset(const Args& a, const Work& w, int fr) {
  const int qi = fr / w.G;
  const int g = fr - qi * w.G;
  return (((size_t)w.b * a.Sq + qi) * a.H + (size_t)w.kvh * w.G + g) * a.D;
}

// A tile of 64 keys is wholly visible to every row of the block.
__device__ __forceinline__ bool tile_clear(const Args& a, const Work& w, int kt) {
  const int qmin = w.len - a.Sq + w.r0 / w.G;
  const int qmax = w.len - a.Sq + (min(w.r0 + kRows, w.nrows) - 1) / w.G;
  return kt + kTile <= min(w.len, a.Sk) && (!a.causal || kt + kTile - 1 <= qmin) &&
         (a.window <= 0 || qmax - kt < a.window);
}

__device__ __forceinline__ bool key_visible(const Args& a, int len, int qpos, int kpos) {
  const int diff = qpos - kpos;
  bool ok = kpos < len && kpos < a.Sk;
  if (a.causal) ok = ok && diff >= 0;
  if (a.window > 0) ok = ok && diff < a.window;
  return ok;
}

// --------------------------------------------------------------------------
// bf16: tensor cores
// --------------------------------------------------------------------------

template <int D>
struct TcLayout {
  static constexpr int kLd = D + 8;          // bf16 row pitch, 16-byte pad
  static constexpr int kQ = kRows * kLd;
  static constexpr int kKV = kTile * kLd;
  static constexpr int kStages = 2;
  static constexpr size_t kBytes = sizeof(bf16) * (kQ + (size_t)2 * kStages * kKV);
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_tc_kernel(const Args a) {
  using L = TcLayout<D>;
  constexpr int CPR = D / 8;                 // 16-byte chunks per row
  constexpr int NT = kTile / 8;              // score n-tiles per warp
  constexpr int DT = D / 8;                  // output n-tiles per warp
  Work w;
  if (!plan_item(a, blockIdx.x, w)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = qs + L::kQ;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* kg = static_cast<const bf16*>(a.k);
  const bf16* vg = static_cast<const bf16*>(a.v);
  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * 16;
  const int nt = w.t_end - w.t_begin;
  constexpr bool kQRegs = D <= 128;          // else Q fragments come from smem

  auto load_tile = [&](int t, int st) {
    bf16* ks = ring + st * 2 * L::kKV;
    bf16* vs = ks + L::kKV;
    const int kt = t * kTile;
#pragma unroll 4
    for (int i = tid; i < kTile * CPR; i += kThreads) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const int j = kt + r;
      const bool ok = j < w.k_hi;            // rows past the live keys: zeros
      const size_t off = ok ? kv_offset(a, w.b, w.kvh, j) + c : 0;
      cp_async16(ks + r * L::kLd + c, kg + off, ok ? 16 : 0);
      cp_async16(vs + r * L::kLd + c, vg + off, ok ? 16 : 0);
    }
  };

  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (nt > 0) {
    for (int i = tid; i < kRows * CPR; i += kThreads) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const int fr = w.r0 + r;
      const bool ok = fr < w.nrows;
      cp_async16(qs + r * L::kLd + c, ok ? q + q_offset(a, w, fr) + c : q, ok ? 16 : 0);
    }
    load_tile(w.t_begin, 0);
    cp_async_commit();

    int qpos[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int fr = min(w.r0 + wr + (lane >> 2) + 8 * h, w.nrows - 1);
      qpos[h] = w.len - a.Sq + fr / w.G;
    }
    const bool capped = a.softcap > 0.f;
    const float s_mul = capped ? a.scale / a.softcap : a.scale * kLog2e;
    const float cap_mul = a.softcap * kLog2e;
    uint32_t qf[kQRegs ? D / 16 : 1][4];

    for (int it = 0; it < nt; ++it) {
      const int st = it & 1;
      if (it + 1 < nt) load_tile(w.t_begin + it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();                    // tile it (and Q) have landed
      __syncthreads();
      if (kQRegs && it == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldmatrix_x4(qf[kk], qs + (wr + (lane & 15)) * L::kLd + kk * 16 + (lane >> 4) * 8);
      }
      const bf16* ks = ring + st * 2 * L::kKV;
      const bf16* vs = ks + L::kKV;

      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qt[4];
        if (!kQRegs)
          ldmatrix_x4(qt, qs + (wr + (lane & 15)) * L::kLd + kk * 16 + (lane >> 4) * 8);
        const uint32_t(&qa)[4] = kQRegs ? qf[kQRegs ? kk : 0] : qt;
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, ks + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * L::kLd + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[j], qa, bk[0], bk[1]);
          mma_bf16(s[j + 1], qa, bk[2], bk[3]);
        }
      }

      // scores in log2 units; masked entries kNegInf
      const int kt = (w.t_begin + it) * kTile;
      const bool clear = tile_clear(a, w, kt);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * s_mul;
          if (capped) x = cap_mul * tanhf(x);
          if (!clear &&
              !key_visible(a, w.len, qpos[e >> 1], kt + j * 8 + 2 * (lane & 3) + (e & 1)))
            x = kNegInf;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], mref[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = exp2f(m[h] - mx[h]);
        mref[h] = mx[h] == kNegInf ? 0.f : mx[h];   // nothing visible yet: p = 0
        m[h] = mx[h];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - mref[e >> 1]);
          s[j][e] = p;
          rs[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P V: the score accumulators of keys 16c .. 16c + 15 are the A
      // fragment of k-step c.  P enters as hi + lo bf16 halves (two
      // products), so P V keeps ~16 bits of P, as the f32 path does, and
      // l (summed from P in f32) normalises what was multiplied.
#pragma unroll
      for (int c = 0; c < kTile / 16; ++c) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * c][0], s[2 * c][1], ph[0], pl[0]);
        split_bf16(s[2 * c][2], s[2 * c][3], ph[1], pl[1]);
        split_bf16(s[2 * c + 1][0], s[2 * c + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * c + 1][2], s[2 * c + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int n = 0; n < DT; n += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vs + (c * 16 + (lane & 15)) * L::kLd + n * 8 + (lane >> 4) * 8);
          mma_bf16(o[n], ph, bv[0], bv[1]);
          mma_bf16(o[n], pl, bv[0], bv[1]);
          mma_bf16(o[n + 1], ph, bv[2], bv[3]);
          mma_bf16(o[n + 1], pl, bv[2], bv[3]);
        }
      }
      __syncthreads();                       // stage st is free for tile it + 2
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr + (lane >> 2) + 8 * h;
    const int fr = w.r0 + r;
    if (fr >= w.nrows) continue;
    const int c0 = 2 * (lane & 3);
    if (w.slot < 0) {
      bf16* op = out + q_offset(a, w, fr);
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(op + n * 8 + c0) =
            __floats2bfloat162_rn(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    } else {
      float* pa = a.part_acc + ((size_t)w.slot * kRows + r) * D;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<float2*>(pa + n * 8 + c0) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
      if ((lane & 3) == 0)
        *reinterpret_cast<float2*>(a.part_ml + ((size_t)w.slot * kRows + r) * 2) =
            make_float2(m[h] * kLn2, l[h]);
    }
  }
}

// --------------------------------------------------------------------------
// f32: CUDA cores
// --------------------------------------------------------------------------
constexpr int kSub = 32;      // keys per f32 sub-tile

template <int D>
constexpr size_t simt_smem_bytes() {
  return sizeof(float) * ((size_t)kRows * (D + 1) + (size_t)kSub * (D + 1) +
                          (size_t)kSub * D + (size_t)kRows * (kSub + 1));
}

// Each thread holds a 4x4 register tile of scores and a 4 x D/8 slice of
// the accumulator; row max and sum are reduced over the 8 threads of a row
// group with warp shuffles.  The next 32-key sub-tile is fetched into
// registers with 16-byte loads while the current one is processed.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_simt_kernel(const Args a) {
  constexpr int DJ = D / 8;                 // accumulator columns per thread
  Work w;
  if (!plan_item(a, blockIdx.x, w)) return;
  const float* q = static_cast<const float*>(a.q);
  const float* kg = static_cast<const float*>(a.k);
  const float* vg = static_cast<const float*>(a.v);
  const int tid = threadIdx.x;
  const int rg = tid >> 3;                  // row group: rows rg*4 .. rg*4+3
  const int cg = tid & 7;                   // column group

  extern __shared__ float smem[];
  float* Qs = smem;                         // [kRows][D+1]
  float* Ks = Qs + kRows * (D + 1);         // [kSub][D+1]
  float* Vs = Ks + kSub * (D + 1);          // [kSub][D]
  float* Ps = Vs + kSub * D;                // [kRows][kSub+1]

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int fr = w.r0 + r;
    Qs[r * (D + 1) + d] = fr < w.nrows ? q[q_offset(a, w, fr) + d] : 0.f;
  }
  int qpos[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int fr = min(w.r0 + rg * 4 + ii, w.nrows - 1);
    qpos[ii] = w.len - a.Sq + fr / w.G;
  }
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
  constexpr int kVecs = kSub * kDv;              // per sub-tile
  constexpr bool kPrefetch = D <= 128;           // the next sub-tile in registers
  constexpr int kLoads = kPrefetch ? (kVecs + kThreads - 1) / kThreads : 1;
  Pack8<float> kr[kLoads], vr[kLoads];
  auto fetch = [&](int kt) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      const int c = i / kDv;
      const int kk = kt + c;
      if (i >= kVecs) break;                     // D 112: 448 vectors, 4 rounds
      if (kk < w.k_hi) {
        const size_t off = kv_offset(a, w.b, w.kvh, kk) + (i - c * kDv) * 8;
        kr[j].load(kg + off);
        vr[j].load(vg + off);
      } else {
        kr[j].zero();
        vr[j].zero();
      }
    }
  };
  auto put = [&](int i, const Pack8<float>& kp, const Pack8<float>& vp) {
    const int c = i / kDv;
    const int d = (i - c * kDv) * 8;
    float kf[8], vf[8];
    kp.unpack(kf);
    vp.unpack(vf);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      Ks[c * (D + 1) + d + e] = kf[e];
      Vs[c * D + d + e] = vf[e];
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      if (tid + j * kThreads < kVecs) put(tid + j * kThreads, kr[j], vr[j]);
  };
  auto load_direct = [&](int kt) {               // D 256: global -> shared
    for (int i = tid; i < kVecs; i += kThreads) {
      const int c = i / kDv;
      Pack8<float> kp, vp;
      if (kt + c < w.k_hi) {
        const size_t off = kv_offset(a, w.b, w.kvh, kt + c) + (i - c * kDv) * 8;
        kp.load(kg + off);
        vp.load(vg + off);
      } else {
        kp.zero();
        vp.zero();
      }
      put(i, kp, vp);
    }
  };

  const int k_end = min(w.t_end * kTile, w.k_hi);
  const int kt0 = max(w.t_begin * kTile, (w.k_lo / kSub) * kSub);
  if (kPrefetch && kt0 < k_end) fetch(kt0);
  for (int kt = kt0; kt < k_end; kt += kSub) {
    if (kPrefetch) stash();
    else load_direct(kt);
    __syncthreads();
    if (kPrefetch && kt + kSub < k_end) fetch(kt + kSub);   // in flight during this sub-tile

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
        float x = s[ii][jj] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        ok[jj] = key_visible(a, w.len, qpos[ii], kt + cg * 4 + jj);
        s[ii][jj] = ok[jj] ? x : kNegInf;
        mloc = fmaxf(mloc, s[ii][jj]);
      }
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 4));
      const float mnew = fmaxf(m_i[ii], mloc);
      const float al = expf(m_i[ii] - mnew);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = ok[jj] ? expf(s[ii][jj] - mnew) : 0.f;
        Ps[(rg * 4 + ii) * (kSub + 1) + cg * 4 + jj] = p;
        psum += p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      l_i[ii] = l_i[ii] * al + psum;
      m_i[ii] = mnew;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[ii][j] *= al;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kSub; ++c) {
      float pv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) pv[ii] = Ps[(rg * 4 + ii) * (kSub + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * D + cg + 8 * j];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) acc[ii][j] = fmaf(pv[ii], vv, acc[ii][j]);
      }
    }
    __syncthreads();
  }

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = rg * 4 + ii;
    const int fr = w.r0 + r;
    if (fr >= w.nrows) continue;
    if (w.slot < 0) {
      float* op = out + q_offset(a, w, fr);
      const float denom = fmaxf(l_i[ii], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j) op[cg + 8 * j] = acc[ii][j] / denom;
    } else {
      float* pa = a.part_acc + ((size_t)w.slot * kRows + r) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) pa[cg + 8 * j] = acc[ii][j];
      if (cg == 0)
        *reinterpret_cast<float2*>(a.part_ml + ((size_t)w.slot * kRows + r) * 2) =
            make_float2(m_i[ii], l_i[ii]);
    }
  }
}

// --------------------------------------------------------------------------
// combine: grid (row blocks x 64 / kCombRows, B * Hkv), one warp per row of
// a lane with n_b >= 2 splits.  The lanes of a warp first turn the row's
// partial (m, l) into weights e^(m_s - M) / L in shared memory, then each
// lane sums its 4 columns over the splits, 4 loads in flight.
// --------------------------------------------------------------------------
constexpr int kCombRows = 8;
constexpr int kCombThreads = 32 * kCombRows;

template <typename T>
__global__ void __launch_bounds__(kCombThreads) flash_attention_combine_kernel(const Args a) {
  extern __shared__ float weights[];         // [kCombRows][n_cap]
  Work w;
  w.G = a.H / a.Hkv;
  w.nrows = a.Sq * w.G;
  const int n_rb = cdiv(w.nrows, kRows);
  const int pairs = n_rb * a.Hkv;
  const int rb = blockIdx.x / (kRows / kCombRows);
  const int sub = blockIdx.x - rb * (kRows / kCombRows);
  w.b = blockIdx.y / a.Hkv;
  w.kvh = blockIdx.y - w.b * a.Hkv;
  int slot0;
  const int n = repro::plan_lane(plan_of(a, pairs), w.b, rb * a.Hkv + w.kvh, slot0);
  if (n <= 1) return;                        // written by the split kernel
  w.len = __ldg(a.kv_len + w.b);
  block_range(a, w, rb, n, 0, slot0);
  const int n_tiles = tiles_of(w.k_lo, w.k_hi);
  const int per_rb = cdiv(n_tiles, n);
  const int live = per_rb ? min(n, cdiv(n_tiles, per_rb)) : 0;   // splits that ran

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = sub * kCombRows + warp;      // row within the 64-row block
  const int fr = w.r0 + r;
  if (fr >= w.nrows) return;
  float* wt = weights + warp * a.n_cap;
  const float* ml = a.part_ml + ((size_t)slot0 * kRows + r) * 2;   // split s: + s*kRows*2
  float M = kNegInf;
  for (int s = lane; s < live; s += 32) M = fmaxf(M, ml[(size_t)s * kRows * 2]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  float L = 0.f;
  for (int s = lane; s < live; s += 32) {
    const float e = expf(ml[(size_t)s * kRows * 2] - M);
    wt[s] = e;
    L += e * ml[(size_t)s * kRows * 2 + 1];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
  const float inv = 1.f / fmaxf(L, 1e-30f);
  __syncwarp();

  T* op = static_cast<T*>(a.out) + q_offset(a, w, fr);
  const float* pa = a.part_acc + ((size_t)slot0 * kRows + r) * a.D;  // split s: + s*kRows*D
  for (int c = lane * 4; c < a.D; c += 128) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < live; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(pa + (size_t)s * kRows * a.D + c);
      const float f = wt[s];
      acc.x += f * p.x;
      acc.y += f * p.y;
      acc.z += f * p.z;
      acc.w += f * p.w;
    }
    repro::put(op + c + 0, acc.x * inv);
    repro::put(op + c + 1, acc.y * inv);
    repro::put(op + c + 2, acc.z * inv);
    repro::put(op + c + 3, acc.w * inv);
  }
}

template <typename T, int D>
constexpr size_t smem_bytes() {
  if constexpr (std::is_same<T, bf16>::value) return TcLayout<D>::kBytes;
  else return simt_smem_bytes<D>();
}

template <typename T, int D>
cudaError_t launch(const Args& a, int grid, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  void (*kernel)(const Args);
  if constexpr (std::is_same<T, bf16>::value) kernel = flash_attention_tc_kernel<D>;
  else kernel = flash_attention_simt_kernel<D>;
  static bool smem_set[repro::kMaxDevices] = {};
  const cudaError_t set = repro::allow_smem(smem_set, (const void*)kernel, smem);
  if (set != cudaSuccess) return set;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_cap <= 1) return e;
  const int n_rb = cdiv(a.Sq * (a.H / a.Hkv), kRows);
  flash_attention_combine_kernel<T>
      <<<dim3(n_rb * (kRows / kCombRows), a.B * a.Hkv), kCombThreads,
         sizeof(float) * kCombRows * a.n_cap, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int grid, cudaStream_t stream) {
  if (a.D == 64) return launch<T, 64>(a, grid, stream);
  if (a.D == 112) return launch<T, 112>(a, grid, stream);
  if (a.D == 128) return launch<T, 128>(a, grid, stream);
  if (a.D == 256) return launch<T, 256>(a, grid, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D in {64, 112, 128, 256}.  ptab == nullptr:
// contiguous k/v (B, Sk, Hkv, D); else k/v are page pools (P, 2^page_shift,
// Hkv, D), ptab (B, n_ptab) int32, and Sk = n_ptab << page_shift.
// window <= 0: none; softcap <= 0: none.  grid = target + pairs * B work
// items (pairs = ceil(Sq*H/Hkv / 64) * Hkv); n_cap bounds a lane's splits
// (1: no split, no combine); part_acc / part_ml hold grid slots of 64 rows
// when n_cap > 1 (else unused).  Returns
// cudaGetLastError() after the launch(es).
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v,
                               const void* ptab, const void* kv_len, void* out,
                               void* part_acc, void* part_ml, int B, int Sq, int Sk,
                               int H, int Hkv, int D, int page_shift, int n_ptab,
                               int causal, int window, float softcap, float scale,
                               int target, int n_cap, int grid, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.ptab = static_cast<const int*>(ptab);
  a.kv_len = static_cast<const int*>(kv_len);
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.page_shift = page_shift;
  a.n_ptab = n_ptab;
  a.causal = causal;
  a.window = window;
  a.target = target;
  a.n_cap = n_cap;
  a.softcap = softcap;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(a, grid, st);
  if (dtype == 1) return dispatch_d<bf16>(a, grid, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory per block of the split kernel (bytes), from the
// layouts above; 0 for an unsupported (dtype, D).
template <typename T>
static int smem_of(int D) {
  if (D == 64) return (int)smem_bytes<T, 64>();
  if (D == 112) return (int)smem_bytes<T, 112>();
  if (D == 128) return (int)smem_bytes<T, 128>();
  if (D == 256) return (int)smem_bytes<T, 256>();
  return 0;
}

extern "C" int flash_attention_smem_bytes(int dtype, int D) {
  return dtype == 0 ? smem_of<float>(D) : dtype == 1 ? smem_of<bf16>(D) : 0;
}
