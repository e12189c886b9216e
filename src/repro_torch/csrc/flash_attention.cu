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
// Bound: operations at long sequences (whisper's encoder: 1500 queries
// over 1500 keys, and P V runs twice, P's bf16 halves), bytes at the
// serving chunks (each live K/V element is read once for the G = H/Hkv
// query heads of its group).  At a 64-token chunk neither is close: the
// time is latency, a block's chain of tile steps plus its fixed cost (the
// plan, the first loads, the epilogue: several microseconds), and how many
// blocks have work.  The design:
//
// * bf16: warp-specialised wgmma fed by TMA.  A block is one producer
//   warpgroup and one or two consumer warpgroups of 64 flattened (query,
//   head-in-group) rows of one KV head, so each K/V tile serves the whole
//   GQA group.  The wrapper launches two consumers when a KV head has more
//   than 64 rows; the block then splits either rows (128-row blocks, each
//   consumer 64 rows and every tile) or, when 128-row blocks would visit
//   at most `target` tiles in all (a latency-bound launch: one lane's
//   chunk, a shard's), keys (64-row blocks whose consumers take alternate
//   tiles and merge (m, l, O) through shared memory).  The card picks the
//   split from kv_len; each split is its own instantiation of the consumer
//   body, so the row split carries none of the key split's merge.
//   setmaxnreg gives the producer 40 registers, the consumers 232.
//   - One producer warp keeps a ring of K/V stages full (4 stages at
//     D <= 128, 2 at D 256) through full/empty mbarriers.  A tile of 64
//     keys whose keys all lie below kv_len arrives by TMA in the 128-byte
//     swizzle: one box of (64 columns, 1 KV head, 64 keys) per 64 columns
//     (contiguous), or per page and 64 columns (paged, page >= 8; ptab read
//     by the producer's lanes).  A tile that crosses kv_len, and every tile
//     of a page table with pages under 8 rows (the page-size-1 row tables
//     of whisper's sharded cross-attention), is gathered by the producer's
//     lanes with cp.async into the same swizzled layout, zeros past kv_len
//     (which TMA would fill with whatever the cache holds there), the copies
//     counted on the stage's full barrier.  A choice by tile, made alike by
//     producer and consumers, never a fallback.
//   - Each consumer loads its 64 query rows once, with cp.async, into the
//     swizzled layout (GQA groups such as qwen2's 6 do not divide 64 rows,
//     so no TMA box holds them).  S = Q K^T is an SS wgmma m64n64k16 over
//     D / 16 k-steps, Q and K both K-major in shared memory: no Q fragment
//     sits in registers at any D.  O += P V is an RS wgmma: P from
//     registers as the A operand (the S accumulator's layout is the A
//     fragment's), V MN-major through the transpose bit, N = D (N 128 at
//     D 112, whose columns past 112 are zeros; two N 128 products at
//     D 256).  P enters as bf16 hi and lo halves, two products into one
//     accumulator, so P keeps ~16 bits (P rounded to bf16 once put a
//     card-vs-CPU logit past the whole-model check's tolerance); l is summed
//     from P in f32.  Up to D 128 the loop is software-pipelined: tile t's
//     S is issued with tile t - 1's P V, and the softmax of t runs while
//     the tensor cores finish that P V (D 256 has no registers for a second
//     P).  The online softmax (log2 units, ex2.approx), the masks and the
//     softcap run in f32 registers; the score pass is specialised by
//     (softcap, mask) so that a clear tile runs neither (if-converted, both
//     cost every tile); only tiles that touch a boundary (kv_len, the
//     diagonal, the window) are masked element-wise.
//   - D 112 (zamba2) fills two 64-column boxes, the second to column 48:
//     TMA and the gather write zeros past column 112, so Q K^T runs 7
//     k-steps and P V a 128-column product.  D 256 (gemma2): the 64 x 256
//     f32 accumulator is 128 registers a thread, P and S 32 more.
// * f32 keeps a CUDA-core body (128 threads, 64 rows a block, FMAs from
//   shared memory, 32-key sub-tiles), since f32 is held to 2e-5, which TF32
//   would not meet.
// * A key split across blocks, with its combine folded into the split
//   kernel: one launch a call.  Every block reads kv_len and computes the
//   same plan (common.cuh, shared with the decode kernels): T_b live key
//   tiles of lane b, W = pairs * sum_b T_b tile visits (pairs = row blocks
//   x KV heads), per = max(min_per, ceil(W / target), ceil(max T / n_cap))
//   tiles per split (target: one wave, one bf16 block an SM, two f32
//   blocks; min_per 2 under the key split), raised until the items with
//   tiles fit one wave where they can (ceil(T_b / per) rounds up per lane:
//   a second, short wave), and n_b = ceil(T_b / per) splits for every
//   (row block, KV head) of lane b, each dividing its own live tiles
//   evenly.  Work items are numbered lane by lane, row blocks last to first
//   (under the causal mask the last rows see the most keys, so the longest
//   items start first); the grid is the host's bound target + pairs * B at
//   64-row blocks and blocks past the last item exit at once.  A pair whose
//   live tiles fit one split writes the output directly.  Otherwise each
//   split writes a partial (m, l, acc) in f32 to scratch and counts itself
//   in the pair's arrival counter; the last of the pair's splits to arrive
//   merges them (each row's weights e^(m_s - M) / L first, then the float4s
//   of its rows streamed from every split through shared memory with
//   cp.async), writes the output and resets the counter for the next
//   launch, as csrc/paged_flash_decode.cu does.  At most 16 splits a lane.
// * Head dims 64, 112, 128 and 256.

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::cdiv;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::kNegInf;
using repro::Pack8;
using repro::smem_addr;
using repro::split_bf16;
using repro::tiles_of;
using namespace repro::hopper;

constexpr int kWgRows = 64;   // rows of a consumer warpgroup (wgmma M); an f32 block's rows
constexpr int kTile = repro::kPlanTile;   // keys per tile, the unit of the split plan
constexpr int kMaxWg = 2;                 // consumer warpgroups of a bf16 block
constexpr int kTcThreads = 128 * (1 + kMaxWg);
constexpr int kProducerRegs = 40;         // its loops kept rolled to fit
constexpr int kConsumerRegs = 232;        // 40 * 128 + 232 * 256 = 168 * 384
constexpr int kSmemMax = 232448;          // dynamic shared memory a block may use
constexpr int kSimtThreads = 128;
constexpr int kMaxSplits = 16;            // most splits of a lane (the host's n_cap)
constexpr int kKeySplitMinPer = 2;        // a key split's fewest tiles a split: one a warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* ptab;          // nullptr: contiguous mode
  const int* kv_len;
  void* out;
  float* part_acc;          // [slot][block rows][D]
  float* part_ml;           // [slot][block rows][2]: m (natural units), l
  int* counters;            // [B][pairs] splits arrived; 0 between launches
  int B, Sq, Sk, H, Hkv, D, page_shift, n_ptab, causal, window;
  int consumers;            // bf16: consumer warpgroups a block, 1 or 2
  int target;               // blocks the plan aims at (one wave)
  int n_cap;                // most splits of a lane; 1: none
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

// One work item: rows [r0, r0 + rows) of KV head kvh of lane b, key tiles
// [t_begin, t_end).  slot < 0 writes the output; else the item writes
// partial `slot`, one of the `live` splits of its pair (partials slot0 ..
// slot0 + live - 1), and counts itself in counters[counter].  key_split:
// the bf16 body's two consumer warpgroups take alternate tiles of the same
// 64 rows (else each takes 64 of 128 rows and every tile).
struct Work {
  int b, kvh, r0, rows, nrows, G, len;
  bool key_split;
  int k_lo, k_hi;
  int t_begin, t_end;
  int slot, slot0, live, counter;
};

// Whether a bf16 launch of two consumer warpgroups splits keys: when
// 128-row blocks would visit at most `target` tiles in all (one a block or
// less: the launch is latency-bound, and two chains of alternate tiles halve
// each block's).  Computed by each warp, like the plan, from kv_len.
__device__ __forceinline__ bool key_split(const Args& a, int nrows) {
  if (a.consumers < 2) return false;
  const repro::Plan p = plan_of(a, cdiv(nrows, 2 * kWgRows) * a.Hkv);
  long long t = 0;
  for (int i = threadIdx.x & 31; i < a.B; i += 32) t += repro::lane_tiles(p, __ldg(a.kv_len + i));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t * p.pairs <= a.target;
}

// Work item v of the launch (items numbered lane by lane, then (row block,
// KV head), then split).  Returns false past the last item and for a split
// that gets no tile.  TC: the bf16 body (blocks of 128 rows or a key split).
template <bool TC>
__device__ bool plan_item(const Args& a, int v, Work& w) {
  w.G = a.H / a.Hkv;
  w.nrows = a.Sq * w.G;
  w.key_split = TC && key_split(a, w.nrows);
  // 128 rows (two warpgroups of rows) unless the keys are split or the
  // block has one consumer
  w.rows = TC && !w.key_split && a.consumers == 2 ? 2 * kWgRows : kWgRows;
  const int n_rb = cdiv(w.nrows, w.rows);
  const int pairs = n_rb * a.Hkv;
  repro::Plan p = plan_of(a, pairs);
  if (w.key_split) p.min_per = kKeySplitMinPer;
  repro::PlanItem it;
  if (!repro::plan_item<true>(p, v, it)) return false;
  w.b = it.b;
  w.len = it.len;
  w.kvh = it.pair % a.Hkv;
  w.r0 = (n_rb - 1 - it.pair / a.Hkv) * w.rows;     // row blocks last to first
  const int r1 = min(w.r0 + w.rows, w.nrows);
  key_range(a, w.len, w.len - a.Sq + w.r0 / w.G, w.len - a.Sq + (r1 - 1) / w.G, w.k_lo,
            w.k_hi);
  const int t0 = w.k_lo / kTile, T = tiles_of(w.k_lo, w.k_hi);
  // splits that get tiles: the first ceil(T / ceil(T / n)) of the lane's n
  w.live = it.n <= 1 || T == 0 ? min(T, 1) : cdiv(T, cdiv(T, it.n));
  w.slot0 = it.slot0;
  w.counter = w.b * pairs + it.pair;
  if (w.live <= 1) {                      // split 0 takes every tile (or none)
    w.t_begin = t0;
    w.t_end = t0 + T;
    w.slot = -1;
    return it.s == 0;
  }
  repro::split_tiles(t0, T, it.n, it.s, w.t_begin, w.t_end);
  w.slot = it.slot0 + it.s;
  return it.s < w.live;
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

// A tile of 64 keys at kt is wholly visible to queries at positions [qmin,
// qmax] of a lane with kv_len = len.
__device__ __forceinline__ bool tile_clear(const Args& a, int len, int kt, int qmin, int qmax) {
  return kt + kTile <= min(len, a.Sk) && (!a.causal || kt + kTile - 1 <= qmin) &&
         (a.window <= 0 || qmax - kt < a.window);
}

__device__ __forceinline__ bool key_visible(const Args& a, int len, int qpos, int kpos) {
  const int diff = qpos - kpos;
  bool ok = kpos < len && kpos < a.Sk;
  if (a.causal) ok = ok && diff >= 0;
  if (a.window > 0) ok = ok && diff < a.window;
  return ok;
}

// The combine, folded into the split kernel.  The n threads of the caller
// (index i, synchronised by sync()) have written their rows of partial
// w.slot; the barrier, then one acquire-release add by thread 0, publishes
// them and, for the last of the pair's live splits to arrive, orders the
// reads of the others'.  That block merges the partials: first each row's
// weights e^(m_s - M) / L (M = max_s m_s, L = sum_s e^(m_s - M) l_s) into
// `weights` (shared memory, w.rows x kMaxSplits), then every float4 of a
// row as sum_s weight_s acc_s, and it resets the counter for the next
// launch.
template <typename T, int D, int kP, int kNb, typename Sync>
__device__ __forceinline__ void combine_if_last(const Args& a, const Work& w, int i, int n,
                                                Sync sync, float* weights, float* stage) {
  __shared__ int last;
  sync();
  if (i == 0) {
    int* c = a.counters + w.counter;
    int before;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(before) : "l"(c) : "memory");
    last = before == w.live - 1;
    if (last) *c = 0;
  }
  sync();
  if (!last) return;
  const int rows = min(w.rows, w.nrows - w.r0);
  auto at = [&](int s, int r) { return (size_t)(w.slot0 + s) * w.rows + r; };
  // Each thread takes kP float4s of rows at a time (items e0 + k n) and
  // streams them from every split through kNb slots of `stage` with
  // cp.async: a thread copies exactly the chunks it reads, so the slots need
  // no barrier, and kNb splits' chunks of the whole block are in flight.
  // The first pass's first fetches go out before the weights are computed.
  constexpr int kV = D / 4;                  // float4 columns a row
  const int items = rows * kV;
  int r[kP];
  size_t off[kP];                            // (row, column) in a partial, floats
  auto locate = [&](int e0) {
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      const int e = min(e0 + k * n, items - 1);   // past the end: a repeat, not stored
      r[k] = e / kV;
      off[k] = (size_t)r[k] * D + (e - r[k] * kV) * 4;
    }
  };
  auto slot = [&](int s, int k) { return stage + (((s % kNb) * kP + k) * n + i) * 4; };
  auto fetch = [&](int s) {
    if (s < w.live) {
      const float* src = a.part_acc + at(s, 0) * D;
#pragma unroll
      for (int k = 0; k < kP; ++k) cp_async16(slot(s, k), src + off[k], 16);
    }
    cp_async_commit();                       // one group a split, empty past the last
  };
  auto prologue = [&]() {
#pragma unroll
    for (int s = 0; s < kNb - 1; ++s) fetch(s);
  };
  locate(i);
  prologue();
  for (int rr = i; rr < rows; rr += n) {     // loads bypass L1: other blocks wrote them
    float2 ml[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < w.live) ml[s] = __ldcg(reinterpret_cast<const float2*>(a.part_ml + at(s, rr) * 2));
    float M = kNegInf, L = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < w.live) M = fmaxf(M, ml[s].x);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < w.live) {
        ml[s].x = expf(ml[s].x - M);
        L += ml[s].x * ml[s].y;
      }
    const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < w.live) weights[rr * kMaxSplits + s] = ml[s].x * inv;
  }
  sync();
  for (int e0 = i; e0 < items; e0 += kP * n) {
    if (e0 != i) {
      locate(e0);
      prologue();
    }
    float4 acc[kP];
#pragma unroll
    for (int k = 0; k < kP; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < w.live; ++s) {
      fetch(s + kNb - 1);
      cp_async_wait<kNb - 1>();              // split s has landed
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        const float4 p = *reinterpret_cast<const float4*>(slot(s, k));
        const float f = weights[r[k] * kMaxSplits + s];
        acc[k].x += f * p.x;
        acc[k].y += f * p.y;
        acc[k].z += f * p.z;
        acc[k].w += f * p.w;
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      if (e0 + k * n >= items) break;
      T* op = static_cast<T*>(a.out) + q_offset(a, w, w.r0 + r[k]) + off[k] % D;
      repro::put(op + 0, acc[k].x);
      repro::put(op + 1, acc[k].y);
      repro::put(op + 2, acc[k].z);
      repro::put(op + 3, acc[k].w);
    }
  }
}

// --------------------------------------------------------------------------
// bf16: warp-specialised wgmma, K/V by TMA (or a cp.async gather)
// --------------------------------------------------------------------------

// Shared memory, from a 1024-byte aligned base: kMaxWg query tiles, then
// kStages stages of [K tile][V tile], then the full and empty barriers.
// A tile is 64 rows in boxes of 64 columns (8 KB each, rows of 128 bytes
// in the 128-byte swizzle), so every box is 1024-byte aligned, as the
// swizzle's 8-row atoms need.
template <int D>
struct TcLayout {
  static constexpr int kDp = (D + 63) / 64 * 64;    // columns in whole boxes
  static constexpr int kBoxes = kDp / 64;
  static constexpr int kBox = 64 * 128;
  static constexpr int kTileBytes = kBoxes * kBox;  // a Q, K or V tile
  static constexpr int kStage = 2 * kTileBytes;
  static constexpr int kBar = 256;
  static constexpr int kRoom = (kSmemMax - 1024 - kBar - kMaxWg * kTileBytes) / kStage;
  static constexpr int kStages = kRoom < 4 ? kRoom : 4;
  static constexpr size_t kBytes = 1024 + (size_t)kMaxWg * kTileBytes +
                                   (size_t)kStages * kStage + kBar;
  static_assert(kStages >= 2 && 16 * kStages <= kBar, "ring");
  // P V in products of kNc columns, kNch of them (two of 128 at D 256)
  static constexpr int kNc = kDp < 128 ? kDp : 128;
  static constexpr int kNch = kDp / kNc;
  // the combine's shared memory, over the query tiles and the ring: the
  // weights, then kCombineSlots slots of kCombineItems float4s a consumer
  static constexpr int kWeightBytes = kMaxWg * kWgRows * kMaxSplits * 4;
  static constexpr int kCombineItems = 8;
  static constexpr int kCombineRoom =
      (int)((kBytes - 1024 - kBar - kWeightBytes) / (kMaxWg * 128 * kCombineItems * 16));
  static constexpr int kCombineSlots = kCombineRoom < 8 ? kCombineRoom : 8;
  static_assert(kCombineSlots >= 2, "combine slots");
  // the softmax of a tile under the previous tile's P V holds two P's:
  // room for them up to D 128 (at D 256 O alone is 128 registers)
  static constexpr bool kPipelined = D <= 128;
};

// Byte offset of 16-byte chunk c (columns 8c ..) of row r of a tile.
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * (64 * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Whether tile kt comes by TMA: every key of it below the item's live end,
// and boxes of at least 8 rows (a page table's pages of 8 rows or more).
__device__ __forceinline__ bool tile_by_tma(const Args& a, int k_hi, int kt) {
  return (a.ptab == nullptr || a.page_shift >= 3) && kt + kTile <= k_hi;
}

template <int N>
__device__ __forceinline__ void fence_words(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 128)
    wgmma_m64n128k16_bf16_rs(d, a, b, 1);
  else
    wgmma_m64n64k16_bf16_rs(d, a, b, 1);
}

// 2^x on the special-function unit (ex2.approx, subnormal results flushed to
// 0): exp2f's own instruction without its denormal handling.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile's scores s (the S accumulator of a consumer thread) to log2
// units, softcapped (CAP) and masked (MASK: a tile that touches kv_len, the
// diagonal or the window; masked entries kNegInf), folding each row half's
// maximum into mx.  Specialised so that a clear tile, the common case, runs
// no mask and no softcap code: if-converted, both cost every tile their
// instructions.  Key of s[e]: k0 + 8 (e / 4) + (e % 2), k0 = kt + 2 (lane % 4).
template <bool CAP, bool MASK>
__device__ __forceinline__ void scores(const Args& a, int len, float (&s)[32], float (&mx)[2],
                                       float s_mul, float cap_mul, const int (&qpos)[2],
                                       int k0) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    float x = s[e] * s_mul;
    if constexpr (CAP) x = cap_mul * tanhf(x);
    if constexpr (MASK) {
      if (!key_visible(a, len, qpos[(e >> 1) & 1], k0 + 8 * (e >> 2) + (e & 1))) x = kNegInf;
    }
    s[e] = x;
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_attention_wgmma_kernel(const Args a, const __grid_constant__ CUtensorMap mk,
                                 const __grid_constant__ CUtensorMap mv) {
  using L = TcLayout<D>;
  if (threadIdx.x == 0 && (a.ptab == nullptr || a.page_shift >= 3)) {
    prefetch_tensormap(&mk);                 // the descriptors' first read overlaps the plan
    prefetch_tensormap(&mv);
  }
  Work w;
  if (!plan_item<true>(a, blockIdx.x, w)) return;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* base = tc_smem + ((1024 - (smem_addr(tc_smem) & 1023)) & 1023);
  unsigned char* ring = base + kMaxWg * L::kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::kStages * L::kStage);
  uint64_t* empty = full + L::kStages;
  const int tid = threadIdx.x, wg = tid / 128;
  const int nt = w.t_end - w.t_begin;
  // producer warps: all four of the producer warpgroup when some tile of
  // the item is gathered (page tables of pages under 8 rows: every tile;
  // else the tile that crosses kv_len), one else
  const bool small_pages = a.ptab != nullptr && a.page_shift < 3;
  const int n_prod = nt > 0 && (small_pages || w.t_end * kTile > w.k_hi) ? 4 : 1;
  __shared__ Work ws;                        // the item, for after the tile loop
  if (tid == 0) {
    ws = w;
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + s, n_prod);           // lane 0 of every producer warp
      // lane 0 of every warp of the warpgroups that read the stage
      mbar_init(empty + s, w.key_split ? 4 : 4 * a.consumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // --- producer: n_prod warps keep the ring full -----------------------------
    reg_dealloc<kProducerRegs>();
    const int pw = tid / 32, lane = tid % 32;
    if (pw >= n_prod) return;
    const bf16* kg = static_cast<const bf16*>(a.k);
    const bf16* vg = static_cast<const bf16*>(a.v);
    const int box_rows = a.ptab ? min(1 << a.page_shift, kTile) : kTile;
    const int n_box = 2 * L::kBoxes * (kTile / box_rows);   // K and V boxes of a tile
    int stage = 0;
    uint32_t phase = 0;
    for (int t = w.t_begin; t < w.t_end; ++t) {
      const int kt = t * kTile;
      mbar_wait(empty + stage, phase ^ 1);
      unsigned char* ks = ring + stage * L::kStage;
      unsigned char* vs = ks + L::kTileBytes;
      if (tile_by_tma(a, w.k_hi, kt)) {
        if (pw > 0) {                          // warp 0 loads the tile
          if (lane == 0) mbar_arrive(full + stage);
        } else {
        if (lane == 0) mbar_expect_tx(full + stage, L::kStage);
        __syncwarp();
        // box i: V if odd, column box (i / 2) % kBoxes, row box i / (2 kBoxes)
#pragma unroll 1
        for (int i = lane; i < n_box; i += 32) {
          const int c = (i >> 1) % L::kBoxes, p = i / (2 * L::kBoxes);
          const int j = kt + p * box_rows;
          int row;
          if (a.ptab) {
            const int pg = __ldg(a.ptab + (size_t)w.b * a.n_ptab + (j >> a.page_shift));
            row = (pg << a.page_shift) + (j & ((1 << a.page_shift) - 1));
          } else {
            row = w.b * a.Sk + j;
          }
          tma_load_3d(((i & 1) ? vs : ks) + c * L::kBox + p * box_rows * 128,
                      (i & 1) ? &mv : &mk, full + stage, c * 64, w.kvh, row);
        }
        }
      } else {
        // each warp gathers rows pw, pw + n_prod, ...: a row's key offset
        // once, its 16-byte chunks by the lanes; rows past the live keys and
        // columns past D: zeros
        constexpr int CPR = L::kDp / 8;
        constexpr int kRowsAtOnce = 32 / CPR > 0 ? 32 / CPR : 1;
#pragma unroll 1
        for (int r0 = pw * kRowsAtOnce; r0 < kTile; r0 += n_prod * kRowsAtOnce) {
          const int r = r0 + (CPR >= 32 ? 0 : lane / CPR);
          const int j = kt + r;
          const size_t row = j < w.k_hi ? kv_offset(a, w.b, w.kvh, j) : 0;
#pragma unroll 1
          for (int c = CPR >= 32 ? lane : lane % CPR; c < CPR; c += 32) {
            const bool ok = j < w.k_hi && c < D / 8;
            const size_t off = ok ? row + c * 8 : 0;
            cp_async16(ks + swz(r, c), kg + off, ok ? 16 : 0);
            cp_async16(vs + swz(r, c), vg + off, ok ? 16 : 0);
          }
        }
        cp_async_mbar_arrive(full + stage);
        __syncwarp();
        if (lane == 0) mbar_arrive(full + stage);
      }
      if (++stage == L::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // --- consumers: 64 rows each ----------------------------------------------
  // One body per split, so that the row split carries none of the key
  // split's merge (its mere presence slowed the row split ~9 % on an H100).
  reg_alloc<kConsumerRegs>();
  auto consume = [&](auto split_keys) {
    constexpr bool kKeySplit = decltype(split_keys)::value;
    const int cw = wg - 1, wtid = tid - 128 * wg, warp = wtid / 32, lane = tid % 32;
    // this warpgroup's rows [ra, rb) and tiles first, first + step, ...; the
    // tile loop keeps only these of the item in registers
    const int ra = w.r0 + (kKeySplit ? 0 : cw * kWgRows);
    const int rb = min(ra + kWgRows, w.nrows);
    const int first = kKeySplit ? cw : 0;
    constexpr int step = kKeySplit ? 2 : 1;
    const int len = w.len, t_begin = w.t_begin, k_hi = w.k_hi;
    const int qmin = len - a.Sq + ra / w.G, qmax = len - a.Sq + (rb - 1) / w.G;
    unsigned char* qs = base + cw * L::kTileBytes;
    const bf16* q = static_cast<const bf16*>(a.q);

    float o[L::kNch][L::kNc / 2];
#pragma unroll
    for (int n = 0; n < L::kNch; ++n)
#pragma unroll
      for (int e = 0; e < L::kNc / 2; ++e) o[n][e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    // tile it of the item sits in stage it % kStages, in its (it / kStages)-th fill
    auto stage_of = [](int it) { return it % L::kStages; };
    auto phase_of = [](int it) { return (uint32_t)(it / L::kStages) & 1; };

    if (ra >= rb) {
      // no rows here (the last block's second warpgroup): release each stage
      for (int it = 0; it < nt; ++it) {
        mbar_wait(full + stage_of(it), phase_of(it));
        if (lane == 0) mbar_arrive(empty + stage_of(it));
      }
    } else if (first < nt) {
      {
        constexpr int CPR = L::kDp / 8;
        for (int i = wtid; i < kWgRows * CPR; i += 128) {
          const int r = i / CPR, c = i - r * CPR;
          const bool ok = ra + r < rb && c < D / 8;
          cp_async16(qs + swz(r, c), ok ? q + q_offset(a, w, ra + r) + c * 8 : q, ok ? 16 : 0);
        }
        cp_async_commit();
        cp_async_wait<0>();
        fence_proxy_async();                   // Q, written by cp.async, is read by wgmma
        named_sync(2 + cw, 128);
      }
      int qpos[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int fr = min(ra + warp * 16 + (lane >> 2) + 8 * h, rb - 1);
        qpos[h] = len - a.Sq + fr / w.G;
      }
      const bool capped = a.softcap > 0.f;
      const float s_mul = capped ? a.scale / a.softcap : a.scale * kLog2e;
      const float cap_mul = a.softcap * kLog2e;
      const uint64_t dq = sw128_desc(qs, 16, 1024);
      float s[32];                             // S of the current tile, then its P
      uint32_t ph[4][4], pl[4][4];             // P of the previous tile, hi and lo halves

      // S = Q K^T of the tile in `st`: D / 16 k-steps, 4 per 64-column box.
      auto issue_s = [&](int st) {
        const uint64_t dk = sw128_desc(ring + st * L::kStage, 16, 1024);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int at = 512 * (kk / 4) + 2 * (kk % 4);   // 8 KB a box, 32 bytes a k-step
          wgmma_m64n64k16_bf16_kk(s, dq + at, dk + at, kk > 0);
        }
        wgmma_commit();
      };
      // O += P V of the tile in `st`: the accumulators of keys 16 c .. 16 c + 15
      // are the A fragment of k-step c, as hi + lo bf16 halves (two products).
      auto issue_pv = [&](int st) {
        const uint64_t dv = sw128_desc(ring + st * L::kStage + L::kTileBytes, L::kBox, 1024);
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int n = 0; n < L::kNch; ++n) {
            // 16 keys down is 2048 bytes; the next 128 columns two boxes on
            const uint64_t d = dv + 128 * c + n * (2 * L::kBox >> 4);
            wgmma_pv<L::kNc>(o[n], ph[c], d);
            wgmma_pv<L::kNc>(o[n], pl[c], d);
          }
        wgmma_commit();
      };
      // The tile at key kt: s to probabilities (log2 units; masked entries and
      // rows that see nothing yet give 0), m to the new row maxima; returns
      // the rescale alpha of O and l and the rows' sums of the tile in rs.
      auto softmax = [&](int kt, float (&alpha)[2], float (&rs)[2]) {
        float mx[2] = {m[0], m[1]};
        const bool clear = tile_clear(a, len, kt, qmin, qmax);
        const int k0 = kt + 2 * (lane & 3);
        if (capped) {
          if (clear) scores<true, false>(a, len, s, mx, s_mul, cap_mul, qpos, k0);
          else scores<true, true>(a, len, s, mx, s_mul, cap_mul, qpos, k0);
        } else {
          if (clear) scores<false, false>(a, len, s, mx, s_mul, cap_mul, qpos, k0);
          else scores<false, true>(a, len, s, mx, s_mul, cap_mul, qpos, k0);
        }
        float mref[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          alpha[h] = ex2(m[h] - mx[h]);
          mref[h] = mx[h] == kNegInf ? 0.f : mx[h];   // nothing visible yet: p = 0
          m[h] = mx[h];
          rs[h] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          s[e] = ex2(s[e] - mref[(e >> 1) & 1]);
          rs[(e >> 1) & 1] += s[e];
        }
      };
      // O and l rescaled, then P of the tile into its halves (after the
      // previous tile's P V has finished with both).
      auto fold = [&](const float (&alpha)[2], const float (&rs)[2]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
        for (int n = 0; n < L::kNch; ++n)
#pragma unroll
          for (int e = 0; e < L::kNc / 2; ++e) o[n][e] *= alpha[(e >> 1) & 1];
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            split_bf16(s[8 * c + 2 * x], s[8 * c + 2 * x + 1], ph[c][x], pl[c][x]);
      };
      auto wait_full = [&](int it) {
        mbar_wait(full + stage_of(it), phase_of(it));
        if (!tile_by_tma(a, k_hi, (t_begin + it) * kTile)) fence_proxy_async();   // by cp.async
      };
      auto release = [&](int it) {
        if (lane == 0) mbar_arrive(empty + stage_of(it));
      };

      // Software pipeline: while the tensor cores run P V of tile t - 1, the
      // warpgroup turns S of tile t into P.  Tile t's S is issued with tile
      // t - 1's P V; the first wait returns when S is done, the softmax runs,
      // the second wait returns when P V is done, whose stage is then released.
      float alpha[2], rs[2];
      auto tile_key = [&](int it) { return (t_begin + it) * kTile; };
      if constexpr (!L::kPipelined) {
        for (int it = first; it < nt; it += step) {
          wait_full(it);
          wgmma_fence();
          issue_s(stage_of(it));
          wgmma_wait<0>();
          fence_regs(s);
          softmax(tile_key(it), alpha, rs);
          fold(alpha, rs);
          wgmma_fence();
          issue_pv(stage_of(it));
          wgmma_wait<0>();
#pragma unroll
          for (int n = 0; n < L::kNch; ++n) fence_regs(o[n]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            fence_words(ph[c]);
            fence_words(pl[c]);
          }
          release(it);
        }
      } else {
        wait_full(first);
        wgmma_fence();
        issue_s(stage_of(first));
        wgmma_wait<0>();
        fence_regs(s);
        softmax(tile_key(first), alpha, rs);
        fold(alpha, rs);
        int prev = first;
        for (int it = first + step; it < nt; it += step) {
          wait_full(it);
          wgmma_fence();
          issue_s(stage_of(it));
          issue_pv(stage_of(prev));
          wgmma_wait<1>();                     // S of tile it
          fence_regs(s);
          softmax(tile_key(it), alpha, rs);
          wgmma_wait<0>();                     // P V of the previous tile
#pragma unroll
          for (int n = 0; n < L::kNch; ++n) fence_regs(o[n]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            fence_words(ph[c]);
            fence_words(pl[c]);
          }
          release(prev);
          fold(alpha, rs);
          prev = it;
        }
        wgmma_fence();
        issue_pv(stage_of(prev));
        wgmma_wait<0>();
#pragma unroll
        for (int n = 0; n < L::kNch; ++n) fence_regs(o[n]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          fence_words(ph[c]);
          fence_words(pl[c]);
        }
        release(prev);
      }
    }

    if constexpr (kKeySplit) {
      // The two warpgroups hold (m, l, O) of the same rows over alternate
      // tiles: warpgroup 1's pass through the ring, free once both are past
      // their last tile, and warpgroup 0 merges them (thread t with thread t,
      // which hold the same elements).
      float* x = reinterpret_cast<float*>(ring);
      constexpr int kO = L::kNch * L::kNc / 2;
      named_sync(1, 128 * kMaxWg);              // key split: two consumers
      if (cw == 1) {
#pragma unroll
        for (int n = 0; n < L::kNch; ++n)
#pragma unroll
          for (int e = 0; e < L::kNc / 2; ++e) x[(n * L::kNc / 2 + e) * 128 + wtid] = o[n][e];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          x[(kO + h) * 128 + wtid] = m[h];
          x[(kO + 2 + h) * 128 + wtid] = l[h];
        }
      }
      named_sync(1, 128 * kMaxWg);
      if (cw == 0) {
        float a0[2], a1[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float m1 = x[(kO + h) * 128 + wtid];
          const float mx = fmaxf(m[h], m1);
          a0[h] = ex2(m[h] - mx);
          a1[h] = ex2(m1 - mx);
          l[h] = l[h] * a0[h] + x[(kO + 2 + h) * 128 + wtid] * a1[h];
          m[h] = mx;
        }
#pragma unroll
        for (int n = 0; n < L::kNch; ++n)
#pragma unroll
          for (int e = 0; e < L::kNc / 2; ++e)
            o[n][e] = o[n][e] * a0[(e >> 1) & 1] +
                      x[(n * L::kNc / 2 + e) * 128 + wtid] * a1[(e >> 1) & 1];
      }
    }

    const Work& wk = ws;                       // read back, not held through the loop
    if (ra < rb && !(kKeySplit && cw == 1)) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ra - wk.r0 + warp * 16 + (lane >> 2) + 8 * h;   // row of the block
        const int fr = wk.r0 + r;
        if (fr >= rb) continue;
        if (wk.slot < 0) {
          bf16* op = static_cast<bf16*>(a.out) + q_offset(a, wk, fr);
          const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
          for (int n = 0; n < L::kNch; ++n)
#pragma unroll
            for (int j = 0; j < L::kNc / 8; ++j) {
              const int col = n * L::kNc + 8 * j + 2 * (lane & 3);
              if (col < D)
                *reinterpret_cast<__nv_bfloat162*>(op + col) = __floats2bfloat162_rn(
                    o[n][4 * j + 2 * h] * inv, o[n][4 * j + 2 * h + 1] * inv);
            }
        } else {
          const size_t row = (size_t)wk.slot * wk.rows + r;
          float* pa = a.part_acc + row * D;
#pragma unroll
          for (int n = 0; n < L::kNch; ++n)
#pragma unroll
            for (int j = 0; j < L::kNc / 8; ++j) {
              const int col = n * L::kNc + 8 * j + 2 * (lane & 3);
              if (col < D)
                *reinterpret_cast<float2*>(pa + col) =
                    make_float2(o[n][4 * j + 2 * h], o[n][4 * j + 2 * h + 1]);
            }
          if ((lane & 3) == 0)
            *reinterpret_cast<float2*>(a.part_ml + row * 2) = make_float2(m[h] * kLn2, l[h]);
        }
      }
    }
    if (wk.slot >= 0)
      combine_if_last<bf16, D, L::kCombineItems, L::kCombineSlots>(
          a, wk, tid - 128, 128 * a.consumers, [&] { named_sync(1, 128 * a.consumers); },
          reinterpret_cast<float*>(base), reinterpret_cast<float*>(base + L::kWeightBytes));
  };
  if (w.key_split) consume(std::true_type{});
  else consume(std::false_type{});
}

// --------------------------------------------------------------------------
// f32: CUDA cores
// --------------------------------------------------------------------------
constexpr int kSub = 32;      // keys per f32 sub-tile

template <int D>
constexpr size_t simt_smem_bytes() {
  return sizeof(float) * ((size_t)kWgRows * (D + 1) + (size_t)kSub * (D + 1) +
                          (size_t)kSub * D + (size_t)kWgRows * (kSub + 1));
}
// The combine's slots in that shared memory, after the weights.
template <int D>
struct SimtCombine {
  static constexpr int kItems = 4;
  static constexpr int kRoom = (int)((simt_smem_bytes<D>() - kWgRows * kMaxSplits * 4) /
                                     (kSimtThreads * kItems * 16));
  static constexpr int kSlots = kRoom < 8 ? kRoom : 8;
  static_assert(kSlots >= 2, "combine slots");
};

// Each thread holds a 4x4 register tile of scores and a 4 x D/8 slice of
// the accumulator; row max and sum are reduced over the 8 threads of a row
// group with warp shuffles.  The next 32-key sub-tile is fetched into
// registers with 16-byte loads while the current one is processed.
template <int D>
__global__ void __launch_bounds__(kSimtThreads) flash_attention_simt_kernel(const Args a) {
  constexpr int DJ = D / 8;                 // accumulator columns per thread
  Work w;
  if (!plan_item<false>(a, blockIdx.x, w)) return;
  const float* q = static_cast<const float*>(a.q);
  const float* kg = static_cast<const float*>(a.k);
  const float* vg = static_cast<const float*>(a.v);
  const int tid = threadIdx.x;
  const int rg = tid >> 3;                  // row group: rows rg*4 .. rg*4+3
  const int cg = tid & 7;                   // column group

  extern __shared__ float smem[];
  float* Qs = smem;                         // [kWgRows][D+1]
  float* Ks = Qs + kWgRows * (D + 1);       // [kSub][D+1]
  float* Vs = Ks + kSub * (D + 1);          // [kSub][D]
  float* Ps = Vs + kSub * D;                // [kWgRows][kSub+1]

  for (int i = tid; i < kWgRows * D; i += kSimtThreads) {
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
  constexpr int kLoads = kPrefetch ? (kVecs + kSimtThreads - 1) / kSimtThreads : 1;
  Pack8<float> kr[kLoads], vr[kLoads];
  auto fetch = [&](int kt) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kSimtThreads;
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
      if (tid + j * kSimtThreads < kVecs) put(tid + j * kSimtThreads, kr[j], vr[j]);
  };
  auto load_direct = [&](int kt) {               // D 256: global -> shared
    for (int i = tid; i < kVecs; i += kSimtThreads) {
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
      float* pa = a.part_acc + ((size_t)w.slot * kWgRows + r) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) pa[cg + 8 * j] = acc[ii][j];
      if (cg == 0)
        *reinterpret_cast<float2*>(a.part_ml + ((size_t)w.slot * kWgRows + r) * 2) =
            make_float2(m_i[ii], l_i[ii]);
    }
  }
  if (w.slot >= 0)
    combine_if_last<float, D, SimtCombine<D>::kItems, SimtCombine<D>::kSlots>(
        a, w, tid, kSimtThreads, [] { __syncthreads(); }, smem, smem + kWgRows * kMaxSplits);
}

template <typename T, int D>
constexpr size_t smem_bytes() {
  if constexpr (std::is_same<T, bf16>::value) return TcLayout<D>::kBytes;
  else return simt_smem_bytes<D>();
}

template <typename T, int D>
cudaError_t launch(const Args& a, int kv_rows, int grid, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  static bool smem_set[repro::kMaxDevices] = {};
  if constexpr (std::is_same<T, bf16>::value) {
    // tensor maps of K and V (heads x rows x D, boxes of 64 columns x 1 head
    // x min(page, 64) rows), unless every tile is gathered (pages of < 8)
    CUtensorMap mk = {}, mv = {};
    if (a.ptab == nullptr || a.page_shift >= 3) {
      const uint32_t box_rows =
          a.ptab && a.page_shift < 6 ? 1u << a.page_shift : (uint32_t)kTile;
      int err = encode_bf16_heads(&mk, a.k, D, a.Hkv, kv_rows, box_rows);
      if (!err) err = encode_bf16_heads(&mv, a.v, D, a.Hkv, kv_rows, box_rows);
      if (err) return static_cast<cudaError_t>(err);
    }
    const cudaError_t set =
        repro::allow_smem(smem_set, (const void*)flash_attention_wgmma_kernel<D>, smem);
    if (set != cudaSuccess) return set;
    flash_attention_wgmma_kernel<D><<<grid, 128 * (1 + a.consumers), smem, stream>>>(a, mk, mv);
  } else {
    const cudaError_t set =
        repro::allow_smem(smem_set, (const void*)flash_attention_simt_kernel<D>, smem);
    if (set != cudaSuccess) return set;
    flash_attention_simt_kernel<D><<<grid, kSimtThreads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int kv_rows, int grid, cudaStream_t stream) {
  if (a.D == 64) return launch<T, 64>(a, kv_rows, grid, stream);
  if (a.D == 112) return launch<T, 112>(a, kv_rows, grid, stream);
  if (a.D == 128) return launch<T, 128>(a, kv_rows, grid, stream);
  if (a.D == 256) return launch<T, 256>(a, kv_rows, grid, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D in {64, 112, 128, 256}.  ptab == nullptr:
// contiguous k/v (B, Sk, Hkv, D); else k/v are page pools (P, 2^page_shift,
// Hkv, D), ptab (B, n_ptab) int32, and Sk = n_ptab << page_shift; kv_rows
// is k's rows (B * Sk, or P << page_shift).  window <= 0: none; softcap <= 0:
// none.  rows: flattened (query, head-in-group) rows a block, 64 (f32
// always) or 128 (bf16 with two consumer warpgroups).  grid = target +
// pairs * B work items (pairs = ceil(Sq*H/Hkv / rows) * Hkv); n_cap bounds a
// lane's splits (1: no split); when n_cap > 1, part_acc / part_ml hold grid
// slots of `rows` rows and counters B * pairs ints, zero before the launch
// and after it (else all three are unused).  Launches on `stream` only, one
// kernel; returns cudaGetLastError() after the launch.
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v,
                               const void* ptab, const void* kv_len, void* out,
                               void* part_acc, void* part_ml, void* counters, int B, int Sq,
                               int Sk, int H, int Hkv, int D, int page_shift, int n_ptab,
                               int kv_rows, int causal, int window, float softcap, float scale,
                               int consumers, int target, int n_cap, int grid, void* stream) {
  if (Hkv <= 0 || H % Hkv || n_cap > kMaxSplits || consumers < 1 || consumers > kMaxWg)
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.ptab = static_cast<const int*>(ptab);
  a.kv_len = static_cast<const int*>(kv_len);
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.counters = static_cast<int*>(counters);
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
  a.consumers = consumers;
  a.target = target;
  a.n_cap = n_cap;
  a.softcap = softcap;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(a, kv_rows, grid, st);
  if (dtype == 1) return dispatch_d<bf16>(a, kv_rows, grid, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory per block of the kernel (bytes), from the layouts
// above; 0 for an unsupported (dtype, D).
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
