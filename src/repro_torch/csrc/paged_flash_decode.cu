// Flash-decode for Hopper (sm_90a), paged and contiguous, plain C interface
// for ctypes.
//
// Replaces two TPU kernels of src/repro/kernels/flash_decode/kernel.py:
// paged_flash_decode_kernel (:164, body _paged_decode_kernel), one-token GQA
// decode attention over a block-paged KV pool, and flash_decode_kernel (:74,
// body _decode_kernel), the same over a contiguous (B, S, Hkv, D) cache
// with a kv_len mask.  Both compute the G = H/Hkv query heads of a group
// against their un-repeated K/V: keys below kv_len (paged, with a window:
// and at or above kv_len - window), online softmax in f32, and
// acc / max(l, 1e-30), which is 0 for a lane with kv_len = 0.  One body
// serves both modes.  With ptab, key j of lane b is row j % page of page
// ptab[b][j / page], found by shift and mask inside the kernel (page a power
// of two); without it, key j is row b*S + j of the contiguous cache, by
// stride, and no page table is built.
//
// Bound: bytes (each live K/V element is read once for the G query heads of
// its group, ~4 G flops per element).  At the serving shapes neither bound
// is near (1.75 us of bytes at the timed shape): the time is latency, the
// longest chain of dependent tile steps in one block plus the launches.
// The design:
//
// * A split plan over live tiles, made on the card (common.cuh, shared with
//   flash_attention.cu): every block reads kv_len and computes T_b, the
//   live 64-key tiles of each lane (counting the window),
//   per = max(1, ceil(Hkv * sum_b T_b / target), ceil(max_b T_b / n_cap))
//   and n_b = ceil(T_b / per) splits for each KV head of lane b (n_cap
//   from the host bounds the combine below).  A block takes one item: one
//   (lane, KV head) and at most per tiles.  Items are numbered lane by lane; the
//   host bounds the grid by target + Hkv * B and blocks past the last item
//   exit at once.  An idle (lane, KV head) still gets one item, which
//   writes its zeros; a lane with n_b = 1 writes its output directly; the
//   splits of a lane with n_b >= 2 write partial (m, l, acc) rows in f32
//   and the last of them to finish combines them.
// * Tensor cores for the GQA group (bf16).  The group's G <= 16 query rows,
//   zero-padded to 16, are one mma.sync m16 A fragment, loaded once with
//   ldmatrix and kept in registers.  Each of the 4 warps owns 16 keys of
//   every 64-key tile and streams them, bf16, through its own 2-stage
//   cp.async ring (rows padded by 16 bytes, so ldmatrix's eight rows hit
//   distinct banks): the tile loop has no block barrier, only the ring's
//   wait and __syncwarp.  S = Q K^T and O += P V run as mma.sync.m16n8k16
//   with f32 accumulation (V read with ldmatrix .trans); P enters P V as a
//   bf16 hi and a bf16 lo part, as in flash_attention.cu.  Each warp keeps
//   its own online softmax (m, l) in f32 registers (log2 units), reduced
//   across the quad by shuffle; its 16 keys are neither loaded nor computed
//   when wholly outside [lo, hi), and masked element-wise only when they
//   cross lo or hi.  The block merges its 4 warps' (m, l, acc) through
//   shared memory once, at the end.
// * f32 keeps a CUDA-core body under the same plan (FMAs from shared memory,
//   32-key sub-tiles), since f32 is held to 2e-5, which TF32 would not meet.
// * The combine, folded into the split kernel: one launch per call.  A
//   split that has written its partial counts itself in a per-(lane, KV
//   head) counter; the last of the n_b to arrive reads the n_b partials
//   (each thread merges a float4 of a query head online, 8 splits' loads in
//   flight), writes the output and resets the counter to 0 for the next
//   launch.  n_cap = 16 keeps that merge to two rounds of loads.
// * An optional tanh logit softcap, cap * tanh(s / cap) on each scaled
//   score before the mask (gemma2's 50), in both bodies and both modes.
//   The TPU decode kernels have none; the reference decodes softcapped
//   configs on its gather path (src/repro/models/layers.py:155-157).
// * Head dims 64, 112, 128 and 256.  D 112 (zamba2) is 7 k16 steps and 14
//   16-byte chunks a row; every loop steps D by 16 and rows are padded, not
//   swizzled.  At D 256 (gemma2) the 16 x 256 f32 O accumulator takes 128
//   registers a thread, so the Q fragments are read from shared memory at
//   each k-step instead of being held (D <= 128 holds them); Q and the 4
//   warps' 2-stage rings are 140 KB, one block per SM, and the host's plan
//   target follows the shared memory (kernels/split_plan.py::target).  The
//   f32 body gives each thread two columns at D 256 and leaves 16 threads
//   without a column at D 112.
//
// G = H/Hkv <= 16.

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::kNegInf;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::split_bf16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = repro::kPlanTile;   // keys per tile, the unit of the split plan
constexpr int kChunk = kTile / kWarps;    // keys of a tile per warp (bf16 body)
constexpr int kMaxG = 16;                 // query heads per group: one m16 fragment
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* ptab;          // nullptr: contiguous mode
  const int* kv_len;
  void* out;
  float* part_acc;          // [item][G][D]
  float* part_ml;           // [item][G][2]: m (natural units), l
  int* counters;            // [B][Hkv] splits arrived; 0 between launches
  int B, H, Hkv, page_shift, n_ptab, Sk, window;
  int target;               // blocks the plan aims at
  int n_cap;                // most splits of a lane; 1: none
  float scale;
  float softcap;            // <= 0: none
};

__device__ __forceinline__ repro::Plan plan_of(const Args& a) {
  return repro::Plan{a.kv_len, a.B, 1, a.Sk, a.window, a.Hkv, a.target, a.n_cap};
}

// One work item: KV head kvh of lane b, its live keys [lo, hi), key tiles
// [t_begin, t_end); slot < 0 writes the output, else partial slot `slot`,
// split s of the pair's n, whose partials start at item slot0.
struct Work {
  int b, kvh, G, lo, hi, t_begin, t_end, slot, n, slot0;
  size_t q0;                // the group's first row of q and out (elements)
};

template <int D>
__device__ __forceinline__ bool find_work(const Args& a, Work& w) {
  const repro::Plan p = plan_of(a);
  repro::PlanItem it;
  if (!repro::plan_item(p, blockIdx.x, it)) return false;
  w.b = it.b;
  w.kvh = it.pair;
  w.G = a.H / a.Hkv;
  repro::lane_keys(p, it.len, w.lo, w.hi);
  repro::split_tiles(w.lo / kTile, repro::tiles_of(w.lo, w.hi), it.n, it.s, w.t_begin,
                     w.t_end);
  w.slot = it.n <= 1 ? -1 : it.slot0 + it.s;
  w.n = it.n;
  w.slot0 = it.slot0;
  w.q0 = ((size_t)w.b * a.H + (size_t)w.kvh * w.G) * D;
  return true;
}

// Offset of key j's row of KV head kvh in k/v (elements).
template <int D>
__device__ __forceinline__ size_t kv_offset(const Args& a, int b, int kvh, int j) {
  size_t row;
  if (a.ptab) {
    const int pg = __ldg(a.ptab + (size_t)b * a.n_ptab + (j >> a.page_shift));
    row = ((size_t)pg << a.page_shift) + (j & ((1 << a.page_shift) - 1));
  } else {
    row = (size_t)b * a.Sk + j;
  }
  return (row * a.Hkv + kvh) * D;
}

// A finished row element of an item (f32 body): out = acc / max(l, 1e-30),
// or the partial (acc, m in natural units, l) of a split.
template <int D>
__device__ __forceinline__ void finish(const Args& a, const Work& w, int g, int d, float acc,
                                       float m_nat, float l) {
  if (w.slot < 0) {
    static_cast<float*>(a.out)[w.q0 + (size_t)g * D + d] = acc / fmaxf(l, 1e-30f);
  } else {
    const size_t row = (size_t)w.slot * w.G + g;
    a.part_acc[row * D + d] = acc;
    if (d == 0) *reinterpret_cast<float2*>(a.part_ml + row * 2) = make_float2(m_nat, l);
  }
}

// The combine of a split pair's n partials, by the whole block: thread t
// takes 4 consecutive columns of a query head (a float4), two such items at
// a time, and merges the splits online (running max M, sum L, acc), 8
// splits' loads in flight per item.  Loads bypass L1: other blocks wrote
// the partials.
template <typename T, int D>
__device__ __forceinline__ void combine_splits(const Args& a, const Work& w) {
  constexpr int kV = D / 4;                 // float4 columns per row
  constexpr int kS = 8;                     // splits in flight
  const int items = w.G * kV;
  for (int i0 = threadIdx.x; i0 < items; i0 += 2 * kThreads) {
    float4 acc[2];
    float M[2] = {kNegInf, kNegInf}, L[2] = {0.f, 0.f};
    size_t row[2];
    int col[2];
    const bool two = i0 + kThreads < items;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = two ? i0 + k * kThreads : i0;
      row[k] = (size_t)w.slot0 * w.G + i / kV;
      col[k] = (i % kV) * 4;
      acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int s0 = 0; s0 < w.n; s0 += kS) {
      float4 p[2][kS];
      float2 e[2][kS];
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          if (s0 + j < w.n && (k == 0 || two)) {
            const size_t r = row[k] + (size_t)(s0 + j) * w.G;   // split s0 + j's row
            p[k][j] = __ldcg(reinterpret_cast<const float4*>(a.part_acc + r * D + col[k]));
            e[k][j] = __ldcg(reinterpret_cast<const float2*>(a.part_ml + r * 2));
          }
        }
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          if (s0 + j < w.n && (k == 0 || two)) {
            const float mn = fmaxf(M[k], e[k][j].x);
            const float f0 = expf(M[k] - mn), f1 = expf(e[k][j].x - mn);
            acc[k].x = acc[k].x * f0 + p[k][j].x * f1;
            acc[k].y = acc[k].y * f0 + p[k][j].y * f1;
            acc[k].z = acc[k].z * f0 + p[k][j].z * f1;
            acc[k].w = acc[k].w * f0 + p[k][j].w * f1;
            L[k] = L[k] * f0 + e[k][j].y * f1;
            M[k] = mn;
          }
        }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = i0 + k * kThreads;
      if (k == 1 && !two) continue;
      const float inv = 1.f / fmaxf(L[k], 1e-30f);
      T* op = static_cast<T*>(a.out) + w.q0 + (size_t)(i / kV) * D + col[k];
      repro::put(op, acc[k].x * inv);
      repro::put(op + 1, acc[k].y * inv);
      repro::put(op + 2, acc[k].z * inv);
      repro::put(op + 3, acc[k].w * inv);
    }
  }
}

// The combine, folded into the split kernel: after a split has written its
// partial, the last of its pair's n splits to arrive (a counter per (lane,
// KV head), reset by that block for the next launch) merges all n.  The
// barrier, then one acquire-release add by thread 0, publishes the block's
// partial and, for the last block, orders the reads of the others'.
template <typename T, int D>
__device__ __forceinline__ void combine_if_last(const Args& a, const Work& w) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int* c = a.counters + (size_t)w.b * a.Hkv + w.kvh;
    int before;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(before) : "l"(c) : "memory");
    last = before == w.n - 1;
    if (last) *c = 0;
  }
  __syncthreads();
  if (last) combine_splits<T, D>(a, w);
}

// --------------------------------------------------------------------------
// bf16: tensor cores
// --------------------------------------------------------------------------
template <int D>
struct TcLayout {
  static constexpr int kLd = D + 8;                    // bf16 row pitch, 16-byte pad
  static constexpr int kQ = kMaxG * kLd;               // the padded query rows
  static constexpr int kStage = 2 * kChunk * kLd;      // one warp's K and V chunk
  static constexpr int kStages = 2;
  static constexpr size_t kRing =
      sizeof(bf16) * ((size_t)kQ + (size_t)kWarps * kStages * kStage);
  static constexpr int kLdm = D + 8;                   // f32 merge row pitch: stores
                                                       // of 8 rows hit distinct banks
  static constexpr size_t kMerge = sizeof(float) * kWarps * kMaxG * (kLdm + 2);
  static constexpr size_t kBytes = kRing > kMerge ? kRing : kMerge;
};

template <int D>
__global__ void __launch_bounds__(kThreads) decode_split_tc_kernel(const Args a) {
  using L = TcLayout<D>;
  constexpr int CPR = D / 8;                 // 16-byte chunks per row
  constexpr int DT = D / 8;                  // output n-tiles
  Work w;
  if (!find_work<D>(a, w)) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = w.t_end - w.t_begin;
  if (nt == 0) {                             // an idle (lane, KV head): zeros
    bf16* out = static_cast<bf16*>(a.out) + w.q0;
    for (int i = tid; i < w.G * D; i += kThreads) out[i] = __float2bfloat16(0.f);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = qs + L::kQ + warp * L::kStages * L::kStage;   // this warp's ring
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* kg = static_cast<const bf16*>(a.k);
  const bf16* vg = static_cast<const bf16*>(a.v);

  for (int i = tid; i < kMaxG * CPR; i += kThreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r < w.G;                 // rows past the group: zeros
    cp_async16(qs + r * L::kLd + c, q + w.q0 + (ok ? r * D + c : 0), ok ? 16 : 0);
  }
  // this warp's keys [k0, k0 + 16) of tile t; none when wholly outside [lo, hi)
  auto chunk_at = [&](int t) { return t * kTile + warp * kChunk; };
  auto live = [&](int k0) { return k0 < w.hi && k0 + kChunk > w.lo; };
  auto load_chunk = [&](int t, int st) {
    const int k0 = chunk_at(t);
    if (!live(k0)) return;
    bf16* ks = ring + st * L::kStage;
    bf16* vs = ks + kChunk * L::kLd;
#pragma unroll
    for (int i = lane; i < kChunk * CPR; i += 32) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const int j = k0 + r;
      const bool ok = j < w.hi;              // rows past the live keys: zeros
      const size_t off = ok ? kv_offset<D>(a, w.b, w.kvh, j) + c : 0;
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
  constexpr bool kQRegs = D <= 128;          // else Q fragments come from smem
  uint32_t qf[kQRegs ? D / 16 : 1][4];
  const bool capped = a.softcap > 0.f;
  const float s_mul = capped ? a.scale / a.softcap : a.scale * kLog2e;
  const float cap_mul = a.softcap * kLog2e;

  load_chunk(w.t_begin, 0);
  cp_async_commit();
  for (int it = 0; it < nt; ++it) {
    const int st = it & 1;
    if (it + 1 < nt) load_chunk(w.t_begin + it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                      // this warp's chunk `it` (and Q) landed
    if (it == 0) {
      __syncthreads();                       // Q, copied by every thread
#pragma unroll
      for (int kk = 0; kk < (kQRegs ? D / 16 : 0); ++kk)
        ldmatrix_x4(qf[kk], qs + (lane & 15) * L::kLd + kk * 16 + (lane >> 4) * 8);
    } else {
      __syncwarp();
    }
    const int k0 = chunk_at(w.t_begin + it);
    if (live(k0)) {
      const bf16* ks = ring + st * L::kStage;
      const bf16* vs = ks + kChunk * L::kLd;
      // S = Q K^T over the head dim, even and odd k-steps in separate
      // accumulators (two chains of D/32 products instead of one of D/16)
      float s[2][4], s2[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4], qt[4];
        if (!kQRegs) ldmatrix_x4(qt, qs + (lane & 15) * L::kLd + kk * 16 + (lane >> 4) * 8);
        const uint32_t(&qa)[4] = kQRegs ? qf[kQRegs ? kk : 0] : qt;
        ldmatrix_x4(bk, ks + ((lane & 7) + ((lane >> 4) << 3)) * L::kLd + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(kk & 1 ? s2[0] : s[0], qa, bk[0], bk[1]);
        mma_bf16(kk & 1 ? s2[1] : s[1], qa, bk[2], bk[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];

      // scores in log2 units (softcapped first); keys outside [lo, hi) kNegInf
      const bool clear = k0 >= w.lo && k0 + kChunk <= w.hi;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * s_mul;
          if (capped) x = cap_mul * tanhf(x);
          if (!clear) {
            const int kp = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
            if (kp < w.lo || kp >= w.hi) x = kNegInf;
          }
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
      for (int j = 0; j < 2; ++j)
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

      // O += P V: the score accumulators of the warp's 16 keys are one A
      // fragment, entered as bf16 hi + lo halves (two products)
      uint32_t ph[4], pl[4];
      split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
      split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
      split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
      split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (lane & 15) * L::kLd + n * 8 + (lane >> 4) * 8);
        mma_bf16(o[n], ph, bv[0], bv[1]);
        mma_bf16(o[n], pl, bv[0], bv[1]);
        mma_bf16(o[n + 1], ph, bv[2], bv[3]);
        mma_bf16(o[n + 1], pl, bv[2], bv[3]);
      }
    }
    __syncwarp();                            // stage st is free for chunk it + 2
  }

  // merge the 4 warps' (m, l, acc) through shared memory, once
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __syncthreads();                           // every warp is done with the ring
  float* mo = reinterpret_cast<float*>(smem_raw);        // [warp][kMaxG][kLdm]
  float* mml = mo + kWarps * kMaxG * L::kLdm;             // [warp][kMaxG]: (m, l)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = (lane >> 2) + 8 * h;
    if (r >= w.G) continue;
    float* row = mo + (warp * kMaxG + r) * L::kLdm + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<float2*>(row + n * 8) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
    if ((lane & 3) == 0)
      *reinterpret_cast<float2*>(mml + (warp * kMaxG + r) * 2) = make_float2(m[h], l[h]);
  }
  __syncthreads();
  for (int i = tid; i < w.G * (D / 4); i += kThreads) {
    const int g = i / (D / 4), c = (i % (D / 4)) * 4;
    float2 wml[kWarps];
    float M = kNegInf, Ls = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) {
      wml[wp] = *reinterpret_cast<const float2*>(mml + (wp * kMaxG + g) * 2);
      M = fmaxf(M, wml[wp].x);
    }
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) {
      const float f = exp2f(wml[wp].x - M);
      const float4 x = *reinterpret_cast<const float4*>(mo + (wp * kMaxG + g) * L::kLdm + c);
      Ls += f * wml[wp].y;
      A.x += f * x.x;
      A.y += f * x.y;
      A.z += f * x.z;
      A.w += f * x.w;
    }
    if (w.slot < 0) {
      const float inv = 1.f / fmaxf(Ls, 1e-30f);
      const __nv_bfloat162 v[2] = {__floats2bfloat162_rn(A.x * inv, A.y * inv),
                                   __floats2bfloat162_rn(A.z * inv, A.w * inv)};
      *reinterpret_cast<uint2*>(static_cast<bf16*>(a.out) + w.q0 + (size_t)g * D + c) =
          *reinterpret_cast<const uint2*>(v);
    } else {
      const size_t r = (size_t)w.slot * w.G + g;
      *reinterpret_cast<float4*>(a.part_acc + r * D + c) = A;
      if (c == 0) *reinterpret_cast<float2*>(a.part_ml + r * 2) = make_float2(M * kLn2, Ls);
    }
  }
  if (w.slot >= 0) combine_if_last<bf16, D>(a, w);
}

// --------------------------------------------------------------------------
// f32: CUDA cores
// --------------------------------------------------------------------------
constexpr int kSub = 32;      // keys per f32 sub-tile

template <int D>
constexpr size_t simt_smem_bytes() {
  return sizeof(float) * ((size_t)kMaxG * D + (size_t)kSub * (D + 1) + (size_t)kSub * D +
                          (size_t)kMaxG * kSub + 3 * kMaxG);
}

// Per 32-key sub-tile: the block stores K (rows padded, no bank conflicts)
// and V in shared memory; warp w scores query heads w, w + 4, ... (lane =
// key) and updates their (m, l) with shuffles; then thread t accumulates
// columns t % CW (+ CW) of its heads.  The keys are exactly [lo, hi) of the
// item's tiles, so nothing is masked.
template <int D>
__global__ void __launch_bounds__(kThreads) decode_split_simt_kernel(const Args a) {
  constexpr int CW = D < kThreads ? D : kThreads;   // threads across a row
  constexpr int CPT = D / CW;               // columns per thread: 2 at D 256
  constexpr int RG = kThreads / CW;         // heads sharing a column: 1 or 2 groups
  constexpr int RPT = kMaxG / RG;           // heads per thread
  static_assert(D % CW == 0, "columns must split evenly");
  Work w;
  if (!find_work<D>(a, w)) return;
  const float* q = static_cast<const float*>(a.q);
  const float* kg = static_cast<const float*>(a.k);
  const float* vg = static_cast<const float*>(a.v);
  const int tid = threadIdx.x, lane = tid & 31;
  const int k_begin = max(w.t_begin * kTile, w.lo);
  const int k_end = min(w.t_end * kTile, w.hi);
  if (k_begin >= k_end) {                   // an idle (lane, KV head): zeros
    for (int i = tid; i < w.G * D; i += kThreads) static_cast<float*>(a.out)[w.q0 + i] = 0.f;
    return;
  }
  extern __shared__ float smem[];
  float* Qs = smem;                         // [kMaxG][D]
  float* Ks = Qs + kMaxG * D;               // [kSub][D+1]
  float* Vs = Ks + kSub * (D + 1);          // [kSub][D]
  float* Ps = Vs + kSub * D;                // [kMaxG][kSub]
  float* ms = Ps + kMaxG * kSub;            // [kMaxG]
  float* ls = ms + kMaxG;
  float* als = ls + kMaxG;
  for (int i = tid; i < w.G * D; i += kThreads) Qs[i] = q[w.q0 + i];
  if (tid < w.G) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  const int col = tid % CW, g0 = tid / CW;  // g0 == RG: no column (D 112)
  float acc[CPT][RPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int k = 0; k < RPT; ++k) acc[c][k] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += kSub) {
    const int nk = min(kSub, k_end - kt);
    __syncthreads();                        // the previous sub-tile is consumed
    for (int i = tid; i < kSub * (D / 4); i += kThreads) {
      const int c = i / (D / 4), d = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (c < nk) {
        const size_t off = kv_offset<D>(a, w.b, w.kvh, kt + c) + d;
        kv = __ldg(reinterpret_cast<const float4*>(kg + off));
        vv = __ldg(reinterpret_cast<const float4*>(vg + off));
      }
      float* kr = Ks + c * (D + 1) + d;
      kr[0] = kv.x;
      kr[1] = kv.y;
      kr[2] = kv.z;
      kr[3] = kv.w;
      *reinterpret_cast<float4*>(Vs + c * D + d) = vv;
    }
    __syncthreads();
    for (int g = tid >> 5; g < w.G; g += kWarps) {
      const float* qr = Qs + g * D;
      const float* kr = Ks + lane * (D + 1);
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      const bool ok = lane < nk;
      float x = s * a.scale;
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      x = ok ? x : kNegInf;
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = ok ? expf(x - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      Ps[g * kSub + lane] = p;
      if (lane == 0) {
        const float al = expf(m_old - m_new);
        ls[g] = ls[g] * al + sum;
        ms[g] = m_new;
        als[g] = al;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int g = g0 + k * RG;
      if (g0 >= RG || g >= w.G) break;
      const float* pr = Ps + g * kSub;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        float s = acc[cc][k] * als[g];
        for (int c = 0; c < nk; ++c) s = fmaf(pr[c], Vs[c * D + col + cc * CW], s);
        acc[cc][k] = s;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int g = g0 + k * RG;
    if (g0 >= RG || g >= w.G) break;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      finish<D>(a, w, g, col + cc * CW, acc[cc][k], ms[g], ls[g]);
  }
  if (w.slot >= 0) combine_if_last<float, D>(a, w);
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
  if constexpr (std::is_same<T, bf16>::value) kernel = decode_split_tc_kernel<D>;
  else kernel = decode_split_simt_kernel<D>;
  static bool smem_set[repro::kMaxDevices] = {};
  const cudaError_t set = repro::allow_smem(smem_set, (const void*)kernel, smem);
  if (set != cudaSuccess) return set;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const Args& a, int grid, cudaStream_t stream) {
  if (D == 64) return launch<T, 64>(a, grid, stream);
  if (D == 112) return launch<T, 112>(a, grid, stream);
  if (D == 128) return launch<T, 128>(a, grid, stream);
  if (D == 256) return launch<T, 256>(a, grid, stream);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(int dtype, int D, const Args& a, int grid, cudaStream_t stream) {
  if (a.Hkv <= 0 || a.H % a.Hkv || a.H / a.Hkv > kMaxG) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_d<float>(D, a, grid, stream);
  if (dtype == 1) return dispatch_d<bf16>(D, a, grid, stream);
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* ptab,
               const void* kv_len, void* out, void* part_acc, void* part_ml,
               void* counters, int B, int H,
               int Hkv, int page_shift, int n_ptab, int Sk, int window, float scale,
               float softcap, int target, int n_cap) {
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
  a.H = H;
  a.Hkv = Hkv;
  a.page_shift = page_shift;
  a.n_ptab = n_ptab;
  a.Sk = Sk;
  a.window = window;
  a.target = target;
  a.n_cap = n_cap;
  a.scale = scale;
  a.softcap = softcap;
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {64, 112, 128, 256}; H / Hkv <= 16.
// q (B, H, D); kp, vp (P, 2^page_shift, Hkv, D) page pools; ptab (B, n_ptab)
// int32; kv_len (B,) int32.  window <= 0: none; softcap <= 0: none.
// grid = target + Hkv * B
// work items; n_cap bounds a lane's splits (1: no split); when n_cap > 1,
// part_acc / part_ml hold grid items of G rows and counters B * Hkv ints,
// zero before the launch and after it (else all three are unused).
// Launches on `stream` only; returns cudaGetLastError() after the launch.
extern "C" int paged_flash_decode(int dtype, const void* q, const void* kp, const void* vp,
                                  const void* ptab, const void* kv_len, void* out,
                                  void* part_acc, void* part_ml, void* counters, int B,
                                  int H, int Hkv,
                                  int D, int page_shift, int n_ptab, int window,
                                  float scale, float softcap, int target, int n_cap,
                                  int grid, void* stream) {
  const Args a = make_args(q, kp, vp, ptab, kv_len, out, part_acc, part_ml, counters, B, H,
                           Hkv, page_shift, n_ptab, n_ptab << page_shift, window, scale,
                           softcap, target, n_cap);
  return dispatch(dtype, D, a, grid, static_cast<cudaStream_t>(stream));
}

// The same over a contiguous cache k, v (B, S, Hkv, D), kv_len <= S; no
// window.
extern "C" int flash_decode(int dtype, const void* q, const void* k, const void* v,
                            const void* kv_len, void* out, void* part_acc, void* part_ml,
                            void* counters, int B, int H, int Hkv, int D, int S,
                            float scale, float softcap, int target,
                            int n_cap, int grid, void* stream) {
  const Args a = make_args(q, k, v, nullptr, kv_len, out, part_acc, part_ml, counters, B, H,
                           Hkv, 0, 0, S, -1, scale, softcap, target, n_cap);
  return dispatch(dtype, D, a, grid, static_cast<cudaStream_t>(stream));
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

extern "C" int flash_decode_smem_bytes(int dtype, int D) {
  return dtype == 0 ? smem_of<float>(D) : dtype == 1 ? smem_of<bf16>(D) : 0;
}
