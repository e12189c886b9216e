// Shared device helpers of the port's CUDA kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float kNegInf = -1073741824.0f;   // -2^30, the TPU kernels' NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void put(__half* p, float v) { *p = __float2half(v); }

// Eight consecutive elements fetched with 16-byte loads (the caller keeps
// the address 16-byte aligned), held raw in registers until unpacked to f32.
// Fetching a whole tile into Pack8 registers before storing any of it keeps
// all of its loads in flight at once.  store() packs eight f32 values and
// writes them with 16-byte stores.
template <typename T>
struct Pack8;

__device__ __forceinline__ float2 to_f2(__nv_bfloat162 h) { return __bfloat1622float2(h); }
__device__ __forceinline__ float2 to_f2(__half2 h) { return __half22float2(h); }
__device__ __forceinline__ void from_f2(__nv_bfloat162* h, float2 f) { *h = __float22bfloat162_rn(f); }
__device__ __forceinline__ void from_f2(__half2* h, float2 f) { *h = __float22half2_rn(f); }

// bf16 and f16: one uint4 of four 2-element pairs T2.
template <typename T, typename T2>
struct Pack8Half {
  uint4 u;
  __device__ __forceinline__ void load(const T* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void unpack(float* o) const {
    const T2* h = reinterpret_cast<const T2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = to_f2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(T* p, const float* v) {
    uint4 w;
    T2* h = reinterpret_cast<T2*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) from_f2(h + i, make_float2(v[2 * i], v[2 * i + 1]));
    *reinterpret_cast<uint4*>(p) = w;
  }
};

template <>
struct Pack8<__nv_bfloat16> : Pack8Half<__nv_bfloat16, __nv_bfloat162> {};
template <>
struct Pack8<__half> : Pack8Half<__half, __half2> {};

template <>
struct Pack8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void unpack(float* o) const {
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// --- Tensor-core building blocks (sm_80+ PTX, used on sm_90a) ------------ //

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy, L1 bypassed; src_bytes = 0 writes zeros
// (src is then not read but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// 4-byte global -> shared copy through L1 (cp.async.cg takes 16 bytes only);
// src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
// Fragments: a[0..3] hold rows (lane/4, lane/4 + 8) x columns
// (2(lane%4) + {0,1}, + 8); b0/b1 rows 2(lane%4) + {0,1} (+ 8) of column
// lane/4; d[0..1] row lane/4, d[2..3] row lane/4 + 8, columns 2(lane%4) + {0,1}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (a, b) as bf16x2 hi plus bf16x2 lo = (a, b) - hi, first value in the low
// half: P enters P.V as two products and keeps ~16 bits.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// --- The split plan over live key tiles (flash attention and decode) ------ //
//
// A launch covers B lanes; lane b holds kv_len[b] keys and its Sq queries
// sit at positions kv_len[b] - Sq .. kv_len[b] - 1.  T_b is the number of
// 64-key tiles holding a key that some query of the lane may see (below
// min(kv_len, Sk); with a window, not wholly below the first query's
// reach).  With `pairs` (row block, KV head) pairs per lane:
//   per = max(min_per, ceil(pairs * sum_b T_b / target), ceil(max_b T_b / n_cap))
//         tiles per split (min_per 1 but for flash attention's key split),
//   n_b = ceil(T_b / per) splits for each pair of lane b (so at most n_cap;
//         n_cap = 1: no split, n_b = min(T_b, 1)),
// and a split takes an even share, ceil(T_b / n_b) <= per tiles, of its
// pair's.  Under kAttention (flash attention), per then rises until the
// items with tiles, pairs * sum_b n_b, fit target, where pairs * (busy
// lanes) does.
// Work items are numbered lane by lane, then pair, then split; a pair of an
// idle lane (T_b = 0) still gets one item, which writes its zeros.  So a
// launch has at most target + pairs * B items, the host's grid; blocks past
// the last item exit at once.  Every block computes the plan from kv_len on
// the card: no length crosses to the host.  kernels/split_plan.py mirrors
// it on the host.

constexpr int kPlanTile = 64;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ int tiles_of(int lo, int hi) {
  return hi > lo ? cdiv(hi, kPlanTile) - lo / kPlanTile : 0;
}

struct Plan {
  const int* kv_len;
  int B, Sq, Sk, window;    // window <= 0: none
  int pairs, target, n_cap;
  int min_per = 1;          // fewest tiles a split takes (kAttention: flash attention's key
                            // split sets 2)
};

// Keys [lo, hi) that some query of a lane with kv_len = len may see.
__device__ __forceinline__ void lane_keys(const Plan& p, int len, int& lo, int& hi) {
  hi = min(len, p.Sk);
  lo = p.window > 0 ? max(0, len - p.Sq - p.window + 1) : 0;
}

__device__ __forceinline__ int lane_tiles(const Plan& p, int len) {
  int lo, hi;
  lane_keys(p, len, lo, hi);
  return tiles_of(lo, hi);
}

// The functions below are computed by a whole warp (every lane calls them
// together, with the same arguments, and gets the same answer): lane i
// reads the lengths of lanes i, i + 32, ..., and shuffles combine them, so
// the plan costs one round of loads however many lanes there are.

// kAttention (flash attention): per is at least p.min_per; and ceil(T_b /
// per) rounds up per lane, so the items with tiles can pass target (a
// second, short wave): per then rises until they fit, if one item per busy
// lane and pair fits at all.  The decode kernels keep min_per 1, one pass.
template <bool kAttention = false>
__device__ __forceinline__ int plan_per(const Plan& p) {
  long long w = 0;
  int most = 0, busy = 0;
  for (int i = threadIdx.x & 31; i < p.B; i += 32) {
    const int t = lane_tiles(p, __ldg(p.kv_len + i));
    w += t;
    most = max(most, t);
    if constexpr (kAttention) busy += t > 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    w += __shfl_xor_sync(0xffffffffu, w, o);
    most = max(most, __shfl_xor_sync(0xffffffffu, most, o));
    if constexpr (kAttention) busy += __shfl_xor_sync(0xffffffffu, busy, o);
  }
  w *= p.pairs;
  const long long least = kAttention ? p.min_per : 1;
  int per = (int)max(max(least, (w + p.target - 1) / p.target), (long long)cdiv(most, p.n_cap));
  if constexpr (kAttention) {
    if (p.pairs * busy <= p.target) {
      for (; per < most; ++per) {
        int n = 0;
        for (int i = threadIdx.x & 31; i < p.B; i += 32)
          n += cdiv(lane_tiles(p, __ldg(p.kv_len + i)), per);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
        if (p.pairs * n <= p.target) break;
      }
    }
  }
  return per;
}

__device__ __forceinline__ int lane_splits(const Plan& p, int len, int per) {
  return cdiv(lane_tiles(p, len), per);
}

// Work item v: lane b (kv_len len), its pair, split s of the lane's n, and
// slot0, the item of split 0 of this pair (partials are stored by item).
struct PlanItem {
  int b, len, pair, s, n, slot0;
};

// False past the last item.  32 lanes at a time: an inclusive scan of the
// lanes' item counts, and a ballot finds the lane whose items hold v.
template <bool kAttention = false>
__device__ __forceinline__ bool plan_item(const Plan& p, int v, PlanItem& it) {
  const int per = plan_per<kAttention>(p);
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int b0 = 0; b0 < p.B; b0 += 32) {
    const bool in = b0 + lane < p.B;
    const int len = in ? __ldg(p.kv_len + b0 + lane) : 0;
    const int n = lane_splits(p, len, per);
    const int cnt = in ? p.pairs * max(n, 1) : 0;
    int end = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, end, o);
      if (lane >= o) end += t;
    }
    end += base;
    const unsigned hit = __ballot_sync(0xffffffffu, in && v < end);
    if (hit) {
      const int src = __ffs(hit) - 1;
      it.b = b0 + src;
      it.len = __shfl_sync(0xffffffffu, len, src);
      it.n = __shfl_sync(0xffffffffu, n, src);
      const int first = __shfl_sync(0xffffffffu, end - cnt, src);
      const int m = max(it.n, 1);
      it.pair = (v - first) / m;
      it.s = v - first - it.pair * m;
      it.slot0 = first + it.pair * m;
      return true;
    }
    base = __shfl_sync(0xffffffffu, end, 31);
  }
  return false;
}

// Tiles [begin, end) of split s of n over the T tiles from t0 (n <= 1: all).
__device__ __forceinline__ void split_tiles(int t0, int T, int n, int s, int& begin, int& end) {
  if (n <= 1) {
    begin = t0;
    end = t0 + T;
    return;
  }
  const int q = cdiv(T, n);
  begin = t0 + s * q;
  end = min(t0 + T, begin + q);
}

// --- Per-device launch state ---------------------------------------------- //

// Per-device state is kept in arrays of this many devices; callers hold the
// Python GIL.
constexpr int kMaxDevices = 64;

// The current device, or -1 on failure or at kMaxDevices and beyond.
inline int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return -1;
  return dev;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current device.
// The attribute belongs to a device, so it is set once per device: `done`
// is the kernel's own flags, a static array beside its launcher.
inline cudaError_t allow_smem(bool (&done)[kMaxDevices], const void* kernel, size_t bytes) {
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace repro

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
