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

}  // namespace repro

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
