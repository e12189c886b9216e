// Fused RMSNorm for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py:23
// ::rmsnorm_kernel: y = x * rsqrt(mean(x^2) + eps) * (1 + scale) over the
// last axis, reduced in f32 and written in x's dtype.
//
// Bound: bytes (each element is read once and written once, the (D,) f32
// scale comes from L2; a few operations per element).  At the paths' shapes
// (8 decode rows or a 512-row prefill chunk of 1536, 2048 or 4096) the
// bytes take ~1 us or less at the memory rate, so the kernel's time is
// latency: how many memory round trips one row waits for, and how many
// loads are in flight.  And at the decode shape its cost to the caller is
// the launch: one plain C call through ctypes.
// Design: one 128-thread block per row, so a 512-row chunk is 512 blocks
// of 4 warps and a row's loads are spread over 128 threads.  Every thread
// issues its 16-byte loads of x (Pack8) and of the scale together, keeps up
// to 4 of each in registers (the whole row up to D = 4096), and waits once;
// the sum of squares is reduced with warp shuffles and across the 4 warps
// through shared memory; the same registers are scaled and written with
// 16-byte stores.  A row whose start is not 16-byte aligned (D not a
// multiple of 8) and the tail past the last whole vector go element by
// element.

#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::Pack8;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCached = 4;        // 8-element vectors a thread keeps in registers

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, int D, float eps) {
  __shared__ float partial[kWarps];
  const int t = threadIdx.x;
  const T* xr = x + (size_t)blockIdx.x * D;
  T* yr = out + (size_t)blockIdx.x * D;
  const bool vec = ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(yr) |
                     reinterpret_cast<uintptr_t>(scale)) & 15) == 0;
  const int nv = vec ? D / 8 : 0;          // whole 8-element vectors

  Pack8<T> xs[kCached];
  Pack8<float> ss[kCached];
#pragma unroll
  for (int j = 0; j < kCached; ++j) {
    const int i = t + kThreads * j;
    if (i < nv) {
      xs[j].load(xr + i * 8);
      ss[j].load(scale + i * 8);
    }
  }
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kCached; ++j) {
    if (t + kThreads * j < nv) {
      float f[8];
      xs[j].unpack(f);
#pragma unroll
      for (int e = 0; e < 8; ++e) sq = fmaf(f[e], f[e], sq);
    }
  }
  for (int i = t + kThreads * kCached; i < nv; i += kThreads) {   // rows past the cache
    Pack8<T> p;
    p.load(xr + i * 8);
    float f[8];
    p.unpack(f);
#pragma unroll
    for (int e = 0; e < 8; ++e) sq = fmaf(f[e], f[e], sq);
  }
  for (int i = nv * 8 + t; i < D; i += kThreads) {
    const float f = repro::to_f(xr[i]);
    sq = fmaf(f, f, sq);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if ((t & 31) == 0) partial[t >> 5] = sq;
  __syncthreads();
  sq = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sq += partial[w];
  const float r = rsqrtf(sq / (float)D + eps);

  auto emit = [&](const Pack8<T>& p, const Pack8<float>& s, int i) {
    float f[8], sf[8], y[8];
    p.unpack(f);
    s.unpack(sf);
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = f[e] * r * (1.f + sf[e]);
    Pack8<T>::store(yr + i * 8, y);
  };
#pragma unroll
  for (int j = 0; j < kCached; ++j) {
    const int i = t + kThreads * j;
    if (i < nv) emit(xs[j], ss[j], i);
  }
  for (int i = t + kThreads * kCached; i < nv; i += kThreads) {
    Pack8<T> p;
    Pack8<float> s;
    p.load(xr + i * 8);
    s.load(scale + i * 8);
    emit(p, s, i);
  }
  for (int i = nv * 8 + t; i < D; i += kThreads)
    repro::put(yr + i, repro::to_f(xr[i]) * r * (1.f + scale[i]));
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int rows, int D, float eps,
                   cudaStream_t stream) {
  rmsnorm_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(out), D, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x and out); scale (D,)
// float32; x and out (rows, D) contiguous; rows, D >= 1.  Returns
// cudaGetLastError() after the launch.
extern "C" int rmsnorm(int dtype, const void* x, const void* scale, void* out, int rows,
                       int D, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || D < 1) return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, scale, out, rows, D, eps, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, scale, out, rows, D, eps, st);
  if (dtype == 2) return launch<__half>(x, scale, out, rows, D, eps, st);
  return cudaErrorInvalidValue;
}
