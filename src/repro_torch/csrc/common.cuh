// Shared helpers of the port's hand-written attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>

// The TPU kernels mask with this finite value instead of -inf, so a row whose
// keys are all masked keeps finite running statistics (exp(0) = 1 is then
// zeroed by the mask) and never produces NaN.
#define REPRO_NEG_INF (-1e30f)

// Element types a wrapper may pass; the codes match the Python side.
enum ReproDtype { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
// Round to nearest even, as PyTorch's float -> bfloat16 cast does.
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One 16-byte global load: 4 floats or 8 bfloat16 values.
template <typename T> struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ uint4 load_vec(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Widen one 16-byte vector of T to fp32 and store it at dst[0 .. N).
__device__ __forceinline__ void store_widened(float* dst, uint4 raw, float) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) dst[j] = f[j];
}
__device__ __forceinline__ void store_widened(float* dst, uint4 raw, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    dst[2 * j] = f.x;
    dst[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 16-byte asynchronous copy from global to shared memory (cp.async, sm_80
// and later); with src_bytes = 0 nothing is read and the 16 bytes are
// zero-filled.  Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

// Wait until every cp.async this thread issued has landed (the block still
// needs a __syncthreads before reading what other threads copied).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Raise a kernel's cap of dynamic shared memory to `bytes` on the current
// device, once a device.  The attribute belongs to a device: a flag kept
// once a process would leave it unset on a second card, whose launch is
// then refused.  `done`, one a kernel instantiation, holds a bit a device
// (a device past the 64th sets it on every launch).  The first launch on
// a device sets it, before any CUDA graph captures that launch.
template <typename Kernel>
inline cudaError_t allow_smem_per_device(Kernel kernel, int bytes,
                                         std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}
