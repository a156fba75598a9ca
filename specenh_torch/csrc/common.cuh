// Shared helpers of the specenh_torch CUDA libraries (plain C interface,
// loaded with ctypes by specenh_torch/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Activation dtypes, as the Python wrappers pass them.
enum SxDtype : int { SX_F32 = 0, SX_BF16 = 1 };

extern "C" const char* specenh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float sx_load(const float* p) { return *p; }
__device__ __forceinline__ float sx_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ T sx_cast(float v);
template <> __device__ __forceinline__ float sx_cast<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 sx_cast<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float to T's precision and back: the input cast of a stage.
template <typename T> __device__ __forceinline__ float sx_round(float v) {
  T t = sx_cast<T>(v);
  return sx_load(&t);
}

// 16 bytes from global to shared memory, asynchronously (cp.async.cg: L2
// only); zeros where !full.  Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait for every committed group of this thread's cp.async copies.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
