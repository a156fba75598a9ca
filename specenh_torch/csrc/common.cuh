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
