// Helpers shared by the port's hand-written CUDA kernels.
//
// Every kernel is built on its own with nvcc into a shared library with a
// plain C interface (see kernels/native.py) and loaded with ctypes, so no
// source includes PyTorch's headers.  A launcher returns the CUDA error
// code of its launch (0 = cudaSuccess) and the Python wrapper raises on
// anything else.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace rt {

// finite mask value, as in the reference (a fully masked row averages
// instead of turning into NaN)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace rt

// one error-string export per library, so the wrapper can name the error
#define RT_EXPORT_ERROR_STRING(prefix)                                   \
  extern "C" const char* prefix##_error_string(int err) {                \
    return cudaGetErrorString(static_cast<cudaError_t>(err));            \
  }
