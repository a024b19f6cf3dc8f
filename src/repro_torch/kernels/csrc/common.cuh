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

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace rt {

// finite mask value, as in the reference (a fully masked row averages
// instead of turning into NaN)
constexpr float kNegInf = -1e30f;
// log2(e): scores are scaled into the log2 domain and exponentiated with exp2
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16-byte asynchronous copy global -> shared (cp.async, cache-global): the
// bytes past `src_bytes` (0 or 16 here) are zero-filled and never read, so a
// masked row costs no memory traffic.  Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes`, once per device
// per process (the attribute belongs to the function on the current device),
// not on every launch.
template <typename Kernel>
inline cudaError_t smem_limit_once(Kernel* kernel, int bytes, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace rt

// one error-string export per library, so the wrapper can name the error
#define RT_EXPORT_ERROR_STRING(prefix)                                   \
  extern "C" const char* prefix##_error_string(int err) {                \
    return cudaGetErrorString(static_cast<cudaError_t>(err));            \
  }
