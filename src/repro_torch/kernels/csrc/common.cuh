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
#include <type_traits>

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

// ---------------------------------------------------------------------------
// Warp-level tensor-core products (mma.sync), used by the scans.
//
// warp_mma<BF16, NT>(acc, k0, k1, a, b) adds A (16 x [k0,k1)) . B ([k0,k1) x
// 8 NT) to one warp's fp32 accumulators: a(r, k) gives A's element at row r
// (0..15) and column k, b(k, n) B's at row k and column n (0..8 NT).  With
// BF16 the operands are rounded to bf16 (m16n8k16, exact for values that
// are bf16 already; k1 - k0 a multiple of 16), else to TF32 (m16n8k8, 10
// mantissa bits; a multiple of 8).  The accumulator layout is mma.sync's:
// with g = lane / 4 and q = lane % 4, acc[j][0..1] hold row g, columns
// 8j + 2q and 8j + 2q + 1, and acc[j][2..3] the same columns of row g + 8.
// The functors are inlined; each element of A is fetched once per k step
// and reused across the NT column tiles; the k loop is unrolled so the next
// steps' fragment loads overlap this step's products.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A pair of bf16 values from shared memory as one mma.sync operand register
// (4-byte aligned; the lower index in the low half).
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// The B operand of one m16n8k16 product, rows k0..k0+15 and columns n0..n0+7
// of a row-major bf16 tile (rows 16-byte aligned): lanes 0-15 each give the
// address of row k0 + lane at column n0; ldmatrix transposes the two 8 x 8
// halves into the fragment.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1, const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(a));
}
// x as the sum of two bf16 values, hi = bf16(x) and lo = bf16(x - hi): 16 of
// fp32's 24 mantissa bits, for bf16 products of an fp32 operand.
__device__ __forceinline__ void split_bf16(float x0, float x1, __nv_bfloat162& hi,
                                           __nv_bfloat162& lo) {
  hi = __floats2bfloat162_rn(x0, x1);
  const float2 h = __bfloat1622float2(hi);
  lo = __floats2bfloat162_rn(x0 - h.x, x1 - h.y);
}

template <bool BF16, int NT, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], int k0, int k1, FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  if constexpr (BF16) {
#pragma unroll 2
    for (int k = k0; k < k1; k += 16) {
      const int c = k + 2 * q;
      const uint32_t af[4] = {pack_bf16(a(g, c), a(g, c + 1)), pack_bf16(a(g + 8, c), a(g + 8, c + 1)),
                              pack_bf16(a(g, c + 8), a(g, c + 9)),
                              pack_bf16(a(g + 8, c + 8), a(g + 8, c + 9))};
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_bf16(acc[j], af, pack_bf16(b(c, 8 * j + g), b(c + 1, 8 * j + g)),
                 pack_bf16(b(c + 8, 8 * j + g), b(c + 9, 8 * j + g)));
    }
  } else {
#pragma unroll 4
    for (int k = k0; k < k1; k += 8) {
      const int c = k + q;
      const uint32_t af[4] = {to_tf32(a(g, c)), to_tf32(a(g + 8, c)), to_tf32(a(g, c + 4)),
                              to_tf32(a(g + 8, c + 4))};
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_tf32(acc[j], af, to_tf32(b(c, 8 * j + g)), to_tf32(b(c + 4, 8 * j + g)));
    }
  }
}

// ---------------------------------------------------------------------------
// The backward kernels' products, over warp_mma's fragment layout.
// ---------------------------------------------------------------------------
// acc += A (16 x [k0,k1)) . B ([k0,k1) x 8 NT) by fp32 FMAs, in mma.sync's
// accumulator layout (warp_mma above): acc[j][0..1] row g, columns
// 8j + 2q and 8j + 2q + 1; acc[j][2..3] row g + 8.
template <int NT, class FA, class FB>
__device__ __forceinline__ void warp_fma(float (&acc)[NT][4], int k0, int k1, FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float a0 = a(g, k), a1 = a(g + 8, k);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = b(k, 8 * j + 2 * q), b1 = b(k, 8 * j + 2 * q + 1);
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
}

// One warp's product of bf16 values (bf16 inputs: mma.sync with bf16
// operands and fp32 sums, exact products), or of fp32 inputs by FMAs.  k0
// and k1 are multiples of 16.
template <typename E, int NT, class FA, class FB>
__device__ __forceinline__ void prod(float (&acc)[NT][4], int k0, int k1, FA a, FB b) {
  if constexpr (std::is_same<E, float>::value)
    warp_fma<NT>(acc, k0, k1, a, b);
  else
    warp_mma<true, NT>(acc, k0, k1, a, b);
}

__device__ __forceinline__ float bf_hi(float v) { return __bfloat162float(__float2bfloat16(v)); }

// The same with A (SPLIT_A) or B an fp32 operand: with bf16 inputs it
// enters as two bf16 halves, hi = bf16(v) and lo = bf16(v - hi) (16 of
// fp32's 24 bits, a relative error below 2^-17), two products; the other
// operand is bf16 already.  With fp32 inputs, one FMA product.
template <typename E, bool SPLIT_A, int NT, class FA, class FB>
__device__ __forceinline__ void prod_split(float (&acc)[NT][4], int k0, int k1, FA a, FB b) {
  if constexpr (std::is_same<E, float>::value) {
    warp_fma<NT>(acc, k0, k1, a, b);
  } else if constexpr (SPLIT_A) {
    warp_mma<true, NT>(acc, k0, k1, [&](int r, int k) { return bf_hi(a(r, k)); }, b);
    warp_mma<true, NT>(
        acc, k0, k1, [&](int r, int k) { const float v = a(r, k); return v - bf_hi(v); }, b);
  } else {
    warp_mma<true, NT>(acc, k0, k1, a, [&](int k, int n) { return bf_hi(b(k, n)); });
    warp_mma<true, NT>(
        acc, k0, k1, a, [&](int k, int n) { const float v = b(k, n); return v - bf_hi(v); });
  }
}

// The sums over the four lanes of a fragment row (lanes 4g .. 4g + 3), in
// a fixed order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Shared-memory row strides that keep the fragment reads above free of bank
// conflicts and rows 16-byte aligned for cp.async.  fp32 tiles read as
// A[g][q] (eight rows, four columns: every fp32 tile whose rows a fragment
// indexes by g) take 4 words of padding after a multiple of 32; bf16 tiles
// take a multiple of 16 elements plus 8 (an odd multiple of 4 words), which
// serves A[g][q] and A[q][g] alike.
__host__ __device__ constexpr int stride_gq(int w) { return (w + 31) / 32 * 32 + 4; }
__host__ __device__ constexpr int stride_bf16(int w) { return (w + 15) / 16 * 16 + 8; }

// Inclusive prefix sum of v[0..T) in shared memory, by one warp: each lane
// sums T/32 consecutive values, then the lanes' totals are scanned.
template <int T>
__device__ __forceinline__ void warp_cumsum(float* v) {
  static_assert(T % 32 == 0, "T must be a multiple of 32");
  constexpr int E = T / 32;
  const int lane = threadIdx.x & 31;
  float loc[E], run = 0.f;
#pragma unroll
  for (int i = 0; i < E; ++i) loc[i] = run += v[lane * E + i];
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  const float base = incl - run;
#pragma unroll
  for (int i = 0; i < E; ++i) v[lane * E + i] = base + loc[i];
}

// 4-byte asynchronous copy global -> shared (cp.async, cache-all), zero-
// filled when src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(src_bytes)
               : "memory");
}

// Stage an R x C tile of E (bf16 or fp32) in shared memory, by the whole
// block: dst[r * ds + j] = src[r * rs + j] for r < rows, j < cols, and 0 for
// the rest.  With `vec` (C, cols, ds and rs multiples of 16 bytes' worth of
// E, src and dst 16-byte aligned) every piece is a 16-byte cp.async, all in
// flight together (the caller commits and waits); otherwise plain loads.
// Plain loads in a loop wait out the memory latency one by one: the store
// to shared memory through a generic pointer keeps the compiler from
// hoisting the next load.
template <typename E>
__device__ __forceinline__ void stage_async(E* dst, int ds, const E* src, size_t rs, int rows,
                                            int cols, int R, int C, bool vec) {
  constexpr int V = 16 / static_cast<int>(sizeof(E));
  const int nt = blockDim.x;
  if (vec) {
    const int cv = C / V;
    for (int e = threadIdx.x; e < R * cv; e += nt) {
      const int r = e / cv, j = (e % cv) * V;
      const bool ok = r < rows && j < cols;
      cp_async16(dst + r * ds + j, ok ? src + r * rs + j : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < R * C; e += nt) {
      const int r = e / C, j = e % C;
      dst[r * ds + j] = (r < rows && j < cols) ? src[r * rs + j] : E{};
    }
  }
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes` where it is lower
// than that on the current device (the attribute belongs to the function on
// a device), tracking the largest limit set so far per device.
template <typename Kernel>
inline cudaError_t smem_at_least(Kernel* kernel, int bytes, std::atomic<int> (&set)[32]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>& cur = set[dev & 31];
  if (cur.load(std::memory_order_acquire) >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    int prev = cur.load(std::memory_order_relaxed);
    while (prev < bytes && !cur.compare_exchange_weak(prev, bytes, std::memory_order_release)) {
    }
  }
  return err;
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
