// Hopper warpgroup matrix products (wgmma) on swizzled bf16 tiles in shared
// memory: the parts the flash attention kernels share (flash_attention.cu's
// bf16 forward, flash_attention_bwd.cu's bf16 backward).
//
// A tile holds ROWS rows of DP bf16 columns (DP 16, 32, 64, 128 or 320).  A
// row is cut into sub-rows of RB bytes, one swizzle atom wide (32, 64 or 128
// bytes), and the tile is stored as NSUB sub-tiles [ROWS][RB].  Within each
// 8-row group the 16-byte chunk c of row r sits at chunk c ^ (address bits
// 7+), the layout wgmma's 32/64/128-byte swizzle modes read.  One layout
// serves every operand: read K-major (its DP columns are the product's
// depth) as A or B, or MN-major (its rows are the depth) as B.
//
// Accumulator layout (per warpgroup, as mma.sync's per warp): warp w, lane
// (g = lane/4, t = lane%4) holds rows 16w + g + 8i and columns 8j + 2t + c
// of a 64-row result in register 4j + 2i + c.  The registers of columns
// 16kk .. 16kk + 15, rounded to bf16 in pairs, are the register A operand
// of k-step kk of a product that takes the result as its left factor.
#pragma once

#include "common.cuh"

namespace sm90 {

using bf16 = __nv_bfloat16;

template <int DP> struct Layout {
  static constexpr int RB = DP * 2 < 128 ? DP * 2 : 128;
  static constexpr int NSUB = DP * 2 / RB;
  static constexpr uint32_t MODE = RB == 128 ? 1 : (RB == 64 ? 2 : 3);  // descriptor swizzle
  static constexpr int NV = RB / 2;                  // output columns per sub-tile
};

// byte offset of 16-byte chunk c of row r in a swizzled tile of ROWS rows
template <int DP, int ROWS>
__device__ __forceinline__ uint32_t chunk_offset(int r, int c) {
  constexpr int RB = Layout<DP>::RB, CPS = RB / 16;  // chunks per sub-row
  const uint32_t o = (c / CPS) * ROWS * RB + r * RB + (c % CPS) * 16;
  return o ^ (((o >> 7) & (CPS - 1)) << 4);
}

// Stage rows [r0, r0 + ROWS) of a row-strided bf16 matrix in a swizzled
// tile, by the NT threads of a block; rows at or past n_rows and columns at
// or past D are zero.  VEC: one 16-byte cp.async per chunk (D % 8 == 0,
// aligned source; the caller commits); otherwise plain loads and a 16-byte
// shared store.
template <int DP, int ROWS, bool VEC, int NT>
__device__ __forceinline__ void load_tile(unsigned char* tile, const bf16* src, size_t row_stride,
                                          int r0, int n_rows, int D, int tid) {
  constexpr int CPR = DP / 8;                        // 16-byte chunks per row
#pragma unroll
  for (int e = tid; e < ROWS * CPR; e += NT) {
    const int r = e / CPR, c = e % CPR;
    const bool row_ok = r0 + r < n_rows;
    unsigned char* dst = tile + chunk_offset<DP, ROWS>(r, c);
    if constexpr (VEC) {
      const bool ok = row_ok && c * 8 < D;
      rt::cp_async16(dst, src + (ok ? static_cast<size_t>(r0 + r) * row_stride + c * 8 : 0),
                     ok ? 16 : 0);
    } else {
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      bf16* part = reinterpret_cast<bf16*>(&val);
      if (row_ok) {
        const bf16* row = src + static_cast<size_t>(r0 + r) * row_stride;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (c * 8 + u < D) part[u] = row[c * 8 + u];
      }
      *reinterpret_cast<uint4*>(dst) = val;
    }
  }
}

// wgmma shared-memory matrix descriptor of a swizzled tile: start address,
// the stride between 8-row groups (8 RB bytes) and the swizzle mode.  Every
// operand here spans one swizzle atom in its contiguous dimension (a 16-deep
// K slice of a K-major tile; an NV-column sub-tile of an MN-major one), so
// the other stride is never used; it is set equal.
template <int DP>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t stride = (8 * Layout<DP>::RB) >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (stride << 16) | (stride << 32) |
         (static_cast<uint64_t>(Layout<DP>::MODE) << 62);
}
// the descriptor of the same tile layout at off bytes (a multiple of 16)
// further: only the start address field (bits 0-13) moves, by one 32-bit
// add that never carries out of it (shared memory is under 256 KB), so a
// tile's descriptors cost one base pair of registers and an add each
__device__ __forceinline__ uint64_t desc_at(uint64_t d, uint32_t off) {
  const uint32_t lo = static_cast<uint32_t>(d) + (off >> 4);
  return (d & 0xFFFFFFFF00000000ull) | lo;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N of the warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// make generic-proxy writes to shared memory visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the compiler must not move reads of wgmma results above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x (ex2.approx: ~2 ulp; 0 for the -1e30 masks)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

using rt::pack_bf16;
// the two bf16 values of a packed pair, widened (exact)
__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// D (64 x 32, fp32) (+)= A (64 x 16, shared) * B (16 x 32, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 64, fp32) (+)= A (64 x 16, shared) * B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 16, fp32) += A (64 x 16, registers) * B (16 x 16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, fp32) += A (64 x 16, registers) * B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_rs_k(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, shared, K-major) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// the swizzle acts on shared-memory address bits: tiles start on 1024 bytes
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw, uint32_t& addr) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  const uint32_t shift = (1024 - (s & 1023)) & 1023;
  addr = s + shift;
  return raw + shift;
}

template <int NR>
__device__ __forceinline__ void zero(float (&v)[NR]) {
#pragma unroll
  for (int e = 0; e < NR; ++e) v[e] = 0.f;
}

// x0, x1 as bf16 pairs hi = bf16(x) and lo = bf16(x - hi) (16 mantissa bits)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(x0 - h.x, x1 - h.y);
}

// the hi and lo A fragments (K 64, four k-steps) of a 64 x 64 fp32
// accumulator (the layout above)
__device__ __forceinline__ void frags(const float (&v)[32], uint32_t (&hi)[4][4],
                                      uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) split2(v[8 * kk + 2 * e], v[8 * kk + 2 * e + 1], hi[kk][e], lo[kk][e]);
}

// D (64 x N, fp32) = A B^T over DP columns, both operands K-major: A the 64
// rows at a_addr of a tile of RA rows, B the first N rows of a tile of RBT
// rows at b_addr (N = 2 x the registers of d).  Issued, not fenced, not
// committed.
template <int DP, int RA, int RBT, int NR>
__device__ __forceinline__ void ss_product(float (&d)[NR], uint32_t a_addr, uint32_t b_addr) {
  constexpr int RB = Layout<DP>::RB;
  const uint64_t da = desc<DP>(a_addr), db = desc<DP>(b_addr);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t sub = kk * 32 / RB, off = kk * 32 % RB;
    wgmma_ss(d, desc_at(da, sub * RA * RB + off), desc_at(db, sub * RBT * RB + off), kk > 0);
  }
}

// acc (64 x DP, fp32, NSUB sub-tiles) += A B: A the register fragments of K
// (16 per k-step) rows of the depth, B a tile of RBT rows at b_addr read
// MN-major (its rows are the depth).  Issued, not fenced, not committed.
template <int DP, int RBT, int KS>
__device__ __forceinline__ void rs_product(float (&acc)[Layout<DP>::NSUB][Layout<DP>::NV / 2],
                                           const uint32_t (&a)[KS][4], uint32_t b_addr) {
  using L = Layout<DP>;
  const uint64_t db = desc<DP>(b_addr);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int sb = 0; sb < L::NSUB; ++sb)
      wgmma_rs(acc[sb], a[kk], desc_at(db, sb * RBT * L::RB + kk * 16 * L::RB));
}

}  // namespace sm90
