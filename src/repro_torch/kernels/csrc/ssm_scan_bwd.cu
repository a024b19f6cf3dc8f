// Backward of the chunked Mamba2 SSD scan (one B/C group) for Hopper.
//
// Replaces no TPU kernel: the reference has no backward kernel and trains
// zamba2 through jax.grad of its plain chunked form (repro/kernels/ops.py:119,
// ssd_chunked_jnp; jax.value_and_grad at repro/models/steps.py:44).  The port
// trains on the card through its kernels both ways, so the forward
// (ssm_scan.cu) needs this backward.  It computes the gradient of
// (y, h_final) with respect to x, dt, A, B and C for given dy and dh_final
// (null: zero).  Per (batch row, head) and chunk of T = 64 rows, with
// cum = cumsum(A dt) inside the chunk, L[t,s] = exp(cum_t - cum_s) (s <= t),
// h_in the chunk's incoming state and dh_out the gradient of its outgoing
// state (ssm_scan.cu's header states the forward):
//   dh_in = exp(cum_T) dh_out + sum_t exp(cum_t) dy_t outer C_t
//   dx_s  = dt_s U_s,  U = (G o L)^T dy + exp(cum_T - cum) B dh_out^T,  G = C B^T
//   dC    = M B + exp(cum) dy h_in,  dB = M^T C + w x dh_out,
//           M = (dy x^T) o L o dt (per head),  w_s = dt_s exp(cum_T - cum_s)
//   ddt_s = x_s . U_s + A da_s,  dA = sum dt da,
//   da_r  = sum_{t >= r} (rowsum(G o M) - colsum(G o M) + R)_t
//           + sum_{s < r} V_s + exp(cum_T) <dh_out, h_in>,
//           R_t = exp(cum_t) dy_t . (C_t h_in^T),  V_s = w_s x_s . (dh_out B_s):
// da is the gradient of A dt through cum (L, exp(cum) in the read-out, the
// decay exp(cum_T) and the weights w); V enters through w's exponent
// cum_T - cum_s, summed for s < r directly (V_T would otherwise enter
// cum_T and -cum_T and cancel in rounding), and the decay moves every row.
// ref.ssm_scan_bwd_chunked_ref writes the mma.sync passes in torch, and
// ref.ssm_scan_bwd_walk_ref the wgmma passes' order.
//
// Layout: x, dy (B,S,H,P), dt (B,S,H), B/C (B,S,N), all one dtype (bf16 or
// fp32); A (H,) fp32; dh_final (B,H,P,N) fp32 or null; dx, ddt, dB, dC like
// their inputs; dA (H,) fp32.  bf16: P <= 128 and N <= 128, not both past 64
// (the wgmma passes: P 128 with N 64 is zamba2's, P 64 with N 128), and the
// mma.sync passes below for the other widths they take; fp32: N <= 128, P <=
// 256 and the chunk pass's shared memory within 227 KB
// (ssm_scan_bwd_supported).
//
// bf16, the wgmma passes (namespace tc; three launches a call, scratch the
// wrapper allocates, ssm_scan_bwd_scratch floats):
//   1. bwd_walk, grid (2 PP / 64, H, B), one warpgroup: a (row, head, 64 rows of
//      P) block walks the chunks in order for the state h (forward: h_c =
//      exp(cum_T) h_{c-1} + (x o w)^T B, from zero) or in reverse for its
//      gradient (dh_{c-1} = exp(cum_T) dh_c + (dy o exp(cum))^T C, from
//      dh_final).  The running state is a wgmma accumulator; the chunk's
//      term is a register-A product ((x o w)^T as bf16 hi and lo fragments,
//      B read MN-major).  Before each term is added the state is written as
//      the chunk's h_in (dh_out): bf16 hi and lo planes, each the image of
//      the chunk pass's swizzled tile, through shared memory as whole
//      16-byte rows.  A ring of four chunks' tiles (cp.async) loads ahead.
//   2. bwd_groups, grid (ceil(H / HG), chunks, B), two warpgroups: a (row, chunk)
//      and its group of HG = 4 heads in order, the next head's tiles
//      (x, dy, h_in, dh_out: 96 KB at P 128, N 64) loading while one is
//      multiplied (two stages, 223 KB).  G^T = B C^T once a group.  Per
//      head, warpgroup 0 in rows t: dG = dy x^T, M = dG o L o dt, dC's state
//      part dy h_in (h_in MN-major, hi then lo), R, then + M B; warpgroup 1
//      in rows s: dG^T = x dy^T, M^T, Q^T = G^T o M^T summed by row
//      (colsum Q) and column (rowsum Q), dB's state part x dh_out, V, then
//      + M^T C.  Each then a 64-column piece of U = exp(cum_T - cum) B
//      dh_out^T + (G^T o L^T) dy, dx = dt U (through the dy tile, 16-byte
//      rows) and x . U.  The transposed operands come from a second
//      product in the other orientation, so every fp32 operand is a
//      register fragment (hi and lo) and every tile a descriptor (K-major,
//      or MN-major with the transpose bit).  dC (warpgroup 0) and dB (1)
//      are summed over the group's heads in registers, in order; the heads'
//      terms of da wait in shared memory and the group's da scans (a warp a
//      head) run at its end.
//   3. bwd_finish: dB and dC, the groups' sums added in order, and dA, a warp a
//      head over rows and chunks in a fixed order.
// The other design timed against this one (H100 80GB HBM3), the walk
// forward only and the chunk pass walking each head group's chunks in
// reverse with its heads' dh_out in shared memory (no dh_out scratch: 0.13
// GB less state traffic) on B ceil(H / HG) blocks, was 3.0x slower at the
// training shape, 1.2x with groups of one head (which lose the in-block head
// sums) and 3-10x at S 1000 and 4096, and was dropped.
// fp32 (and bf16 past the wgmma passes' widths), the mma.sync passes (four
// launches): bwd_states, bwd_carry (the states and their gradients through
// scratch), bwd_chunk (per (row, chunk, head), eight warps, products on
// mma.sync in bf16 or by fp32 FMAs; dB and dC per head), bwd_finish.
// Every sum runs in a fixed order (no atomics), so two calls on the same
// inputs give bit-equal gradients.  Rows past S enter as dt = 0, x = B =
// C = dy = 0: identity steps, as the forward pads; they take no gradient.
//
// h_in is rerun (the walk) rather than saved by the forward: saving it
// would keep 4 nc H P N bytes a row per layer alive from the forward to
// the backward (67 MB a layer at zamba2's 4 x 1024) and change the
// forward's kernels.
//
// bf16 products take bf16 operands and fp32 sums: G = C B^T and dy x^T are
// exact products of bf16 values.  Every product with an fp32 operand (x o w,
// dy o exp(cum), the states h_in and dh_out, M, G o L) takes that operand
// as two bf16 halves, hi + lo (16 bits, two products), where the forward
// takes TF32 (10 bits): TF32 leaves errors of ~1e-3 of a sum's terms, and a
// row of dC or ddt is a sum whose terms cancel (dC's first row of a chunk,
// where the carried state's term dominates under a weak decay), so its
// error exceeds the rule there.  Row scales (exp(cum), w, exp(cum_T - cum))
// are applied to the fp32 sums after a product, so its other operand stays
// bf16.  fp32 inputs take every product as fp32 FMAs on the CUDA cores
// (warp_fma: mma.sync's fragment layout, so the epilogues are shared),
// because the fp32 gates hold fp32 arithmetic.
//
// Work at zamba2's training shape, x (4,1024,32,128), N 64 (T 64, 16 chunks,
// 2048 (row, chunk, head); a split product counted twice).  FLOPs on wgmma:
// the walks 2 directions x 2 x 2 T P N = 4.2 M a (row, chunk, head), 8.6 G;
// the chunk pass dG and dG^T 2 x 2 T^2 P = 2.1 M, the state parts 2 x 2 x
// 2 T P N = 4.2 M, M B and M^T C 2 x 2 x 2 T^2 N = 2.1 M, U 2 x 2 T N P + 2
// x 2 T^2 P = 4.2 M, G^T 0.26 M a head: 12.9 M, 26.4 G; 35 GFLOP a call.
// Bytes: the walks read x and dy (67.1 MB) and write h_in and dh_out (2 x
// 67.1 MB, 4 bytes an element); the chunk pass reads x, dy, h_in and dh_out
// (201.3 MB) and B, C, dt, writes dx (33.6 MB), ddt, and dB, dC per head
// group (16.8 MB, read again by bwd_finish): ~0.47 GB, of which the states
// 0.27 GB (each written once and read once).  The bound (chip_smoke.py)
// counts the sequential recurrence's backward state work, ~10 P N flops a
// token and head (the forward's 5 P N, twice), 10.7 GFLOP, 0.011 ms at the
// bf16 rate, against the bytes: x, dy, dx (B,S,H,P) bf16, dt, ddt, B, C,
// dB, dC and A, dA once, 0.10 GB, 0.031 ms at 3.35 TB/s; bytes bound it.
// The walks' 16 chunks run in sequence, on B H 2 P / 64 blocks a direction.
#include <algorithm>
#include <type_traits>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::stage_async;
using rt::stride_bf16;
using rt::stride_gq;
using rt::bf_hi;
using rt::prod;
using rt::prod_split;
using rt::quad_sum;
using rt::to_f;
using rt::warp_fma;

constexpr int T = 64;          // chunk rows
constexpr int NTH = 256;       // threads of the two chunk passes (eight warps)
constexpr int CNT = 256;       // threads of the carry pass
constexpr int RED = 256;       // threads of the reduction pass
constexpr int NMAX = 128;      // largest state size N
constexpr int PMAX = 256;      // largest head width P
constexpr int SLOTS = 4;       // column tiles whose row sums the chunk pass keeps apart
constexpr int SMEM_MAX = 232448;
static_assert(T == 64, "the chunk pass's scans give each lane two rows");

__host__ __device__ constexpr int pad16(int w) { return (w + 15) / 16 * 16; }
// row stride of an E tile in shared memory: 16-byte rows, no bank conflicts
// on the fragment reads (common.cuh)
template <typename E>
__host__ __device__ constexpr int tile_stride(int w) {
  return sizeof(E) == 2 ? stride_bf16(w) : stride_gq(w);
}

// acc's rows times scale[r0 + row]
template <int NT>
__device__ __forceinline__ void scale_rows(float (&acc)[NT][4], const float* scale, int r0) {
  const int g = (threadIdx.x & 31) >> 2;
  const float s0 = scale[r0 + g], s1 = scale[r0 + g + 8];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] *= s0;
    acc[j][1] *= s0;
    acc[j][2] *= s1;
    acc[j][3] *= s1;
  }
}


__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename E>
struct BwdArgs {
  const E *x, *dt, *Bm, *Cm, *dy;
  const float* A;
  const float* dhf;   // (B,H,P,N) or null
  E *dx, *ddt, *dB, *dC;
  float* dA;          // (H,)
  float* st;          // (B,nc,H,P,N) own states, then incoming states h_in
  float* sd;          // (B,nc,H,P,N) local state gradients, then dh_out
  float* pb;          // (B,nc,H,T,N) dB per head
  float* pc;          // (B,nc,H,T,N) dC per head
  float* ct;          // (B,nc,H)     cum_T
  float* pa;          // (B,nc,H)     dA per (row, chunk, head)
  __nv_bfloat16* hs;  // bf16 wgmma passes: (B,nc,H) blocks of two [PP][NP] planes, h_in
  __nv_bfloat16* hd;  //   as bf16 hi and lo, and dh_out the same
  int S, H, P, N, nc;
  int parts;          // dB, dC partial sums per (row, chunk): H, or the head groups
  int PP, NP;         // the wgmma passes' padded P and N (64 or 128)
  bool vx, vn, vh;    // x/dy rows, B/C rows, state rows move in 16-byte pieces
};

// dt of the chunk's rows (0 past S) and cum = cumsum(A dt), by the block
// (synchronises), as the forward's chunk_cum
template <typename E>
__device__ __forceinline__ void chunk_cum(const BwdArgs<E>& a, int b, int c, int h, int rows,
                                          float* dts, float* cum) {
  const E* dtb = a.dt + (static_cast<size_t>(b) * a.S + static_cast<size_t>(c) * T) * a.H + h;
  const float ah = a.A[h];
  for (int r = threadIdx.x; r < T; r += blockDim.x) {
    const float d = r < rows ? to_f(dtb[static_cast<size_t>(r) * a.H]) : 0.f;
    dts[r] = d;
    cum[r] = ah * d;
  }
  __syncthreads();
  if (threadIdx.x < 32) rt::warp_cumsum<T>(cum);
  __syncthreads();
}

template <typename E>
size_t states_smem(int P, int N) {
  return sizeof(float) * 4 * T +
         sizeof(E) * T * (2 * tile_stride<E>(pad16(P)) + 2 * tile_stride<E>(pad16(N)));
}

// Pass 1: a head's chunk state S_c = (x o w)^T B and local state gradient
// D_c = (dy o exp(cum))^T C: 16 rows of P x 64 of N a unit, both at once.
template <typename E>
__global__ void __launch_bounds__(NTH) bwd_states(BwdArgs<E> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const int rows = min(T, a.S - c * T), N = a.N, P = a.P;
  const int NP = pad16(N), PP = pad16(P), XS = tile_stride<E>(PP), BS = tile_stride<E>(NP);
  float* dts = reinterpret_cast<float*>(smem);
  float* cum = dts + T;
  float* w = cum + T;
  float* ec = w + T;
  E* xs = reinterpret_cast<E*>(ec + T);          // [T][XS] x rows of head h
  E* dys = xs + T * XS;                           // [T][XS] dy rows of head h
  E* bs = dys + T * XS;                           // [T][BS] B rows
  E* cs = bs + T * BS;                            // [T][BS] C rows
  const size_t row0 = static_cast<size_t>(b) * a.S + static_cast<size_t>(c) * T;
  const size_t xo = row0 * a.H * P + static_cast<size_t>(h) * P, xr = static_cast<size_t>(a.H) * P;
  stage_async(xs, XS, a.x + xo, xr, rows, P, T, PP, a.vx);
  stage_async(dys, XS, a.dy + xo, xr, rows, P, T, PP, a.vx);
  stage_async(bs, BS, a.Bm + row0 * N, N, rows, N, T, NP, a.vn);
  stage_async(cs, BS, a.Cm + row0 * N, N, rows, N, T, NP, a.vn);
  rt::cp_async_commit();
  chunk_cum(a, b, c, h, rows, dts, cum);          // while the tiles arrive
  const float last = cum[T - 1];
  for (int r = threadIdx.x; r < T; r += NTH) {
    w[r] = dts[r] * expf(last - cum[r]);
    ec[r] = expf(cum[r]);
  }
  if (threadIdx.x == 0) a.ct[(static_cast<size_t>(b) * a.nc + c) * a.H + h] = last;
  rt::cp_async_wait<0>();
  __syncthreads();
  const size_t so = ((static_cast<size_t>(b) * a.nc + c) * a.H + h) * P * N;
  const int mt = PP / 16, units = mt * ((N + 63) / 64);
  for (int u = warp; u < 2 * units; u += NTH / 32) {
    const bool grad = u >= units;
    const int v = grad ? u - units : u;
    const int p0 = (v % mt) * 16, n0 = (v / mt) * 64;
    const E* lhs = grad ? dys : xs;
    const E* rhs = grad ? cs : bs;
    const float* wt = grad ? ec : w;
    float acc[8][4] = {};
    prod_split<E, true, 8>(
        acc, 0, T, [&](int r, int k) { return to_f(lhs[k * XS + p0 + r]) * wt[k]; },
        [&](int k, int n) { return n0 + n < NP ? to_f(rhs[k * BS + n0 + n]) : 0.f; });
    float* out = (grad ? a.sd : a.st) + so;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 8 * j + 2 * q;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + g + 8 * (i >> 1), nn = n + (i & 1);
        if (p < P && nn < N) out[static_cast<size_t>(p) * N + nn] = acc[j][i];
      }
    }
  }
}

// Pass 2: the two carries, one thread per V state elements (16-byte pieces
// where P N allows), U chunks' loads in flight at once.
template <int V>
struct Piece {
  float v[V];
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (V == 4) {
      const float4 f = *reinterpret_cast<const float4*>(p);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      v[0] = *p;
    }
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *p = v[0];
  }
};

// Walk the chunks (in reverse with REV), replacing each chunk's term s_c by
// the carry entering it, hv <- exp(cum_T) hv + s_c, as the forward's ssd_carry.
template <int V, bool REV>
__device__ __forceinline__ void carry_walk(float* p, const float* cb, size_t step, int H, int nc,
                                           Piece<V>& hv) {
  constexpr int U = 4;
  for (int k0 = 0; k0 < nc; k0 += U) {
    Piece<V> s[U];
    float d[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int c = REV ? nc - 1 - (k0 + i) : k0 + i;
      if (k0 + i < nc) {
        s[i].load(p + c * step);
        d[i] = cb[c * H];
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int c = REV ? nc - 1 - (k0 + i) : k0 + i;
      if (k0 + i < nc) {
        hv.store(p + c * step);
        const float dec = expf(d[i]);
#pragma unroll
        for (int j = 0; j < V; ++j) hv.v[j] = hv.v[j] * dec + s[i].v[j];
      }
    }
  }
}

template <typename E, int V>
__global__ void __launch_bounds__(CNT) bwd_carry(BwdArgs<E> a) {
  const int PN = a.P * a.N;
  const int e = (blockIdx.x * CNT + threadIdx.x) * V, h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const size_t step = static_cast<size_t>(a.H) * PN;
  const size_t off = (static_cast<size_t>(b) * a.nc * a.H + h) * PN + e;
  const float* cb = a.ct + static_cast<size_t>(b) * a.nc * a.H + h;
  Piece<V> hv;
#pragma unroll
  for (int j = 0; j < V; ++j) hv.v[j] = 0.f;
  carry_walk<V, false>(a.st + off, cb, step, a.H, a.nc, hv);
  if (a.dhf != nullptr) {
    hv.load(a.dhf + (static_cast<size_t>(b) * a.H + h) * PN + e);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) hv.v[j] = 0.f;
  }
  carry_walk<V, true>(a.sd + off, cb, step, a.H, a.nc, hv);
}

// Shared memory of the chunk pass.
template <typename E>
struct ChunkTile {
  int XS, BS, GS, HS;
  float *dts, *cum, *ec, *ef, *w, *rowq, *colp, *pdx, *pr, *pv, *red;
  float *gs, *ms, *his, *dhs;
  E *xs, *dys, *bs, *cs;
  __host__ __device__ ChunkTile(unsigned char* sm, int P, int N) {
    XS = tile_stride<E>(pad16(P));
    BS = tile_stride<E>(pad16(N));
    GS = stride_gq(T);
    HS = stride_gq(pad16(N));
    dts = reinterpret_cast<float*>(sm);
    cum = dts + T;
    ec = cum + T;                  // exp(cum)
    ef = ec + T;                   // exp(cum_T - cum)
    w = ef + T;                    // dt exp(cum_T - cum)
    rowq = w + T;                  // rowsum(G o M)
    colp = rowq + T;               // [8][T] colsum(G o M), a warp's rows each
    pdx = colp + 8 * T;            // [SLOTS][T] x . U by 64-column tiles of P
    pr = pdx + SLOTS * T;          // [SLOTS][T] R by 32-column tiles of N
    pv = pr + SLOTS * T;           // [SLOTS][T] V by 32-column tiles of N
    red = pv + SLOTS * T;          // [8] <dh_out, h_in> by warp, then pad to 16 bytes
    gs = red + 16;                 // [T][GS] G, then G o L (0 above the diagonal)
    ms = gs + T * GS;              // [T][GS] dy x^T, then M
    his = ms + T * GS;             // [PP][HS] h_in
    dhs = his + pad16(P) * HS;     // [PP][HS] dh_out
    xs = reinterpret_cast<E*>(dhs + pad16(P) * HS);   // [T][XS]
    dys = xs + T * XS;             // [T][XS]
    bs = dys + T * XS;             // [T][BS]
    cs = bs + T * BS;              // [T][BS]
  }
  __host__ __device__ size_t bytes() const {
    return reinterpret_cast<const unsigned char*>(cs + T * BS) -
           reinterpret_cast<const unsigned char*>(dts);
  }
};

template <typename E>
size_t chunk_smem(int P, int N) {
  return ChunkTile<E>(nullptr, P, N).bytes();
}

// Pass 3: every term of one (row, chunk, head).
template <typename E>
__global__ void __launch_bounds__(NTH) bwd_chunk(BwdArgs<E> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const int rows = min(T, a.S - c * T), N = a.N, P = a.P;
  const int NP = pad16(N), PP = pad16(P);
  const ChunkTile<E> m(smem, P, N);
  const int XS = m.XS, BS = m.BS, GS = m.GS, HS = m.HS;
  const size_t row0 = static_cast<size_t>(b) * a.S + static_cast<size_t>(c) * T;
  const size_t xo = row0 * a.H * P + static_cast<size_t>(h) * P, xr = static_cast<size_t>(a.H) * P;
  const size_t bch = (static_cast<size_t>(b) * a.nc + c) * a.H + h;
  stage_async(m.xs, XS, a.x + xo, xr, rows, P, T, PP, a.vx);
  stage_async(m.dys, XS, a.dy + xo, xr, rows, P, T, PP, a.vx);
  stage_async(m.bs, BS, a.Bm + row0 * N, N, rows, N, T, NP, a.vn);
  stage_async(m.cs, BS, a.Cm + row0 * N, N, rows, N, T, NP, a.vn);
  stage_async(m.his, HS, a.st + bch * P * N, N, P, N, PP, NP, a.vh);
  stage_async(m.dhs, HS, a.sd + bch * P * N, N, P, N, PP, NP, a.vh);
  rt::cp_async_commit();
  chunk_cum(a, b, c, h, rows, m.dts, m.cum);      // while the tiles arrive
  const float last = m.cum[T - 1];
  for (int r = threadIdx.x; r < T; r += NTH) {
    m.ec[r] = expf(m.cum[r]);
    m.ef[r] = expf(last - m.cum[r]);
    m.w[r] = m.dts[r] * m.ef[r];
  }
  rt::cp_async_wait<0>();
  __syncthreads();

  // G = C B^T and dy x^T (bf16 operands: exact products), the tiles on and
  // below the diagonal: 16 rows x 32 columns a unit
  for (int u = warp; u < 16; u += NTH / 32) {
    const int v = u % 8, r0 = (v % 4) * 16, n0 = (v / 4) * 32;
    if (n0 > r0 + 15) continue;
    float acc[4][4] = {};
    float* out;
    if (u < 8) {
      prod<E, 4>(acc, 0, NP, [&](int r, int k) { return to_f(m.cs[(r0 + r) * BS + k]); },
                       [&](int k, int n) { return to_f(m.bs[(n0 + n) * BS + k]); });
      out = m.gs;
    } else {
      prod<E, 4>(acc, 0, PP, [&](int r, int k) { return to_f(m.dys[(r0 + r) * XS + k]); },
                       [&](int k, int n) { return to_f(m.xs[(n0 + n) * XS + k]); });
      out = m.ms;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        out[(r0 + g + 8 * (i >> 1)) * GS + n0 + 8 * j + 2 * q + (i & 1)] = acc[j][i];
  }
  // the decay's <dh_out, h_in> (padding is zero), a warp's share each
  {
    float d = 0.f;
    for (int e = threadIdx.x; e < PP * NP; e += NTH) {
      const int p = e / NP, n = e % NP;
      d = fmaf(m.dhs[p * HS + n], m.his[p * HS + n], d);
    }
    d = warp_sum(d);
    if (lane == 0) m.red[warp] = d;
  }
  __syncthreads();

  // G o L and M = (dy x^T) o L o dt below the diagonal (the exponent taken
  // only there), zero above; Q = G o M summed by row and by column.  Warp w
  // owns rows w + 8i, a lane columns lane and lane + 32.
  {
    float col[2] = {0.f, 0.f};
    for (int i = 0; i < T / 8; ++i) {
      const int t = warp + 8 * i;
      float rq = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int s = lane + 32 * k;
        float gl = 0.f, mm = 0.f;
        if (s <= t) {
          const float l = expf(m.cum[t] - m.cum[s]);
          const float gv = m.gs[t * GS + s];
          gl = gv * l;
          mm = m.ms[t * GS + s] * l * m.dts[s];
          const float qv = gv * mm;
          rq += qv;
          col[k] += qv;
        }
        m.gs[t * GS + s] = gl;
        m.ms[t * GS + s] = mm;
      }
      rq = warp_sum(rq);
      if (lane == 0) m.rowq[t] = rq;
    }
    m.colp[warp * T + lane] = col[0];
    m.colp[warp * T + lane + 32] = col[1];
  }
  __syncthreads();

  // U (16 rows x 64 columns of P), dC and dB (16 rows x 32 columns of N)
  const int npt = (PP + 63) / 64, nnt = (NP + 31) / 32;
  const int nu = 4 * npt, nd = 4 * nnt;
  E* dxb = a.dx + xo;
  for (int u = warp; u < nu + 2 * nd; u += NTH / 32) {
    if (u < nu) {
      const int r0 = (u % 4) * 16, p0 = (u / 4) * 64;
      float acc[8][4] = {};
      // exp(cum_T - cum) B dh_out^T (the row scale after the product)
      prod_split<E, false, 8>(
          acc, 0, NP, [&](int r, int k) { return to_f(m.bs[(r0 + r) * BS + k]); },
          [&](int k, int n) { return p0 + n < PP ? m.dhs[(p0 + n) * HS + k] : 0.f; });
      scale_rows<8>(acc, m.ef, r0);
      // + (G o L)^T dy over t >= s: G o L is zero above the diagonal
      prod_split<E, true, 8>(
          acc, r0, T, [&](int r, int k) { return m.gs[k * GS + r0 + r]; },
          [&](int k, int n) { return p0 + n < PP ? to_f(m.dys[k * XS + p0 + n]) : 0.f; });
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = r0 + g + 8 * (i >> 1), p = p0 + 8 * j + 2 * q + (i & 1);
          if (p < P) {
            part[i >> 1] = fmaf(to_f(m.xs[s * XS + p]), acc[j][i], part[i >> 1]);
            if (s < rows) dxb[static_cast<size_t>(s) * xr + p] = rt::from_f<E>(m.dts[s] * acc[j][i]);
          }
        }
      part[0] = quad_sum(part[0]);
      part[1] = quad_sum(part[1]);
      if (q == 0) {
        m.pdx[(p0 / 64) * T + r0 + g] = part[0];
        m.pdx[(p0 / 64) * T + r0 + g + 8] = part[1];
      }
      continue;
    }
    const bool is_c = u < nu + nd;
    const int v = u - nu - (is_c ? 0 : nd);
    const int r0 = (v % 4) * 16, n0 = (v / 4) * 32;
    float acc[4][4] = {};
    // the state part first: exp(cum) dy h_in (dC) or w x dh_out (dB), the
    // row scale after the product
    const E* rowt = is_c ? m.dys : m.xs;
    const float* st = is_c ? m.his : m.dhs;
    prod_split<E, false, 4>(
        acc, 0, PP, [&](int r, int k) { return to_f(rowt[(r0 + r) * XS + k]); },
        [&](int k, int n) { return n0 + n < NP ? st[k * HS + n0 + n] : 0.f; });
    scale_rows<4>(acc, is_c ? m.ec : m.w, r0);
    // its product with the row's C (R) or B (V)
    const E* own = is_c ? m.cs : m.bs;
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = r0 + g + 8 * (i >> 1), n = n0 + 8 * j + 2 * q + (i & 1);
        if (n < N) part[i >> 1] = fmaf(to_f(own[t * BS + n]), acc[j][i], part[i >> 1]);
      }
    part[0] = quad_sum(part[0]);
    part[1] = quad_sum(part[1]);
    float* dst = is_c ? m.pr : m.pv;
    if (q == 0) {
      dst[(n0 / 32) * T + r0 + g] = part[0];
      dst[(n0 / 32) * T + r0 + g + 8] = part[1];
    }
    // + M B over s <= t (dC) or M^T C over t >= s (dB)
    if (is_c)
      prod_split<E, true, 4>(
          acc, 0, r0 + 16, [&](int r, int k) { return m.ms[(r0 + r) * GS + k]; },
          [&](int k, int n) { return n0 + n < NP ? to_f(m.bs[k * BS + n0 + n]) : 0.f; });
    else
      prod_split<E, true, 4>(
          acc, r0, T, [&](int r, int k) { return m.ms[k * GS + r0 + r]; },
          [&](int k, int n) { return n0 + n < NP ? to_f(m.cs[k * BS + n0 + n]) : 0.f; });
    float* out = (is_c ? a.pc : a.pb) + bch * T * N;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = r0 + g + 8 * (i >> 1), n = n0 + 8 * j + 2 * q + (i & 1);
        if (t < rows && n < N) out[static_cast<size_t>(t) * N + n] = acc[j][i];
      }
  }
  __syncthreads();

  // da, ddt and dA by one warp, a lane rows 2 lane and 2 lane + 1
  if (warp == 0) {
    float dcum[2], vv[2], dd[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = 2 * lane + k;
      float colq = 0.f;
#pragma unroll
      for (int wi = 0; wi < NTH / 32; ++wi) colq += m.colp[wi * T + t];
      float r = 0.f, v = 0.f, x = 0.f;
      for (int sl = 0; sl < nnt; ++sl) {
        r += m.pr[sl * T + t];
        v += m.pv[sl * T + t];
      }
      for (int sl = 0; sl < npt; ++sl) x += m.pdx[sl * T + t];
      dcum[k] = m.rowq[t] - colq + r;
      vv[k] = v;
      dd[k] = x;
    }
    float decay = 0.f;
#pragma unroll
    for (int wi = 0; wi < NTH / 32; ++wi) decay += m.red[wi];
    decay *= expf(last);
    // sum_{t >= r} dcum_t: a suffix scan over the lanes
    float suf = dcum[0] + dcum[1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, suf, off);
      if (lane + off < 32) suf += o;
    }
    float next = __shfl_down_sync(0xffffffffu, suf, 1);
    if (lane == 31) next = 0.f;
    const float suf1 = dcum[1] + next, suf0 = dcum[0] + suf1;
    // sum_{s < r} V_s: an exclusive prefix scan
    float pre = vv[0] + vv[1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, pre, off);
      if (lane >= off) pre += o;
    }
    const float ex0 = pre - (vv[0] + vv[1]), ex1 = ex0 + vv[0];
    const float da[2] = {suf0 + ex0 + decay, suf1 + ex1 + decay};
    const float ah = a.A[h];
    float dap = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = 2 * lane + k;
      dap = fmaf(m.dts[r], da[k], dap);
      if (r < rows)
        a.ddt[(row0 + r) * a.H + h] = rt::from_f<E>(fmaf(ah, da[k], dd[k]));
    }
    dap = warp_sum(dap);
    if (lane == 0) a.pa[bch] = dap;
  }
}

// dB and dC, each element's partial sums (per head, or per head group)
// added in order.
template <typename E>
__device__ __forceinline__ void reduce_at(const BwdArgs<E>& a, int B, size_t e) {
  const size_t total = static_cast<size_t>(B) * a.S * a.N;
  if (e >= total) return;
  const size_t sn = static_cast<size_t>(a.S) * a.N;
  const int b = static_cast<int>(e / sn);
  const int s = static_cast<int>((e % sn) / a.N), n = static_cast<int>(e % a.N);
  const int c = s / T, t = s % T;
  const size_t base = ((static_cast<size_t>(b) * a.nc + c) * a.parts * T + t) * a.N + n;
  const size_t step = static_cast<size_t>(T) * a.N;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < a.parts; ++h) {
    sb += a.pb[base + h * step];
    sc += a.pc[base + h * step];
  }
  a.dB[e] = rt::from_f<E>(sb);
  a.dC[e] = rt::from_f<E>(sc);
}

// The last pass: dB and dC (blocks below nred, reduce_at), and dA, a warp a
// head over rows and chunks: lane l sums entries l, l + 32, ... in order,
// the lanes then in a fixed tree.
template <typename E>
__global__ void __launch_bounds__(RED) bwd_finish(BwdArgs<E> a, int B, int nred) {
  if (static_cast<int>(blockIdx.x) < nred) {
    reduce_at(a, B, static_cast<size_t>(blockIdx.x) * RED + threadIdx.x);
    return;
  }
  const int h = (blockIdx.x - nred) * (RED / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (h >= a.H) return;
  const size_t n = static_cast<size_t>(B) * a.nc;
  float s = 0.f;
  for (size_t i = lane; i < n; i += 32) s += a.pa[i * a.H + h];
  s = warp_sum(s);
  if (lane == 0) a.dA[h] = s;
}

template <typename E>
cudaError_t finish(const BwdArgs<E>& a, int B, cudaStream_t st) {
  const size_t total = static_cast<size_t>(B) * a.S * a.N;
  const int nred = static_cast<int>((total + RED - 1) / RED);
  bwd_finish<E><<<nred + (a.H + RED / 32 - 1) / (RED / 32), RED, 0, st>>>(a, B, nred);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 passes on wgmma (the header's design): a walk over the chunks for
// the states, a chunk pass over head groups, then the sums.
// ---------------------------------------------------------------------------
namespace tc {

using sm90::Layout;
constexpr int WT = 128;       // walk block: one warpgroup
constexpr int CT = 256;       // chunk block: two warpgroups
constexpr int HG = 4;         // heads a chunk block takes in turn, summing their dB and dC
constexpr int STAGES = 2;     // per-head tile stages of the chunk pass (1: no prefetch)
constexpr int WSTAGES = 4;    // the walk's ring of chunks (WSTAGES - 1 in flight)
constexpr int XW = 72;        // row stride (bf16) of the walk's plain 64-column x / dy slice

// the swizzle acts on shared-memory address bits: tiles start on 1024 bytes
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw, uint32_t& addr) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  const uint32_t shift = (1024 - (s & 1023)) & 1023;
  addr = s + shift;
  return raw + shift;
}

// element (r, c) of a swizzled bf16 tile of ROWS rows and DP columns
template <int DP, int ROWS>
__device__ __forceinline__ float at(const unsigned char* tile, int r, int c) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(
      tile + sm90::chunk_offset<DP, ROWS>(r, c >> 3) + (c & 7) * 2));
}

// x0, x1 as bf16 pairs hi = bf16(x) and lo = bf16(x - hi) (16 mantissa bits)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = sm90::pack_bf16(x0, x1);
  const float2 h = sm90::unpack_bf16(hi);
  lo = sm90::pack_bf16(x0 - h.x, x1 - h.y);
}

// the hi and lo A fragments (K 64, four k-steps) of a 64 x 64 fp32
// accumulator (wgmma.cuh's layout)
__device__ __forceinline__ void frags(const float (&v)[32], uint32_t (&hi)[4][4],
                                      uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) split2(v[8 * kk + 2 * e], v[8 * kk + 2 * e + 1], hi[kk][e], lo[kk][e]);
}

template <int NR>
__device__ __forceinline__ void zero(float (&v)[NR]) {
#pragma unroll
  for (int e = 0; e < NR; ++e) v[e] = 0.f;
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

// acc (64 x 64) += A B^T over KP columns, both K-major (Layout<KP>): A the
// 64 rows at a_addr of a tile of RA rows, B the 64 rows at b_addr of a tile
// of RBT rows.  Issued, not fenced, not committed.
template <int KP, int RA, int RBT>
__device__ __forceinline__ void ss_kk(float (&acc)[32], uint32_t a_addr, uint32_t b_addr) {
  constexpr int RB = Layout<KP>::RB;
  const uint64_t da = sm90::desc<KP>(a_addr), db = sm90::desc<KP>(b_addr);
#pragma unroll
  for (int kk = 0; kk < KP / 16; ++kk) {
    const uint32_t sub = kk * 32 / RB, off = kk * 32 % RB;
    sm90::wgmma_ss(acc, sm90::desc_at(da, sub * RA * RB + off), sm90::desc_at(db, sub * RBT * RB + off),
                   1);
  }
}

// acc (64 x NP) += A B: A the 64 rows at a_addr of a K-major tile of KP
// columns (64 rows), B a tile of KP rows and NP columns at b_addr read
// MN-major (its rows are the depth).  Issued, not fenced, not committed.
template <int KP, int NP>
__device__ __forceinline__ void ss_mn(float (&acc)[Layout<NP>::NSUB][32], uint32_t a_addr,
                                      uint32_t b_addr) {
  using LA = Layout<KP>;
  using LB = Layout<NP>;
  const uint64_t da = sm90::desc<KP>(a_addr), db = sm90::desc<NP>(b_addr);
#pragma unroll
  for (int kk = 0; kk < KP / 16; ++kk) {
    const uint32_t sub = kk * 32 / LA::RB, off = kk * 32 % LA::RB;
    const uint64_t a = sm90::desc_at(da, sub * 64 * LA::RB + off);
#pragma unroll
    for (int sb = 0; sb < LB::NSUB; ++sb)
      wgmma_ss_mn(acc[sb], a, sm90::desc_at(db, sb * KP * LB::RB + kk * 16 * LB::RB));
  }
}

// acc (64 x 64) += A B: A register fragments (K 64), B the 64-column
// sub-tile pc of a 64-row tile of DP columns at b_addr, read MN-major.
template <int DP>
__device__ __forceinline__ void rs_piece(float (&acc)[32], const uint32_t (&a)[4][4],
                                         uint32_t b_addr, int pc) {
  using L = Layout<DP>;
  const uint64_t db = sm90::desc<DP>(b_addr);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_rs(acc, a[kk], sm90::desc_at(db, pc * T * L::RB + kk * 16 * L::RB));
}

// ---- the walk ----------------------------------------------------------------
// Shared memory: a ring of WSTAGES chunks, each the plain 64-column x (or
// dy) slice and the swizzled B (or C) tile, then the row scales and cum in
// log2 units, two chunks' worth each.
template <int NP>
struct WalkCfg {
  static constexpr int XB = T * XW * 2;
  static constexpr int BB = T * NP * 2;
  static constexpr int STAGE = XB + BB;
  static constexpr int PB = 64 * NP * 2;     // a plane's 64 rows, staged for the store
  static constexpr int SMEM = WSTAGES * STAGE + 2 * PB + 4 * T * 4 + 1024;   // + alignment slack
  static_assert(XB % 1024 == 0 && BB % 1024 == 0, "every tile on a swizzle period");
};

// One (row, head, 64 rows of P) block, forward (blockIdx.x < PP / 64: the
// state, from zero, over x, B and the weights w) or in reverse (its
// gradient, from dh_final, over dy, C and exp(cum)).  The running state
// (64 x NP fp32) is a wgmma accumulator; before each chunk's term is added
// it is written as that chunk's h_in (dh_out) in bf16 hi and lo planes,
// each the image of the chunk pass's swizzled [PP][NP] tile (through shared
// memory, 16-byte stores of whole rows):
//   h <- exp(cum_T) h + (x o w)^T B,   dh <- exp(cum_T) dh + (dy o exp(cum))^T C,
// (x o w)^T as hi and lo register fragments, B (C) read MN-major.  WSTAGES - 1
// chunks' tiles are in flight (cp.async ring) while one is multiplied, and
// warp 0 forms the next chunk's row scales meanwhile.
template <int NP>
__global__ void __launch_bounds__(WT) bwd_walk(BwdArgs<bf16> a) {
  using C = WalkCfg<NP>;
  using L = Layout<NP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint32_t base;
  unsigned char* smem = aligned_smem(smem_raw, base);
  unsigned char* hi_s = smem + WSTAGES * C::STAGE;                     // the planes' rows
  unsigned char* lo_s = hi_s + C::PB;
  float* scs = reinterpret_cast<float*>(lo_s + C::PB);                  // [2][T] w or exp(cum)
  float* cls = scs + 2 * T;                                            // [2][T] cum log2(e)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int ns = a.PP / 64, rev = static_cast<int>(blockIdx.x) >= ns;
  const int p0 = (static_cast<int>(blockIdx.x) % ns) * 64;
  const int h = blockIdx.y, b = blockIdx.z, nc = a.nc, S = a.S, H = a.H, P = a.P, N = a.N;
  const size_t xr = static_cast<size_t>(H) * P;
  const bf16* src = (rev ? a.dy : a.x) + static_cast<size_t>(b) * S * xr + static_cast<size_t>(h) * P + p0;
  const bf16* mat = (rev ? a.Cm : a.Bm) + static_cast<size_t>(b) * S * N;
  const bf16* dtp = a.dt + static_cast<size_t>(b) * S * H + h;
  const int pw = min(64, P - p0);

  // chunk k of the walk (c = k forward, nc - 1 - k in reverse) into stage
  // k % WSTAGES; one cp.async group, empty past the walk's end
  auto load = [&](int k) {
    if (k < nc) {
      const int c = rev ? nc - 1 - k : k;
      unsigned char* xs = smem + (k % WSTAGES) * C::STAGE;
      rt::stage_async(reinterpret_cast<bf16*>(xs), XW, src + static_cast<size_t>(c) * T * xr, xr,
                      min(T, S - c * T), pw, T, 64, a.vx);
      if (a.vn)
        sm90::load_tile<NP, T, true, WT>(xs + C::XB, mat, N, c * T, S, N, tid);
      else
        sm90::load_tile<NP, T, false, WT>(xs + C::XB, mat, N, c * T, S, N, tid);
    }
    rt::cp_async_commit();
  };
  // dt of chunk k's rows 2 lane and 2 lane + 1 (warp 0)
  auto load_dt = [&](int k, float (&v)[2]) {
    const int c = rev ? nc - 1 - k : k;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = c * T + 2 * lane + i;
      v[i] = k < nc && s < S ? to_f(dtp[static_cast<size_t>(s) * H]) : 0.f;
    }
  };
  // chunk k's row scales into buffer k & 1 (warp 0): w = dt exp(cum_T - cum)
  // forward, exp(cum) in reverse
  const float al = a.A[h] * rt::kLog2e;
  auto scales = [&](int k, const float (&v)[2]) {
    float* cl = cls + (k & 1) * T;
    cl[2 * lane] = al * v[0];
    cl[2 * lane + 1] = al * v[1];
    rt::warp_cumsum<T>(cl);
    __syncwarp();
    const float last = cl[T - 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * lane + i;
      scs[(k & 1) * T + r] = rev ? sm90::fast_exp2(cl[r]) : v[i] * sm90::fast_exp2(last - cl[r]);
    }
  };

  float acc[L::NSUB][32];
#pragma unroll
  for (int sb = 0; sb < L::NSUB; ++sb) zero(acc[sb]);
  if (rev && a.dhf != nullptr) {
    const float* d = a.dhf + (static_cast<size_t>(b) * H + h) * P * N;
#pragma unroll
    for (int sb = 0; sb < L::NSUB; ++sb)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int p = p0 + 16 * warp + g + 8 * ((e >> 1) & 1), n = sb * 64 + 8 * (e >> 2) + 2 * q + (e & 1);
        acc[sb][e] = p < P && n < N ? d[static_cast<size_t>(p) * N + n] : 0.f;
      }
  }
#pragma unroll
  for (int k = 0; k < WSTAGES - 1; ++k) load(k);
  float dtv[2] = {0.f, 0.f};
  if (warp == 0) {
    load_dt(0, dtv);
    scales(0, dtv);
    load_dt(1, dtv);
  }
  const size_t plane = static_cast<size_t>(a.PP) * NP;
  bf16* states = rev ? a.hd : a.hs;

  for (int k = 0; k < nc; ++k) {
    const int c = rev ? nc - 1 - k : k, st = k % WSTAGES;
    rt::cp_async_wait<WSTAGES - 2>();
    sm90::fence_async_shared();
    __syncthreads();                    // chunk k's tiles and scales; chunk k - 1 done
    load(k + WSTAGES - 1);              // into the stage chunk k - 1 used

    // the state entering chunk c: h_in (forward) or dh_out (reverse), its
    // 64 rows in the swizzled layout (chunk j of row r at j ^ (r & 7)), then
    // copied out row by row
#pragma unroll
    for (int sb = 0; sb < L::NSUB; ++sb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 16 * warp + g + 8 * i;
          const uint32_t o = sb * 64 * 128 + r * 128 + ((j ^ (r & 7)) << 4) + 4 * q;
          uint32_t vh, vl;
          split2(acc[sb][4 * j + 2 * i], acc[sb][4 * j + 2 * i + 1], vh, vl);
          *reinterpret_cast<uint32_t*>(hi_s + o) = vh;
          *reinterpret_cast<uint32_t*>(lo_s + o) = vl;
        }
    __syncthreads();
    {
      unsigned char* gh = reinterpret_cast<unsigned char*>(
          states + ((static_cast<size_t>(b) * nc + c) * H + h) * 2 * plane);
      unsigned char* gl = gh + plane * 2;
#pragma unroll
      for (int e = tid; e < C::PB / 16; e += WT) {
        const size_t go = static_cast<size_t>(e >> 9) * a.PP * 128 + static_cast<size_t>(p0) * 128 +
                          (e & 511) * 16;
        *reinterpret_cast<uint4*>(gh + go) = *reinterpret_cast<const uint4*>(hi_s + e * 16);
        *reinterpret_cast<uint4*>(gl + go) = *reinterpret_cast<const uint4*>(lo_s + e * 16);
      }
    }
    if (k + 1 == nc) break;             // the state past the walk's end is not needed

    const float* sc = scs + (k & 1) * T;
    const float decay = sm90::fast_exp2(cls[(k & 1) * T + T - 1]);
#pragma unroll
    for (int sb = 0; sb < L::NSUB; ++sb)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[sb][e] *= decay;
    // (src o sc)^T: rows p of the slice, depth t, as hi and lo fragments
    const bf16* xs = reinterpret_cast<const bf16*>(smem + st * C::STAGE);
    uint32_t fh[4][4], fl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * warp + g + 8 * (e & 1), t = 16 * kk + 2 * q + 8 * (e >> 1);
        split2(to_f(xs[t * XW + p]) * sc[t], to_f(xs[(t + 1) * XW + p]) * sc[t + 1], fh[kk][e],
               fl[kk][e]);
      }
    const uint32_t b_addr = base + st * C::STAGE + C::XB;
    sm90::wgmma_fence();
    sm90::rs_product<NP, T, 4>(acc, fh, b_addr);
    sm90::rs_product<NP, T, 4>(acc, fl, b_addr);
    sm90::wgmma_commit();
    if (warp == 0) {                    // the next chunk's scales meanwhile
      scales(k + 1, dtv);
      load_dt(k + 2, dtv);
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int sb = 0; sb < L::NSUB; ++sb) sm90::fence_regs(acc[sb]);
  }
  rt::cp_async_wait<0>();               // no copy outlives the block
}

// ---- the chunk pass ------------------------------------------------------------
// Shared memory: NST stages of a head's tiles (x, dy: 64 x PP; h_in and
// dh_out: PP x NP, hi and lo planes each), the group's B and C (64 x NP),
// all swizzled, then fp32 vectors: the group's dt, cum log2(e), exp(cum),
// exp(cum_T - cum) and w ([5][HG][T]), and each head's terms of da ([HG]
// slots of HV: Q's column sums by warp of warpgroup 1 [4][T], Q's row sums,
// R, V, x . U by piece [2][T], <dh_out, h_in> by warp [8]).  Two stages
// where they fit, else one.
template <int PP, int NP>
struct ChunkCfg {
  static constexpr int XT = T * PP * 2;
  static constexpr int SP = PP * NP * 2;
  static constexpr int STAGE = 2 * XT + 4 * SP;
  static constexpr int BT = T * NP * 2;
  static constexpr int HV = 9 * T + 8;
  static constexpr int VEC = 5 * HG * T + HG * HV;
  static constexpr int REST = 2 * BT + VEC * 4 + 1024;   // + alignment slack
  static constexpr int NST = STAGES * STAGE + REST <= SMEM_MAX ? STAGES : 1;
  static constexpr int TILES = NST * STAGE + 2 * BT;
  static constexpr int SMEM = NST * STAGE + REST;
  static_assert(XT % 1024 == 0 && SP % 1024 == 0 && BT % 1024 == 0, "tiles on a swizzle period");
  static_assert(SMEM <= SMEM_MAX, "a block may use at most 227 KB of shared memory");
};

// One (row, chunk) and its group of up to HG heads, taken in order; warpgroup
// 0 computes in rows t (dG, M, dC), warpgroup 1 in rows s (dG^T, M^T, Q^T,
// dB); each a 64-column piece of U (at PP 64 both the one piece, warpgroup 0
// keeping it).  dC (0) and dB (1) of the group are summed in registers over
// its heads in order and written once.  A head's tiles load while the one
// before is multiplied; its terms of da wait in shared memory, and the
// group's da scans run at its end, a warp a head.  Every branch around a
// wgmma is uniform over the block.
template <int PP, int NP>
__global__ void __launch_bounds__(CT, 1) bwd_groups(BwdArgs<bf16> a) {
  using C = ChunkCfg<PP, NP>;
  using LN = Layout<NP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint32_t base;
  unsigned char* smem = aligned_smem(smem_raw, base);
  const unsigned char* btile = smem + C::NST * C::STAGE;
  const unsigned char* ctile = btile + C::BT;
  const uint32_t b_addr = base + C::NST * C::STAGE, c_addr = b_addr + C::BT;
  float* dts = reinterpret_cast<float*>(smem + C::TILES);   // [HG][T]
  float* cls = dts + HG * T;     // cum log2(e)
  float* ecs = cls + HG * T;     // exp(cum)
  float* efs = ecs + HG * T;     // exp(cum_T - cum)
  float* ws = efs + HG * T;      // dt exp(cum_T - cum)
  float* hvs = ws + HG * T;      // [HG][HV]

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int grp = blockIdx.x, b = blockIdx.z;
  const int H = a.H, P = a.P, N = a.N, S = a.S;
  const int h0 = grp * HG, nh = min(HG, H - h0);
  const int c = blockIdx.y, rows = min(T, S - c * T);
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * T;
  const size_t xr = static_cast<size_t>(H) * P;
  const bf16* xb = a.x + static_cast<size_t>(b) * S * xr;
  const bf16* dyb = a.dy + static_cast<size_t>(b) * S * xr;
  const size_t plane = static_cast<size_t>(PP) * NP;

  // head h0 + k's tiles into stage k % NST (one cp.async group)
  auto load_head = [&](int k) {
    if (k < nh) {
      const int h = h0 + k;
      unsigned char* s = smem + (k % C::NST) * C::STAGE;
      if (a.vx) {
        sm90::load_tile<PP, T, true, CT>(s, xb + h * P, xr, c * T, S, P, tid);
        sm90::load_tile<PP, T, true, CT>(s + C::XT, dyb + h * P, xr, c * T, S, P, tid);
      } else {
        sm90::load_tile<PP, T, false, CT>(s, xb + h * P, xr, c * T, S, P, tid);
        sm90::load_tile<PP, T, false, CT>(s + C::XT, dyb + h * P, xr, c * T, S, P, tid);
      }
      // h_in and dh_out, hi and lo: each plane the tile's swizzled image
      const size_t so = ((static_cast<size_t>(b) * a.nc + c) * H + h) * 2 * plane;
      const bf16* src[4] = {a.hs + so, a.hs + so + plane, a.hd + so, a.hd + so + plane};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        for (int e = tid; e < C::SP / 16; e += CT)
          rt::cp_async16(s + 2 * C::XT + i * C::SP + 16 * e, src[i] + 8 * e, 16);
    }
    rt::cp_async_commit();
  };
  // this thread's accumulator rows (r0, r0 + 8) and columns (col(e))
  const int r0 = 16 * warp + g;
  auto row = [&](int e) { return r0 + 8 * ((e >> 1) & 1); };
  auto col = [&](int e) { return 8 * (e >> 2) + 2 * q + (e & 1); };
  // U's 64-column piece: warpgroup w's at PP 128; at PP 64 both compute the
  // one piece (uniform control flow around wgmma) and warpgroup 0 keeps it
  const int pc = PP > 64 ? wg : 0;
  const bool keep_u = PP > 64 || wg == 0;
  // the threads that share U's piece: a warpgroup at PP 128, the block at 64
  auto piece_barrier = [](int w) {
    if constexpr (PP > 64)
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
    else
      __syncthreads();
  };

  float gt[32];                  // G^T = B C^T (rows s), each warpgroup its own
  float dsum[LN::NSUB][32];      // dC (warpgroup 0) or dB (1) over the group's heads
#pragma unroll
  for (int sb = 0; sb < LN::NSUB; ++sb) zero(dsum[sb]);
  {
    unsigned char* bt = smem + C::NST * C::STAGE;
    const bf16* bsrc = a.Bm + static_cast<size_t>(b) * S * N;
    const bf16* csrc = a.Cm + static_cast<size_t>(b) * S * N;
    if (a.vn) {
      sm90::load_tile<NP, T, true, CT>(bt, bsrc, N, c * T, S, N, tid);
      sm90::load_tile<NP, T, true, CT>(bt + C::BT, csrc, N, c * T, S, N, tid);
    } else {
      sm90::load_tile<NP, T, false, CT>(bt, bsrc, N, c * T, S, N, tid);
      sm90::load_tile<NP, T, false, CT>(bt + C::BT, csrc, N, c * T, S, N, tid);
    }
  }
  load_head(0);
  for (int e = tid; e < HG * T; e += CT) {
    const int k = e / T, r = e % T;
    dts[e] = k < nh && r < rows ? to_f(a.dt[(row0 + r) * H + h0 + k]) : 0.f;
  }
  __syncthreads();
  if ((tid >> 5) < nh) {                // the group's row scales, a warp a head
    const int k = tid >> 5;
    const float al = a.A[h0 + k] * rt::kLog2e;
    const float* dk = dts + k * T;
    float* cl = cls + k * T;
    cl[2 * lane] = al * dk[2 * lane];
    cl[2 * lane + 1] = al * dk[2 * lane + 1];
    rt::warp_cumsum<T>(cl);
    __syncwarp();
    const float last = cl[T - 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * lane + i;
      ecs[k * T + r] = sm90::fast_exp2(cl[r]);
      efs[k * T + r] = sm90::fast_exp2(last - cl[r]);
      ws[k * T + r] = dk[r] * efs[k * T + r];
    }
  }

  for (int k = 0; k < nh; ++k) {
    const int h = h0 + k, st = k % C::NST;
    const unsigned char* xs = smem + st * C::STAGE;
    const uint32_t xa = base + st * C::STAGE, dya = xa + C::XT, ha = dya + C::XT,
                   da = ha + 2 * C::SP;
    unsigned char* dsm = smem + (da - base);   // dh_out's planes
    if (C::NST == 1 && k > 0) {
      __syncthreads();                  // head k - 1 is done with the stage
      load_head(k);
    }
    rt::cp_async_wait<0>();
    sm90::fence_async_shared();
    __syncthreads();                    // head k's tiles (k = 0: B, C, scales); head k - 1 done
    if (C::NST > 1) load_head(k + 1);   // into the stage head k - 1 used
    const float* dk = dts + k * T;
    const float* cl = cls + k * T;
    float* hv = hvs + k * C::HV;
    float* rowp = hv;            // [4][T]
    float* colq = hv + 4 * T;
    float* R = colq + T;
    float* V = R + T;
    float* pdx = V + T;          // [2][T]
    float* red = pdx + 2 * T;    // [8]

    // dG (warpgroup 0: dy x^T, rows t) or dG^T (1: x dy^T, rows s); the
    // state part of dC (0: dy h_in) or dB (1: x dh_out), h_in / dh_out read
    // MN-major as hi then lo; U's state part B dh_out^T (dh_out K-major)
    float d[32], sp[LN::NSUB][32], u[32];
    zero(d);
    zero(u);
#pragma unroll
    for (int sb = 0; sb < LN::NSUB; ++sb) zero(sp[sb]);
    if (k == 0) zero(gt);
    sm90::wgmma_fence();
    if (k == 0) ss_kk<NP, T, T>(gt, b_addr, c_addr);
    ss_kk<PP, T, T>(d, wg ? xa : dya, wg ? dya : xa);
    sm90::wgmma_commit();
    {
      const uint32_t lhs = wg ? xa : dya, sa = wg ? da : ha;
      ss_mn<PP, NP>(sp, lhs, sa);
      ss_mn<PP, NP>(sp, lhs, sa + C::SP);
    }
    sm90::wgmma_commit();
    ss_kk<NP, T, PP>(u, b_addr, da + pc * 64 * LN::RB);
    ss_kk<NP, T, PP>(u, b_addr, da + C::SP + pc * 64 * LN::RB);
    sm90::wgmma_commit();
    sm90::wgmma_wait<2>();
    sm90::fence_regs(d);
    sm90::fence_regs(gt);

    // M (rows t) or M^T (rows s) = dG o L o dt_s, L's exponent taken only for
    // s <= t, as hi and lo fragments; Q^T = G^T o M^T (warpgroup 1) summed
    // by row (colsum Q) and by column (rowsum Q, a warp's rows)
    uint32_t mh[4][4], ml[4][4];
    {
      float rq[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int cv = 8 * j + 2 * q + cc;
          float cs = 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i + cc, r = r0 + 8 * i;
            const int t = wg ? cv : r, s = wg ? r : cv;
            const float m = s <= t ? d[e] * sm90::fast_exp2(cl[t] - cl[s]) * dk[s] : 0.f;
            d[e] = m;
            const float qv = gt[e] * m;
            rq[i] += qv;
            cs += qv;
          }
          cs += __shfl_xor_sync(0xffffffffu, cs, 4);
          cs += __shfl_xor_sync(0xffffffffu, cs, 8);
          cs += __shfl_xor_sync(0xffffffffu, cs, 16);
          if (wg && g == 0) rowp[warp * T + cv] = cs;
        }
      frags(d, mh, ml);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float sum = quad_sum(rq[i]);
        if (wg && q == 0) colq[r0 + 8 * i] = sum;
      }
    }

    // the state part's row scale (exp(cum) for dC, w for dB), after its
    // product with the row's C (R) or B (V); then + M B or M^T C
    sm90::wgmma_wait<1>();
#pragma unroll
    for (int sb = 0; sb < LN::NSUB; ++sb) sm90::fence_regs(sp[sb]);
    {
      const float* scl = (wg ? ws : ecs) + k * T;
      const unsigned char* own = wg ? btile : ctile;
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int sb = 0; sb < LN::NSUB; ++sb)
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int n = sb * 64 + col(e);
          part[(e >> 1) & 1] = fmaf(at<NP, T>(own, row(e), n), sp[sb][e], part[(e >> 1) & 1]);
        }
      float* dst = wg ? V : R;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float sum = quad_sum(part[i]);
        if (q == 0) dst[r0 + 8 * i] = sum * scl[r0 + 8 * i];
      }
#pragma unroll
      for (int sb = 0; sb < LN::NSUB; ++sb)
#pragma unroll
        for (int e = 0; e < 32; ++e) sp[sb][e] *= scl[row(e)];
    }
    sm90::wgmma_fence();
    sm90::rs_product<NP, T, 4>(sp, mh, wg ? c_addr : b_addr);
    sm90::rs_product<NP, T, 4>(sp, ml, wg ? c_addr : b_addr);
    sm90::wgmma_commit();

    // U = exp(cum_T - cum) B dh_out^T + (G o L)^T dy on this piece: the row
    // scale, then (G o L)^T = G^T o L^T (rows s) as hi and lo fragments
    sm90::wgmma_wait<1>();
    sm90::fence_regs(u);
    const float* ef = efs + k * T;
#pragma unroll
    for (int e = 0; e < 32; ++e) u[e] *= ef[row(e)];
    uint32_t gh[4][4], gl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) {
        const int e = 8 * kk + 2 * e2, s = row(e), t = col(e);
        const float v0 = s <= t ? gt[e] * sm90::fast_exp2(cl[t] - cl[s]) : 0.f;
        const float v1 = s <= t + 1 ? gt[e + 1] * sm90::fast_exp2(cl[t + 1] - cl[s]) : 0.f;
        split2(v0, v1, gh[kk][e2], gl[kk][e2]);
      }
    sm90::wgmma_fence();
    rs_piece<PP>(u, gh, dya, pc);
    rs_piece<PP>(u, gl, dya, pc);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
#pragma unroll
    for (int sb = 0; sb < LN::NSUB; ++sb) {
      sm90::fence_regs(sp[sb]);
#pragma unroll
      for (int e = 0; e < 32; ++e) dsum[sb][e] += sp[sb][e];
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(u);

    // the decay's <dh_out, h_in> (padding is zero), hi + lo of each
    {
      const uint4* hh = reinterpret_cast<const uint4*>(xs + 2 * C::XT);
      const uint4* hl = reinterpret_cast<const uint4*>(xs + 2 * C::XT + C::SP);
      const uint4* dh = reinterpret_cast<const uint4*>(dsm);
      const uint4* dl = reinterpret_cast<const uint4*>(dsm + C::SP);
      float dd = 0.f;
      for (int e = tid; e < C::SP / 16; e += CT) {
        const uint4 v[4] = {hh[e], hl[e], dh[e], dl[e]};
        const uint32_t* u0 = reinterpret_cast<const uint32_t*>(&v[0]);
        const uint32_t* u1 = reinterpret_cast<const uint32_t*>(&v[1]);
        const uint32_t* u2 = reinterpret_cast<const uint32_t*>(&v[2]);
        const uint32_t* u3 = reinterpret_cast<const uint32_t*>(&v[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 a0 = sm90::unpack_bf16(u0[i]), a1 = sm90::unpack_bf16(u1[i]);
          const float2 b0 = sm90::unpack_bf16(u2[i]), b1 = sm90::unpack_bf16(u3[i]);
          dd = fmaf(a0.x + a1.x, b0.x + b1.x, dd);
          dd = fmaf(a0.y + a1.y, b0.y + b1.y, dd);
        }
      }
      dd = warp_sum(dd);
      if (lane == 0) red[tid >> 5] = dd;
    }

    // x . U, and dx = dt U through this piece's sub-tile of the dy tile (its
    // last reader, U's product, is done), then 16-byte stores of whole rows
    {
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int s = row(e), p = pc * 64 + col(e);
        part[(e >> 1) & 1] = fmaf(at<PP, T>(xs, s, p), u[e], part[(e >> 1) & 1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float sum = quad_sum(part[i]);
        if (keep_u && q == 0) pdx[pc * T + r0 + 8 * i] = sum;
      }
      unsigned char* piece = smem + st * C::STAGE + C::XT + pc * T * 128;
      piece_barrier(wg);
      if (keep_u) {
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int s = row(e), cl = col(e);
          *reinterpret_cast<uint32_t*>(piece + s * 128 + (((cl >> 3) ^ (s & 7)) << 4) + (cl & 7) * 2) =
              sm90::pack_bf16(dk[s] * u[e], dk[s] * u[e + 1]);
        }
      }
      piece_barrier(wg);
      if (keep_u) {
        bf16* dxb = a.dx + row0 * xr + static_cast<size_t>(h) * P + pc * 64;
        for (int e = tid & 127; e < T * 8; e += 128) {
          const int s = e >> 3, cc = e & 7, p = pc * 64 + 8 * cc;
          if (s >= rows || p >= P) continue;
          const unsigned char* v = piece + s * 128 + ((cc ^ (s & 7)) << 4);
          bf16* o = dxb + static_cast<size_t>(s) * xr + 8 * cc;
          if (a.vx) {
            *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(v);
          } else {
            for (int i = 0; i < 8 && p + i < P; ++i) o[i] = reinterpret_cast<const bf16*>(v)[i];
          }
        }
      }
    }

  }
  __syncthreads();

  // da, ddt and dA, a warp a head, a lane rows 2 lane and 2 lane + 1
  if ((tid >> 5) < nh) {
    const int k = tid >> 5, h = h0 + k;
    const float* hv = hvs + k * C::HV;
    const float* dk = dts + k * T;
    float dcum[2], vv[2], dd[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int t = 2 * lane + kk;
      const float rq = ((hv[t] + hv[T + t]) + hv[2 * T + t]) + hv[3 * T + t];
      dcum[kk] = rq - hv[4 * T + t] + hv[5 * T + t];
      vv[kk] = hv[6 * T + t];
      dd[kk] = PP > 64 ? hv[7 * T + t] + hv[8 * T + t] : hv[7 * T + t];
    }
    float decay = 0.f;
#pragma unroll
    for (int wi = 0; wi < CT / 32; ++wi) decay += hv[9 * T + wi];
    decay *= sm90::fast_exp2(cls[k * T + T - 1]);
    float suf = dcum[0] + dcum[1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, suf, off);
      if (lane + off < 32) suf += o;
    }
    float next = __shfl_down_sync(0xffffffffu, suf, 1);
    if (lane == 31) next = 0.f;
    const float suf1 = dcum[1] + next, suf0 = dcum[0] + suf1;
    float pre = vv[0] + vv[1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, pre, off);
      if (lane >= off) pre += o;
    }
    const float ex0 = pre - (vv[0] + vv[1]), ex1 = ex0 + vv[0];
    const float da_[2] = {suf0 + ex0 + decay, suf1 + ex1 + decay};
    const float ahd = a.A[h];
    float dap = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int r = 2 * lane + kk;
      dap = fmaf(dk[r], da_[kk], dap);
      if (r < rows) a.ddt[(row0 + r) * H + h] = __float2bfloat16(fmaf(ahd, da_[kk], dd[kk]));
    }
    dap = warp_sum(dap);
    if (lane == 0) a.pa[(static_cast<size_t>(b) * a.nc + c) * H + h] = dap;
  }

  // the group's dC (warpgroup 0) and dB (1), summed over its heads in order
  float* out = (wg ? a.pb : a.pc) + ((static_cast<size_t>(b) * a.nc + c) * a.parts + grp) * T * N;
#pragma unroll
  for (int sb = 0; sb < LN::NSUB; ++sb)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int n = sb * 64 + col(e);
      if (n < N) out[static_cast<size_t>(row(e)) * N + n] = dsum[sb][e];
    }
  rt::cp_async_wait<0>();               // no copy outlives the block
}


// the padded widths the wgmma passes take: P up to 128, N up to 128, not both
// past 64
inline bool fits(int P, int N) {
  return P >= 1 && N >= 1 && P <= 128 && N <= 128 && (P <= 64 || N <= 64);
}
inline int pad64(int w) { return w <= 64 ? 64 : 128; }
inline int groups(int H) { return (H + HG - 1) / HG; }

// floats of scratch: h_in and dh_out (bf16 hi and lo, 4 bytes an element),
// dB and dC per head group, dA per (row, chunk, head)
inline size_t scratch_floats(int B, int S, int H, int P, int N) {
  const size_t nc = (static_cast<size_t>(S) + T - 1) / T, bc = static_cast<size_t>(B) * nc;
  return bc * (2 * static_cast<size_t>(H) * pad64(P) * pad64(N) +
               2 * static_cast<size_t>(groups(H)) * T * N + H);
}

template <int PP, int NP>
cudaError_t run(BwdArgs<bf16> a, int B, cudaStream_t st) {
  static std::atomic<int> lw[32], lc[32];
  cudaError_t err = rt::smem_at_least(bwd_walk<NP>, WalkCfg<NP>::SMEM, lw);
  if (err != cudaSuccess) return err;
  if ((err = rt::smem_at_least(bwd_groups<PP, NP>, ChunkCfg<PP, NP>::SMEM, lc)) != cudaSuccess) return err;
  bwd_walk<NP><<<dim3(2 * PP / 64, a.H, B), WT, WalkCfg<NP>::SMEM, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_groups<PP, NP><<<dim3(groups(a.H), a.nc, B), CT, ChunkCfg<PP, NP>::SMEM, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return finish(a, B, st);
}

}  // namespace tc

size_t scratch_floats(int B, int S, int H, int P, int N) {
  const size_t nc = (static_cast<size_t>(S) + T - 1) / T, bch = static_cast<size_t>(B) * nc * H;
  return bch * (2 * static_cast<size_t>(P) * N + 2 * static_cast<size_t>(T) * N + 2);
}

template <typename E>
bool fits(int P, int N) {
  return N >= 1 && N <= NMAX && P >= 1 && P <= PMAX &&
         std::max(chunk_smem<E>(P, N), states_smem<E>(P, N)) <= static_cast<size_t>(SMEM_MAX);
}

template <typename E>
struct Limits {
  static std::atomic<int> states[32], chunk[32];   // limits set, per device
};
template <typename E>
std::atomic<int> Limits<E>::states[32];
template <typename E>
std::atomic<int> Limits<E>::chunk[32];

template <typename E>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* dy, const void* dhf, void* dx, void* ddt, void* dA, void* dB, void* dC,
           void* scratch, int B, int S, int H, int P, int N, void* stream) {
  constexpr bool kTc = std::is_same<E, bf16>::value;
  const bool tc_path = kTc && tc::fits(P, N);
  if (H < 1 || !(tc_path || fits<E>(P, N))) return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;     // the wrapper returns zeros itself
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  BwdArgs<E> a{};
  a.x = static_cast<const E*>(x);
  a.dt = static_cast<const E*>(dt);
  a.Bm = static_cast<const E*>(Bm);
  a.Cm = static_cast<const E*>(Cm);
  a.dy = static_cast<const E*>(dy);
  a.A = static_cast<const float*>(A);
  a.dhf = static_cast<const float*>(dhf);
  a.dx = static_cast<E*>(dx);
  a.ddt = static_cast<E*>(ddt);
  a.dB = static_cast<E*>(dB);
  a.dC = static_cast<E*>(dC);
  a.dA = static_cast<float*>(dA);
  a.S = S, a.H = H, a.P = P, a.N = N, a.nc = (S + T - 1) / T;
  const size_t bc = static_cast<size_t>(B) * a.nc, bch = bc * H;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  constexpr int V = 16 / static_cast<int>(sizeof(E));
  a.vx = P % V == 0 && aligned(x) && aligned(dy);
  a.vn = N % V == 0 && aligned(Bm) && aligned(Cm);
  a.vh = N % 4 == 0 && aligned(scratch);
  if constexpr (kTc) {
    if (tc_path) {
      a.PP = tc::pad64(P);
      a.NP = tc::pad64(N);
      a.parts = tc::groups(H);
      const size_t plane = bch * a.PP * a.NP;       // floats: two bf16 planes
      a.hs = static_cast<bf16*>(scratch);
      a.hd = a.hs + 2 * plane;
      a.pb = static_cast<float*>(scratch) + 2 * plane;
      a.pc = a.pb + bc * a.parts * T * N;
      a.pa = a.pc + bc * a.parts * T * N;
      if (a.PP == 64)
        return a.NP == 64 ? tc::run<64, 64>(a, B, st) : tc::run<64, 128>(a, B, st);
      return tc::run<128, 64>(a, B, st);
    }
  }
  a.parts = H;
  a.st = static_cast<float*>(scratch);
  a.sd = a.st + bch * P * N;
  a.pb = a.sd + bch * P * N;
  a.pc = a.pb + bch * T * N;
  a.ct = a.pc + bch * T * N;
  a.pa = a.ct + bch;

  const int s1 = static_cast<int>(states_smem<E>(P, N)), s3 = static_cast<int>(chunk_smem<E>(P, N));
  cudaError_t err = rt::smem_at_least(bwd_states<E>, s1, Limits<E>::states);
  if (err != cudaSuccess) return err;
  if ((err = rt::smem_at_least(bwd_chunk<E>, s3, Limits<E>::chunk)) != cudaSuccess) return err;
  bwd_states<E><<<dim3(H, a.nc, B), NTH, s1, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int PN = P * N;
  if (PN % 4 == 0 && aligned(scratch) && (dhf == nullptr || aligned(dhf)))
    bwd_carry<E, 4><<<dim3((PN / 4 + CNT - 1) / CNT, H, B), CNT, 0, st>>>(a);
  else
    bwd_carry<E, 1><<<dim3((PN + CNT - 1) / CNT, H, B), CNT, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_chunk<E><<<dim3(H, a.nc, B), NTH, s3, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return finish(a, B, st);
}

}  // namespace

extern "C" int ssm_scan_bwd_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                                 const void* Cm, const void* dy, const void* dhf, void* dx,
                                 void* ddt, void* dA, void* dB, void* dC, void* scratch, int B,
                                 int S, int H, int P, int N, void* stream) {
  return launch<bf16>(x, dt, A, Bm, Cm, dy, dhf, dx, ddt, dA, dB, dC, scratch, B, S, H, P, N,
                      stream);
}

extern "C" int ssm_scan_bwd_f32(const void* x, const void* dt, const void* A, const void* Bm,
                                const void* Cm, const void* dy, const void* dhf, void* dx,
                                void* ddt, void* dA, void* dB, void* dC, void* scratch, int B,
                                int S, int H, int P, int N, void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, dy, dhf, dx, ddt, dA, dB, dC, scratch, B, S, H, P, N,
                       stream);
}

// floats of scratch a call needs (the wrapper allocates them): bf16 when
// bf16 is nonzero, else fp32
extern "C" long long ssm_scan_bwd_scratch(int B, int S, int H, int P, int N, int bf16) {
  return static_cast<long long>(bf16 && tc::fits(P, N) ? tc::scratch_floats(B, S, H, P, N)
                                                       : scratch_floats(B, S, H, P, N));
}

// 1 if the kernels take head width P and state size N (bf16 when bf16 is
// nonzero, else fp32): N <= 128, P <= 256 and the chunk pass's tiles within
// a block's shared memory
extern "C" int ssm_scan_bwd_supported(int P, int N, int bf16) {
  return bf16 ? tc::fits(P, N) || fits<__nv_bfloat16>(P, N) : fits<float>(P, N);
}

RT_EXPORT_ERROR_STRING(ssm_scan_bwd)
