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
// ref.ssm_scan_bwd_chunked_ref writes the same passes in torch.
//
// Layout: x, dy (B,S,H,P), dt (B,S,H), B/C (B,S,N), all one dtype (bf16 or
// fp32); A (H,) fp32; dh_final (B,H,P,N) fp32 or null; dx, ddt, dB, dC like
// their inputs; dA (H,) fp32.  N <= 128, P <= 256, and the chunk pass's
// shared memory within 227 KB (ssm_scan_bwd_supported): P 128 with N 64
// (zamba2) in bf16 and fp32, P 64 with N 128.
//
// Passes (five launches a call, scratch the wrapper allocates,
// ssm_scan_bwd_scratch floats):
//   1. bwd_states, grid (H, chunks, B): every chunk's own state S_c =
//      (x o w)^T B, as the forward's ssd_states (up to the product's
//      rounding: below), and its local state gradient D_c =
//      (dy o exp(cum))^T C; cum_T.
//   2. bwd_carry, one thread per four state elements: h_in forward over the
//      chunks (S_c overwritten with h_{c-1}), then dh_out in reverse from
//      dh_final (D_c overwritten with dh_c).  Elementwise fp32, the only
//      loops over chunks.
//   3. bwd_chunk, grid (H, chunks, B), eight warps: G and dy x^T, then
//      G o L, M and Q = G o M with its row and column sums (the exponent
//      taken only for s <= t, so extreme decay cannot overflow), then U,
//      dx and x . U; dC (its state part first: R); dB (its state part
//      first: V); the decay's <dh_out, h_in>; da by a warp's scans.
//      dB, dC per head and dA per (row, chunk, head) go to scratch.
//   4. bwd_reduce: dB and dC summed over the heads in order; bwd_dA: dA
//      over rows and chunks in order.
// Every sum runs in a fixed order (no atomics), so two calls on the same
// inputs give bit-equal gradients.  Rows past S enter as dt = 0, x = B =
// C = dy = 0: identity steps, as the forward pads; they take no gradient.
//
// h_in is rerun (passes 1 and 2) rather than saved by the forward: saving
// it would keep 4 nc H P N bytes a row per layer alive from the forward to
// the backward (67 MB a layer at zamba2's 4 x 1024) and change the
// forward's kernels; the rerun costs the forward's states and carry passes
// again, a third of its work.
//
// bf16 products run on mma.sync with bf16 operands and fp32 sums: G = C B^T
// and dy x^T are exact products of bf16 values.  Every product with an
// fp32 operand (G o L, M, x o w, dy o exp(cum), the states h_in and dh_out)
// takes that operand as two bf16 halves, hi + lo (16 bits, two products),
// where the forward takes TF32 (10 bits): TF32 leaves errors of ~1e-3 of a
// sum's terms, and a row of dC or ddt is a sum whose terms cancel (dC's
// first row of a chunk, where the carried state's term dominates under a
// weak decay), so its error exceeds the rule there.  Row scales (exp(cum), w,
// exp(cum_T - cum)) are applied to the fp32 sums after a product, so its
// other operand stays bf16.  fp32 inputs take the same passes with every
// product an fp32 FMA on the CUDA cores (warp_fma: mma.sync's fragment
// layout, so the epilogues are shared), because the fp32 gates hold fp32
// arithmetic.
//
// FLOPs at zamba2's training shape, x (4,1024,32,128), N 64 (T 64, whole
// tiles, a split product counted twice): per (row, chunk, head) the states
// 2 x 2 x 2 T P N = 4.2 M, G and dy x^T 2 T^2 (N + P) = 1.6 M (the tiles on
// and below the diagonal, 0.6 of it, computed), U 2 x (2 T N P + T^2 P) =
// 3.1 M, dC and dB 2 x 2 x (2 T P N + T^2 N) = 5.2 M: ~14 M, 29 GFLOP a
// call over its 2048 (row, chunk, head) blocks, on the tensor cores.  The
// bound (chip_smoke.py) counts the sequential recurrence's backward state
// work, ~10 P N flops a token and head (the forward's 5 P N, twice), 10.7
// GFLOP, 0.011 ms at the bf16 rate, against the bytes: x, dy, dx
// (B,S,H,P) bf16, dt, ddt, B, C, dB, dC and A, dA once, 0.10 GB, 0.031 ms
// at 3.35 TB/s; bytes bound it.  The kernel moves more: the scratch adds
// 2 x 16 nc H P N bytes a row (the two state arrays written by pass 1,
// rewritten by the carry, read by pass 3: 0.54 GB at that shape) and
// 16 nc H T N (the per-head dB, dC, written and read: 0.13 GB), ~7x the
// bound's bytes, and the chunk pass's tiles (165 KB of shared memory in
// bf16) leave one block of eight warps an SM.  A later design would keep
// the states in shared memory across the chunks and sum the heads' dB, dC
// in one block.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::stage_async;
using rt::stride_bf16;
using rt::stride_gq;
using rt::to_f;

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

// acc += A (16 x [k0,k1)) . B ([k0,k1) x 8 NT) by fp32 FMAs, in mma.sync's
// accumulator layout (common.cuh, warp_mma): acc[j][0..1] row g, columns
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
    rt::warp_mma<true, NT>(acc, k0, k1, a, b);
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
    rt::warp_mma<true, NT>(acc, k0, k1, [&](int r, int k) { return bf_hi(a(r, k)); }, b);
    rt::warp_mma<true, NT>(acc, k0, k1, [&](int r, int k) { const float v = a(r, k); return v - bf_hi(v); }, b);
  } else {
    rt::warp_mma<true, NT>(acc, k0, k1, a, [&](int k, int n) { return bf_hi(b(k, n)); });
    rt::warp_mma<true, NT>(acc, k0, k1, a, [&](int k, int n) { const float v = b(k, n); return v - bf_hi(v); });
  }
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

// The sums over the four lanes of a fragment row (lanes 4g .. 4g + 3), in
// a fixed order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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
  int S, H, P, N, nc;
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

// Pass 4: dB and dC, each element's per-head terms summed in head order.
template <typename E>
__global__ void __launch_bounds__(RED) bwd_reduce(BwdArgs<E> a, int B) {
  const size_t total = static_cast<size_t>(B) * a.S * a.N;
  const size_t e = static_cast<size_t>(blockIdx.x) * RED + threadIdx.x;
  if (e >= total) return;
  const size_t sn = static_cast<size_t>(a.S) * a.N;
  const int b = static_cast<int>(e / sn);
  const int s = static_cast<int>((e % sn) / a.N), n = static_cast<int>(e % a.N);
  const int c = s / T, t = s % T;
  const size_t base = ((static_cast<size_t>(b) * a.nc + c) * a.H * T + t) * a.N + n;
  const size_t step = static_cast<size_t>(T) * a.N;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < a.H; ++h) {
    sb += a.pb[base + h * step];
    sc += a.pc[base + h * step];
  }
  a.dB[e] = rt::from_f<E>(sb);
  a.dC[e] = rt::from_f<E>(sc);
}

// dA: each head's terms over rows and chunks, in order.
template <typename E>
__global__ void __launch_bounds__(128) bwd_dA(BwdArgs<E> a, int B) {
  for (int h = threadIdx.x; h < a.H; h += blockDim.x) {
    float s = 0.f;
    for (size_t i = 0; i < static_cast<size_t>(B) * a.nc; ++i) s += a.pa[i * a.H + h];
    a.dA[h] = s;
  }
}

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
  if (H < 1 || !fits<E>(P, N)) return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;     // the wrapper returns zeros itself
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  BwdArgs<E> a;
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
  const size_t bch = static_cast<size_t>(B) * a.nc * H;
  a.st = static_cast<float*>(scratch);
  a.sd = a.st + bch * P * N;
  a.pb = a.sd + bch * P * N;
  a.pc = a.pb + bch * T * N;
  a.ct = a.pc + bch * T * N;
  a.pa = a.ct + bch;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  constexpr int V = 16 / static_cast<int>(sizeof(E));
  a.vx = P % V == 0 && aligned(x) && aligned(dy);
  a.vn = N % V == 0 && aligned(Bm) && aligned(Cm);
  a.vh = N % 4 == 0 && aligned(scratch);

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
  const size_t total = static_cast<size_t>(B) * S * N;
  bwd_reduce<E><<<static_cast<unsigned>((total + RED - 1) / RED), RED, 0, st>>>(a, B);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dA<E><<<1, 128, 0, st>>>(a, B);
  return cudaGetLastError();
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

// floats of scratch a call needs (the wrapper allocates them)
extern "C" long long ssm_scan_bwd_scratch(int B, int S, int H, int P, int N) {
  return static_cast<long long>(scratch_floats(B, S, H, P, N));
}

// 1 if the kernels take head width P and state size N (bf16 when bf16 is
// nonzero, else fp32): N <= 128, P <= 256 and the chunk pass's tiles within
// a block's shared memory
extern "C" int ssm_scan_bwd_supported(int P, int N, int bf16) {
  return bf16 ? fits<__nv_bfloat16>(P, N) : fits<float>(P, N);
}

RT_EXPORT_ERROR_STRING(ssm_scan_bwd)
