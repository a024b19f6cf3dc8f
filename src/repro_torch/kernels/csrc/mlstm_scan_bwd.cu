// Backward of the chunked, stabilised mLSTM scan for Hopper.
//
// Replaces no TPU kernel: the reference has no backward kernel and trains
// xlstm through jax.grad of its plain chunked form (repro/models/ssm.py:155,
// _mlstm_chunked; jax.value_and_grad at repro/models/steps.py:44).  The port
// trains on the card through its kernels both ways, so the forward
// (mlstm_scan.cu, whose header states the function) needs this backward.
// It computes the gradient of y with respect to q, k, v, logi and logf for
// a given dy.
//
// y is invariant to the stabiliser (in unstabilised terms y = h / max(|nq|,
// 1)), so the stabiliser carries no gradient: every m is a constant, rerun
// by the forward's gates pass (mlstm.cuh), and no max is differentiated.
// Per (batch row, head) and chunk of T = 64 rows, with qs = q D^-1/2,
// W[t,s] = exp(bcum_t - bcum_s + li_s - m_row_t) (s <= t), gexp = exp(bcum +
// m_in - m_row), inj_s = exp(li_s + F - bcum_s - m_out), decay = exp(F +
// m_in - m_out) (F = bcum_T, m_out the next chunk's m_in):
//   P = (qs k^T) o W,  nq = rowsum P + gexp qs.n_in,  den = max(|nq|, exp(-m_row)),
//   r = 1 / den,  yd = dy . (P v + gexp qs C_in^T),
//   dnq = -yd r^2 sign(nq) where |nq| > exp(-m_row), else 0 (the floor binds),
//   dC_in = decay dC_out + (dy o gexp r)^T qs,  dn_in = decay dn_out + (gexp dnq)^T qs,
//   dP = (r dy v^T + dnq) o W,
//   dq = D^-1/2 (dP k + gexp (r dy C_in + dnq n_in)),
//   dk = dP^T qs + inj (v dC_out + dn_out),  dv = (P o r)^T dy + inj k dC_out^T,
// the states (C, n) and their gradients (dC, dn) stabilised at the chunk's
// m, as the forward's.  The gate gradients come from two identities (k_s
// enters only as exp(li_s) k_s, and the cumulative log forget gate F_t
// only as exp(F_t) q_t and exp(-F_t) k_t):
//   dlogi_s = <k_s, dk_s>,  dlogf_j = sum_{t >= j} (<q_t, dq_t> - <k_t, dk_t>),
// a reverse cumulative sum over the whole sequence.  Each dot is taken from
// its parts, with G = (r dy v^T + dnq) o P (the gradient of each pair's log
// weight): <k_s, dk_s> = colsum(G)_s + V_s and <q_t, dq_t> = rowsum(G)_t +
// R_t, V and R the dots of k and q with dk's and dq's state parts.  G's
// diagonal enters both sums of dF and is left out of them: under strong
// forgetting it is nearly all of each, and its two roundings would not
// cancel (ref.mlstm_scan_bwd_chunked_ref writes the passes in torch).
//
// Layout: q, k, v, dy (B,S,H,D) bf16 or fp32, one dtype; logi, logf (B,S,H)
// fp32; dq, dk, dv like q; dlogi, dlogf fp32.  D <= 1024.
//
// Eight launches a call (scratch the wrapper allocates,
// mlstm_scan_bwd_scratch floats):
//   1. mlstm_bwd_gates, a block per (row, head): every chunk's incoming m and the
//      last chunk's outgoing one.
//   2. mlstm_bwd_walk<fwd>, grid (D/16, H, B): a block owns 16 rows of C (fp32 in
//      shared memory) and all of n, walks the chunks in order and writes
//      each chunk's incoming (C, n) before the update (v o inj)^T k.
//   3. mlstm_bwd_chunk, grid (chunks, H, B): P, dy v^T (T x T) and nq.
//   4. mlstm_bwd_num, grid (D/64, chunks, B H): a 64-column slab of the read-out
//      P v + gexp qs C_in^T, and its dot with dy, per slab.
//   5. mlstm_bwd_rows, grid (chunks, H, B): r and dnq per row (the slabs' dots
//      summed in order).
//   6. mlstm_bwd_walk<rev>: the same walk in reverse from zero, writing each
//      chunk's outgoing (dC, dn) before the update (dy o gexp r)^T qs.
//   7. mlstm_bwd_grads, grid (D/64, chunks, B H): a 64-column slab of dq, dk, dv
//      (columns of q and k for dq and dk, of v for dv), the slab's parts of
//      R and V, and (slab 0) G's row and column sums and diagonal.
//   8. mlstm_bwd_gsum, a warp per (row, head): dlogi, and dlogf's sums over the
//      chunks in a fixed order (from the last chunk back to row S / 2; before
//      it, minus the sum of the rows before, as the dF sum to zero).
// Every sum runs in a fixed order (no atomics), so two calls on the same
// inputs give bit-equal gradients.  Rows past S enter with logi = -1e30,
// logf = 0 and q = k = v = dy = 0, as the forward pads: they add to no
// gradient.  The states are rerun (the walks) rather than saved by the
// forward: saving them would keep 4 nc H D^2 bytes a row per layer alive
// from the forward to the backward and change the forward's kernels.
//
// Products: every tile sits in shared memory as fp32.  bf16 inputs take the
// tensor cores (mma.sync, bf16 operands, fp32 sums): products of two bf16
// values exactly (q k^T, dy v^T), and every product with an fp32 operand
// (the states, P, dP, the coefficient-scaled rows) with that operand as two
// bf16 halves, hi + lo (common.cuh, prod_split); row scales (gexp r, inj)
// multiply the fp32 sums after a product.  fp32 inputs take every product
// as fp32 FMAs (warp_fma).  This first design favours plain tiles over
// speed: the walks run one 16 x 8 tile a warp per 64-column slice, and the
// slab passes restage the chunk's T x T matrices per slab.
//
// Work at xlstm's training shape, q (4,512,4,512) (T 64, 8 chunks, 128
// (row, head, chunk)): the two walks 2 T D^2 = 33.6 M flops a chunk each,
// the read-out q C^T 33.6 M, the three state products of the gradients
// 3 x 2 T D^2 = 101 M, the T x T products (q k^T, dy v^T, P v, dP k, dP^T
// q, P^T dy) 6 x 2 T^2 D = 25.2 M: 227 M a (row, head, chunk), 29.0 GFLOP
// a call, twice that on the tensor cores where an operand is split.  Bytes: the states and their gradients written once and read
// twice each (C_in by mlstm_bwd_num and mlstm_bwd_grads, dC_out by
// mlstm_bwd_grads twice): 6 x 134 MB, besides q, k, v, dy and the
// gradients.  The bound (chip_smoke.py) counts the sequential recurrence's
// backward state work, ~10 D^2 flops a token and head (21.5 GFLOP, 0.0217
// ms at the bf16 rate: operations bound it).  This design takes ~3.8 ms on
// an H100 (PERF.md §6): each walk steps its chunks' 64-column slices one
// after another at the latency of a load, a product and two barriers a
// slice, and the slab passes restage the chunk's matrices (ROADMAP P16).
#include "mlstm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::prod;
using rt::prod_split;
using rt::quad_sum;
using rt::to_f;

constexpr int T = 64;          // chunk rows
constexpr int NTH = 256;       // threads of the chunk and slab passes (eight warps)
constexpr int WNT = 256;       // threads of the walks
constexpr int SW = 64;         // columns of a slab or slice
constexpr int DR = 16;         // rows of C per walk block
constexpr int LD = rt::stride_gq(SW);   // row stride of a 64-wide fp32 tile
constexpr int DMAX = 1024;     // largest head dim
constexpr int SMEM_MAX = 232448;
static_assert(T == 64 && SW == 64, "the tiles are 64 x 64, eight warps of 16 x 32");
static_assert(WNT / 32 * 8 == SW, "the walks give each warp 8 columns of a slice");
static_assert(NTH == 256 && WNT == 256, "load_tile stages with 256 threads");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dy;
  const float* li;
  const float* lf;
  void* dq;
  void* dk;
  void* dv;
  float* dli;
  float* dlf;
  // scratch
  float* m;      // (B,H,nc+1)     the stabiliser entering each chunk, and leaving the last
  float* cst;    // (B,H,nc,D,D)   C entering each chunk
  float* nst;    // (B,H,nc,D)     n entering each chunk
  float* dcst;   // (B,H,nc,D,D)   dC leaving each chunk
  float* dnst;   // (B,H,nc,D)     dn leaving each chunk
  float* pm;     // (B,H,nc,T,T)   P
  float* dvm;    // (B,H,nc,T,T)   dy v^T
  float* nq;     // (B,H,nc,T)
  float* ydp;    // (B,H,nc,NSL,T) dy . read-out, per slab
  float* rr;     // (B,H,nc,T)     1 / den
  float* dnq;    // (B,H,nc,T)
  float* rp;     // (B,H,nc,NSL,T) R per slab
  float* vp;     // (B,H,nc,NSL,T) V per slab
  float* gs;     // (B,H,nc,3,T)   G's sums below and above the diagonal, and its diagonal
  int S, H, D, nc, nsl;
  float scale;
};

// Stage a 64 x 64 tile as fp32 in shared memory (row stride LD), by a block
// of 256 threads: dst[r][j] = src[r * rs + j] for r < rows, j < cols, else
// 0.  Each thread issues its 16 loads into registers before its stores, so
// they are in flight together (a loop of load-store pairs waits out the
// memory latency once per element: the stores to shared memory keep the
// compiler from hoisting the next load).
constexpr int kTileLoads = T * SW / 256;
template <typename E>
__device__ __forceinline__ void load_tile(float* dst, const E* src, size_t rs, int rows,
                                          int cols) {
  float v[kTileLoads];
#pragma unroll
  for (int i = 0; i < kTileLoads; ++i) {
    const int e = threadIdx.x + 256 * i, r = e / SW, j = e % SW;
    v[i] = (r < rows && j < cols) ? to_f(src[static_cast<size_t>(r) * rs + j]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kTileLoads; ++i) {
    const int e = threadIdx.x + 256 * i;
    dst[(e / SW) * LD + e % SW] = v[i];
  }
}

// A 64-element vector likewise: dst[j] = src[j] for j < cols, else 0.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int cols) {
  if (threadIdx.x < SW) dst[threadIdx.x] = threadIdx.x < cols ? src[threadIdx.x] : 0.f;
}

// The chunk's gates in shared memory (lis, bcum, mrow, gexp, inj: T each,
// by warp 0 then the block) from li/lf at the (row, head)'s first gate;
// returns the decay exp(F + m_in - m_out).  Ends with a barrier.
__device__ float chunk_gates(const Args& a, int b, int h, int c, float* lis, float* bcum,
                             float* mrow, float* gexp, float* inj) {
  const size_t hc = (static_cast<size_t>(b) * a.H + h) * (a.nc + 1);
  const float m_in = a.m[hc + c], m_out = a.m[hc + c + 1];
  if (threadIdx.x < 32) {
    const size_t goff = (static_cast<size_t>(b) * a.S + static_cast<size_t>(c) * T) * a.H + h;
    mlstm::warp_gates<T>(a.li + goff, a.lf + goff, a.H, min(T, a.S - c * T), lis, bcum);
    mlstm::warp_row_stab<T>(bcum, lis, m_in, mrow);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    gexp[t] = expf(bcum[t] + m_in - mrow[t]);
    inj[t] = expf(lis[t] + (bcum[T - 1] - bcum[t]) - m_out);
  }
  __syncthreads();
  return expf(bcum[T - 1] + m_in - m_out);
}

// The (row, head)'s offset into (B,S,H,D) and the chunk's into (B,H,nc,*).
__device__ __forceinline__ size_t head_off(const Args& a, int b, int h) {
  return static_cast<size_t>(b) * a.S * a.H * a.D + static_cast<size_t>(h) * a.D;
}
__device__ __forceinline__ size_t chunk_idx(const Args& a, int b, int h, int c) {
  return (static_cast<size_t>(b) * a.H + h) * a.nc + c;
}

// Per-row sums of a 64 x 64 tile held as eight warps' 16 x 32 fragments
// (warp w: rows 16 (w % 4), columns 32 (w / 4)): each fragment row's sum over
// its lanes, then the two column halves in order.  `red` holds 2 T floats;
// returns the row sum to thread t < T.  Ends with a barrier.
__device__ float row_sums(const float (&part)[2], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const int r0 = (warp & 3) * 16, ch = warp >> 2;
  const float p0 = quad_sum(part[0]), p1 = quad_sum(part[1]);
  if (q == 0) {
    red[ch * T + r0 + g] = p0;
    red[ch * T + r0 + g + 8] = p1;
  }
  __syncthreads();
  const float s = threadIdx.x < T ? red[threadIdx.x] + red[T + threadIdx.x] : 0.f;
  __syncthreads();
  return s;
}

// 1. The stabilisers, as the forward's gates pass, and the last chunk's
// outgoing one.
__global__ void __launch_bounds__(NTH) mlstm_bwd_gates(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t base = static_cast<size_t>(b) * a.S * a.H + h;
  mlstm::chunk_stabilisers<T>(a.li + base, a.lf + base, a.S, a.H, a.nc,
                              a.m + (static_cast<size_t>(b) * a.H + h) * (a.nc + 1), true,
                              reinterpret_cast<float*>(smem));
}

// 2 and 6. The walks: a block owns rows [d0, d0 + 16) of the (D, D) state
// (fp32 in shared memory) and all of the (D) vector.  Forward (REV false),
// chunk by chunk from zero: write (C, n) entering the chunk, then C = decay
// C + (v o inj)^T k, n = decay n + inj^T k.  In reverse, from zero: write
// (dC, dn) leaving the chunk, then dC = decay dC + (dy o gexp r D^-1/2)^T q,
// dn = decay dn + (gexp dnq D^-1/2)^T q.  The update's rows A (16 x T, fp32)
// enter the product as bf16 hi + lo; warp w owns columns 8w.. of each
// 64-column slice of q or k.
template <typename E, bool REV>
__global__ void __launch_bounds__(WNT) mlstm_bwd_walk(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LA = rt::stride_gq(T);
  const int D = a.D, DP = a.nsl * SW;
  const int d0 = blockIdx.x * DR, h = blockIdx.y, b = blockIdx.z;
  const int dw = min(DR, D - d0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  float* st = reinterpret_cast<float*>(smem);   // [DR][DP] the state's rows
  float* ns = st + DR * DP;                     // [DP]     the vector
  float* at = ns + DP;                          // [DR][LA] the update's rows
  float* bt = at + DR * LA;                     // [T][LD]  a slice of k or q
  float* lis = bt + T * LD;
  float* bcum = lis + T;
  float* mrow = bcum + T;
  float* gexp = mrow + T;
  float* inj = gexp + T;
  float* ca = inj + T;                          // the rows' coefficients
  float* cn = ca + T;                           // the vector's
  for (int e = threadIdx.x; e < DR * DP; e += WNT) st[e] = 0.f;
  for (int e = threadIdx.x; e < DP; e += WNT) ns[e] = 0.f;
  const size_t rs = static_cast<size_t>(a.H) * D, head = head_off(a, b, h);
  const E* srca = static_cast<const E*>(REV ? a.dy : a.v) + head;
  const E* srcb = static_cast<const E*>(REV ? a.q : a.k) + head;
  float* out = REV ? a.dcst : a.cst;
  float* outn = REV ? a.dnst : a.nst;
  for (int i = 0; i < a.nc; ++i) {
    const int c = REV ? a.nc - 1 - i : i;
    const int rows = min(T, a.S - c * T);
    const size_t ci = chunk_idx(a, b, h, c);
    __syncthreads();                            // the previous chunk's update is done
    const float decay = chunk_gates(a, b, h, c, lis, bcum, mrow, gexp, inj);
    float* o = out + ci * D * D + static_cast<size_t>(d0) * D;
    for (int e = threadIdx.x; e < dw * D; e += WNT) o[e] = st[(e / D) * DP + e % D];
    if (blockIdx.x == 0)
      for (int e = threadIdx.x; e < D; e += WNT) outn[ci * D + e] = ns[e];
    if (REV ? c == 0 : c == a.nc - 1) continue;
    for (int t = threadIdx.x; t < T; t += WNT) {
      if (REV) {
        ca[t] = gexp[t] * a.rr[ci * T + t] * a.scale;
        cn[t] = gexp[t] * a.dnq[ci * T + t] * a.scale;
      } else {
        ca[t] = cn[t] = inj[t];
      }
    }
    __syncthreads();
    const E* sa = srca + static_cast<size_t>(c) * T * rs + d0;
    float av[DR * T / WNT];                      // A[d][t] = src[t][d0 + d] ca_t
#pragma unroll
    for (int i = 0; i < DR * T / WNT; ++i) {
      const int e = threadIdx.x + WNT * i, d = e % DR, t = e / DR;
      av[i] = (t < rows && d < dw) ? to_f(sa[static_cast<size_t>(t) * rs + d]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < DR * T / WNT; ++i) {
      const int e = threadIdx.x + WNT * i, d = e % DR, t = e / DR;
      at[d * LA + t] = (t < rows && d < dw) ? av[i] * ca[t] : 0.f;
    }
    for (int j = 0; j < a.nsl; ++j) {
      const int e0 = j * SW;
      __syncthreads();                          // A is written; the slice's readers are done
      load_tile<E>(bt, srcb + static_cast<size_t>(c) * T * rs + e0, rs, rows, D - e0);
      __syncthreads();
      float acc[1][4] = {};
      prod_split<E, true, 1>(acc, 0, T, [&](int r, int k) { return at[r * LA + k]; },
                             [&](int k, int n) { return bt[k * LD + 8 * warp + n]; });
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* p = st + (g + 8 * half) * DP + e0 + 8 * warp + 2 * q;
        p[0] = decay * p[0] + acc[0][2 * half];
        p[1] = decay * p[1] + acc[0][2 * half + 1];
      }
      if (threadIdx.x < SW) {
        float s = 0.f;
        for (int t = 0; t < T; ++t) s = fmaf(cn[t], bt[t * LD + threadIdx.x], s);
        ns[e0 + threadIdx.x] = decay * ns[e0 + threadIdx.x] + s;
      }
    }
  }
}

// 3. Per chunk: P = (q k^T) D^-1/2 o W and dy v^T (T x T, over 64-column
// slices of q, k, dy, v), and nq = rowsum P + gexp D^-1/2 q . n_in.  Warp w
// owns rows 16 (w % 4) and columns 32 (w / 4) of both.
template <typename E>
__global__ void __launch_bounds__(NTH) mlstm_bwd_chunk(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, D = a.D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const int r0 = (warp & 3) * 16, n0 = (warp >> 2) * 32, rows = min(T, a.S - c * T);
  float* qt = reinterpret_cast<float*>(smem);
  float* kt = qt + T * LD;
  float* yt = kt + T * LD;
  float* vt = yt + T * LD;
  float* nsl = vt + T * LD;                     // [SW] a slice of n_in
  float* lis = nsl + SW;
  float* bcum = lis + T;
  float* mrow = bcum + T;
  float* gexp = mrow + T;
  float* inj = gexp + T;
  float* red = inj + T;                         // [2][T]
  chunk_gates(a, b, h, c, lis, bcum, mrow, gexp, inj);
  const size_t rs = static_cast<size_t>(a.H) * D;
  const size_t off = head_off(a, b, h) + static_cast<size_t>(c) * T * rs;
  const size_t ci = chunk_idx(a, b, h, c);
  float sacc[4][4] = {}, dacc[4][4] = {}, qn = 0.f;
  for (int e0 = 0; e0 < D; e0 += SW) {
    const int cols = min(SW, D - e0);
    __syncthreads();                            // the previous slice's readers are done
    load_tile<E>(qt, static_cast<const E*>(a.q) + off + e0, rs, rows, cols);
    load_tile<E>(kt, static_cast<const E*>(a.k) + off + e0, rs, rows, cols);
    load_tile<E>(yt, static_cast<const E*>(a.dy) + off + e0, rs, rows, cols);
    load_tile<E>(vt, static_cast<const E*>(a.v) + off + e0, rs, rows, cols);
    load_vec(nsl, a.nst + ci * D + e0, cols);
    __syncthreads();
    prod<E, 4>(sacc, 0, SW, [&](int r, int k) { return qt[(r0 + r) * LD + k]; },
               [&](int k, int n) { return kt[(n0 + n) * LD + k]; });
    prod<E, 4>(dacc, 0, SW, [&](int r, int k) { return yt[(r0 + r) * LD + k]; },
               [&](int k, int n) { return vt[(n0 + n) * LD + k]; });
    if (threadIdx.x < T)
      for (int e = 0; e < SW; ++e) qn = fmaf(qt[threadIdx.x * LD + e], nsl[e], qn);
  }
  float* pm = a.pm + ci * T * T;
  float* dvm = a.dvm + ci * T * T;
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = r0 + g + 8 * half;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = n0 + 8 * j + 2 * q + e;
        const float p = s <= t ? sacc[j][2 * half + e] * a.scale *
                                     expf(bcum[t] - bcum[s] + lis[s] - mrow[t])
                               : 0.f;
        pm[t * T + s] = p;
        dvm[t * T + s] = dacc[j][2 * half + e];
        part[half] += p;
      }
    }
  }
  const float rsum = row_sums(part, red);
  if (threadIdx.x < T)
    a.nq[ci * T + threadIdx.x] = rsum + gexp[threadIdx.x] * a.scale * qn;
}

// 4. A 64-column slab of the read-out, P v + gexp D^-1/2 q C_in^T (q C_in^T
// over 64-column slices of q and of the slab's rows of C_in), and its dot
// with dy per row.  Warp w owns rows 16 (w % 4), columns 32 (w / 4).
template <typename E>
__global__ void __launch_bounds__(NTH) mlstm_bwd_num(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int j = blockIdx.x, c = blockIdx.y, h = blockIdx.z % a.H, b = blockIdx.z / a.H;
  const int D = a.D, d0 = j * SW, dcols = min(SW, D - d0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const int r0 = (warp & 3) * 16, n0 = (warp >> 2) * 32, rows = min(T, a.S - c * T);
  float* pt = reinterpret_cast<float*>(smem);
  float* vt = pt + T * LD;
  float* yt = vt + T * LD;
  float* qt = yt + T * LD;
  float* ct = qt + T * LD;                      // [SW][LD] C_in[d0 + i][e0 + e]
  float* lis = ct + SW * LD;
  float* bcum = lis + T;
  float* mrow = bcum + T;
  float* gexp = mrow + T;
  float* inj = gexp + T;
  float* red = inj + T;
  chunk_gates(a, b, h, c, lis, bcum, mrow, gexp, inj);
  const size_t rs = static_cast<size_t>(a.H) * D;
  const size_t off = head_off(a, b, h) + static_cast<size_t>(c) * T * rs;
  const size_t ci = chunk_idx(a, b, h, c);
  load_tile<float>(pt, a.pm + ci * T * T, T, T, T);
  load_tile<E>(vt, static_cast<const E*>(a.v) + off + d0, rs, rows, dcols);
  load_tile<E>(yt, static_cast<const E*>(a.dy) + off + d0, rs, rows, dcols);
  __syncthreads();
  float iacc[4][4] = {}, sacc[4][4] = {};
  prod_split<E, true, 4>(iacc, 0, T, [&](int r, int k) { return pt[(r0 + r) * LD + k]; },
                         [&](int k, int n) { return vt[k * LD + n0 + n]; });
  const float* cin = a.cst + ci * D * D + static_cast<size_t>(d0) * D;
  for (int e0 = 0; e0 < D; e0 += SW) {
    const int cols = min(SW, D - e0);
    __syncthreads();
    load_tile<E>(qt, static_cast<const E*>(a.q) + off + e0, rs, rows, cols);
    load_tile<float>(ct, cin + e0, D, dcols, cols);
    __syncthreads();
    prod_split<E, false, 4>(sacc, 0, SW, [&](int r, int k) { return qt[(r0 + r) * LD + k]; },
                            [&](int k, int n) { return ct[(n0 + n) * LD + k]; });
  }
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = r0 + g + 8 * half;
      const float gs = gexp[t] * a.scale;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n0 + 8 * jj + 2 * q + e;
        part[half] += yt[t * LD + d] * (iacc[jj][2 * half + e] + gs * sacc[jj][2 * half + e]);
      }
    }
  }
  const float yd = row_sums(part, red);
  if (threadIdx.x < T) a.ydp[(ci * a.nsl + j) * T + threadIdx.x] = yd;
}

// 5. Per row: r = 1 / max(|nq|, exp(-m_row)) and dnq = -yd r^2 sign(nq)
// where |nq| > exp(-m_row), else 0; yd the slabs' dots summed in order.
__global__ void __launch_bounds__(T) mlstm_bwd_rows(Args a) {
  __shared__ float lis[T], bcum[T], mrow[T], gexp[T], inj[T];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  chunk_gates(a, b, h, c, lis, bcum, mrow, gexp, inj);
  const size_t ci = chunk_idx(a, b, h, c);
  float yd = 0.f;
  for (int j = 0; j < a.nsl; ++j) yd += a.ydp[(ci * a.nsl + j) * T + t];
  const float nq = a.nq[ci * T + t], floor = expf(-mrow[t]);
  const float r = 1.f / fmaxf(fabsf(nq), floor);
  a.rr[ci * T + t] = r;
  a.dnq[ci * T + t] = fabsf(nq) > floor ? -yd * r * r * (nq > 0.f ? 1.f : -1.f) : 0.f;
}

// 7. A 64-column slab of the gradients: columns [j0, j0 + 64) of q and k
// (dq, dk) and of v (dv).  The chunk's terms from dP = (r dy v^T + dnq) o W
// and P o r; the state terms streamed over 64-column slices: dy C_in and v
// dC_out over the rows of the states (the slab's columns), k dC_out^T over
// their columns (the slab's rows).  Writes the slab's parts of R = q . dq's
// state part and V = k . dk's state part, and in slab 0 G's sums.  Warp w
// owns rows 16 (w % 4), columns 32 (w / 4) of each output.
template <typename E>
__global__ void __launch_bounds__(NTH) mlstm_bwd_grads(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int j = blockIdx.x, c = blockIdx.y, h = blockIdx.z % a.H, b = blockIdx.z / a.H;
  const int D = a.D, j0 = j * SW, jcols = min(SW, D - j0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const int r0 = (warp & 3) * 16, n0 = (warp >> 2) * 32, rows = min(T, a.S - c * T);
  float* dpt = reinterpret_cast<float*>(smem);  // [T][LD] dP
  float* prt = dpt + T * LD;                    // [T][LD] P o r
  float* qt = prt + T * LD;                     // [T][LD] the slab of q, k
  float* kt = qt + T * LD;
  float* xt = kt + T * LD;                      // [T][LD] a slice of dy, v or k (first: G)
  float* ct = xt + T * LD;                      // [SW][LD] a slice of C_in or dC_out (first:
                                                // the slab of dy)
  float* nin = ct + SW * LD;                    // [SW] the slab of n_in
  float* dno = nin + SW;                        // [SW] the slab of dn_out
  float* lis = dno + SW;
  float* bcum = lis + T;
  float* mrow = bcum + T;
  float* gexp = mrow + T;
  float* inj = gexp + T;
  float* rr = inj + T;
  float* dnq = rr + T;
  float* red = dnq + T;                         // [2][T]
  chunk_gates(a, b, h, c, lis, bcum, mrow, gexp, inj);
  const size_t rs = static_cast<size_t>(a.H) * D;
  const size_t off = head_off(a, b, h) + static_cast<size_t>(c) * T * rs;
  const size_t ci = chunk_idx(a, b, h, c);
  for (int t = threadIdx.x; t < T; t += NTH) {
    rr[t] = a.rr[ci * T + t];
    dnq[t] = a.dnq[ci * T + t];
  }
  load_tile<float>(prt, a.pm + ci * T * T, T, T, T);
  load_tile<float>(dpt, a.dvm + ci * T * T, T, T, T);
  load_tile<E>(qt, static_cast<const E*>(a.q) + off + j0, rs, rows, jcols);
  load_tile<E>(kt, static_cast<const E*>(a.k) + off + j0, rs, rows, jcols);
  load_vec(nin, a.nst + ci * D + j0, jcols);
  load_vec(dno, a.dnst + ci * D + j0, jcols);
  __syncthreads();
  // dP = (r DV + dnq) o W, G = (r DV + dnq) o P (slab 0), P o r
  for (int e = threadIdx.x; e < T * T; e += NTH) {
    const int t = e / T, s = e % T;
    const float ds = rr[t] * dpt[t * LD + s] + dnq[t];
    const float w = s <= t ? expf(bcum[t] - bcum[s] + lis[s] - mrow[t]) : 0.f;
    if (j == 0) xt[t * LD + s] = s <= t ? ds * prt[t * LD + s] : 0.f;
    dpt[t * LD + s] = ds * w;
    prt[t * LD + s] *= rr[t];
  }
  __syncthreads();
  if (j == 0 && threadIdx.x < T) {              // G's sums, each in a fixed order
    const int t = threadIdx.x;
    float below = 0.f, above = 0.f;
    for (int s = 0; s < t; ++s) below += xt[t * LD + s];
    for (int u = t + 1; u < T; ++u) above += xt[u * LD + t];
    float* gs = a.gs + ci * 3 * T;
    gs[t] = below;
    gs[T + t] = above;
    gs[2 * T + t] = xt[t * LD + t];
  }
  // the chunk's terms
  __syncthreads();                              // G's readers are done
  load_tile<E>(ct, static_cast<const E*>(a.dy) + off + j0, rs, rows, jcols);
  __syncthreads();
  float aq[4][4] = {}, ak[4][4] = {}, av[4][4] = {};
  prod_split<E, true, 4>(aq, 0, T, [&](int r, int k) { return dpt[(r0 + r) * LD + k]; },
                         [&](int k, int n) { return kt[k * LD + n0 + n]; });
  prod_split<E, true, 4>(ak, 0, T, [&](int r, int k) { return dpt[k * LD + r0 + r]; },
                         [&](int k, int n) { return qt[k * LD + n0 + n]; });
  prod_split<E, true, 4>(av, 0, T, [&](int r, int k) { return prt[k * LD + r0 + r]; },
                         [&](int k, int n) { return ct[k * LD + n0 + n]; });
  // the state terms: dy C_in[:, slab], v dC_out[:, slab] (over the states'
  // rows), k dC_out[slab, :]^T (over their columns)
  float sq[4][4] = {}, sk[4][4] = {}, sv[4][4] = {};
  const float* cin = a.cst + ci * D * D;
  const float* dco = a.dcst + ci * D * D;
  for (int p = 0; p < 3; ++p) {
    const E* src = static_cast<const E*>(p == 0 ? a.dy : p == 1 ? a.v : a.k) + off;
    for (int e0 = 0; e0 < D; e0 += SW) {
      const int cols = min(SW, D - e0);
      __syncthreads();                          // the previous slice's (and G's) readers are done
      load_tile<E>(xt, src + e0, rs, rows, cols);
      if (p < 2)                                // rows e0.. of the state, the slab's columns
        load_tile<float>(ct, (p == 0 ? cin : dco) + static_cast<size_t>(e0) * D + j0, D,
                         cols, jcols);
      else                                      // the slab's rows, columns e0..
        load_tile<float>(ct, dco + static_cast<size_t>(j0) * D + e0, D, jcols, cols);
      __syncthreads();
      const auto xa = [&](int r, int k) { return xt[(r0 + r) * LD + k]; };
      if (p == 0)
        prod_split<E, false, 4>(sq, 0, SW, xa, [&](int k, int n) { return ct[k * LD + n0 + n]; });
      else if (p == 1)
        prod_split<E, false, 4>(sk, 0, SW, xa, [&](int k, int n) { return ct[k * LD + n0 + n]; });
      else
        prod_split<E, false, 4>(sv, 0, SW, xa, [&](int k, int n) { return ct[(n0 + n) * LD + k]; });
    }
  }
  E* dq = static_cast<E*>(a.dq) + off + j0;
  E* dk = static_cast<E*>(a.dk) + off + j0;
  E* dv = static_cast<E*>(a.dv) + off + j0;
  float pr[2] = {0.f, 0.f}, pv[2] = {0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = r0 + g + 8 * half;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * jj + 2 * q + e, x = 2 * half + e;
        const float qst = a.scale * gexp[t] * (rr[t] * sq[jj][x] + dnq[t] * nin[col]);
        const float kst = inj[t] * (sk[jj][x] + dno[col]);
        pr[half] += qt[t * LD + col] * qst;
        pv[half] += kt[t * LD + col] * kst;
        if (t < rows && col < jcols) {
          const size_t o = static_cast<size_t>(t) * rs + col;
          dq[o] = rt::from_f<E>(a.scale * aq[jj][x] + qst);
          dk[o] = rt::from_f<E>(a.scale * ak[jj][x] + kst);
          dv[o] = rt::from_f<E>(av[jj][x] + inj[t] * sv[jj][x]);
        }
      }
    }
  }
  const float R = row_sums(pr, red);
  const float V = row_sums(pv, red);
  if (threadIdx.x < T) {
    a.rp[(ci * a.nsl + j) * T + threadIdx.x] = R;
    a.vp[(ci * a.nsl + j) * T + threadIdx.x] = V;
  }
}

// Row t's (t = 2 lane + i) dlogi and dF in chunk ci: dlogi = diag + above
// + V and dF = below + R - above - V (R and V the slabs' parts summed in
// order).
__device__ __forceinline__ void gate_rows(const Args& a, size_t ci, float (&li2)[2],
                                          float (&df)[2]) {
  const float* gs = a.gs + ci * 3 * T;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = 2 * (threadIdx.x & 31) + i;
    float R = 0.f, V = 0.f;
    for (int j = 0; j < a.nsl; ++j) {
      R += a.rp[(ci * a.nsl + j) * T + t];
      V += a.vp[(ci * a.nsl + j) * T + t];
    }
    li2[i] = gs[2 * T + t] + gs[T + t] + V;
    df[i] = gs[t] + R - gs[T + t] - V;
  }
}

// 8. The gates, a warp per (row, head), two rows a lane: dlogi, and dlogf_j
// = sum_{t >= j} dF_t from the last chunk back to row S / 2; the dF sum to
// zero (a shift of every cumulative forget gate moves no weight), so the
// rows before S / 2 take minus the sum before them, from the first chunk on
// (each sum over at most half the rows; dlogf_0 exactly 0).  The lanes'
// totals are scanned in a fixed order.
__global__ void __launch_bounds__(32) mlstm_bwd_gsum(Args a) {
  const int h = blockIdx.x, b = blockIdx.y, lane = threadIdx.x, half = a.S / 2;
  float li2[2], df[2], carry = 0.f;
  for (int c = 0; c * T < half; ++c) {          // the sums before each row
    gate_rows(a, chunk_idx(a, b, h, c), li2, df);
    const float tot = df[0] + df[1];
    float incl = tot;                           // the sum over lanes <= this one
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    const float before = incl - tot + carry;
    carry += __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = c * T + 2 * lane + i;
      if (row < half)
        a.dlf[(static_cast<size_t>(b) * a.S + row) * a.H + h] = -(i == 0 ? before
                                                                       : before + df[0]);
    }
  }
  carry = 0.f;
  for (int c = a.nc - 1; c >= 0; --c) {         // the sums from each row, and dlogi
    gate_rows(a, chunk_idx(a, b, h, c), li2, df);
    const float s1 = df[1], s0 = df[0] + df[1];  // the lane's suffix sums
    float incl = s0;                            // the sum over lanes >= this one
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += u;
    }
    const float after = incl - s0 + carry;
    carry += __shfl_sync(0xffffffffu, incl, 0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = c * T + 2 * lane + i;
      if (row < a.S) {
        const size_t o = (static_cast<size_t>(b) * a.S + row) * a.H + h;
        a.dli[o] = li2[i];
        if (row >= half) a.dlf[o] = (i == 0 ? s0 : s1) + after;
      }
    }
  }
}

size_t walk_smem(int D) {
  const size_t dp = (static_cast<size_t>(D) + SW - 1) / SW * SW;
  return sizeof(float) * (DR * dp + dp + DR * rt::stride_gq(T) + T * LD + 7 * T);
}
constexpr size_t kChunkSmem = sizeof(float) * (4 * T * LD + SW + 7 * T);
constexpr size_t kNumSmem = sizeof(float) * (5 * T * LD + 7 * T);
constexpr size_t kGradsSmem = sizeof(float) * (6 * T * LD + 2 * SW + 9 * T);
static_assert(2 * kGradsSmem <= 227 * 1024, "two gradient blocks fit an SM");

size_t scratch_floats(int B, int S, int H, int D) {
  const size_t nc = (static_cast<size_t>(S) + T - 1) / T;
  const size_t nsl = (static_cast<size_t>(D) + SW - 1) / SW;
  const size_t bh = static_cast<size_t>(B) * H, d = D;
  return bh * (nc + 1) + bh * nc * (2 * d * d + 2 * d + 2 * T * T + 6 * T + 3 * nsl * T);
}

static_assert(sizeof(float) * (DR * DMAX + DMAX + DR * rt::stride_gq(T) + T * LD + 7 * T) <=
                  SMEM_MAX, "the walk's rows of the state fit a block at every head dim");

template <typename E>
struct Limits {
  static std::atomic<int> walk[32], rwalk[32], chunk[32], num[32], grads[32], gates[32];
};
template <typename E> std::atomic<int> Limits<E>::walk[32];
template <typename E> std::atomic<int> Limits<E>::rwalk[32];
template <typename E> std::atomic<int> Limits<E>::chunk[32];
template <typename E> std::atomic<int> Limits<E>::num[32];
template <typename E> std::atomic<int> Limits<E>::grads[32];
template <typename E> std::atomic<int> Limits<E>::gates[32];

template <typename E>
int launch(const void* q, const void* k, const void* v, const void* li, const void* lf,
           const void* dy, void* dq, void* dk, void* dv, void* dli, void* dlf, void* scratch,
           int B, int S, int H, int D, float scale, void* stream) {
  if (D < 1 || D > DMAX || H < 1) return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  Args a;
  a.q = q, a.k = k, a.v = v, a.dy = dy;
  a.li = static_cast<const float*>(li);
  a.lf = static_cast<const float*>(lf);
  a.dq = dq, a.dk = dk, a.dv = dv;
  a.dli = static_cast<float*>(dli);
  a.dlf = static_cast<float*>(dlf);
  a.S = S, a.H = H, a.D = D, a.nc = (S + T - 1) / T, a.nsl = (D + SW - 1) / SW;
  a.scale = scale;
  const size_t bh = static_cast<size_t>(B) * H, bhc = bh * a.nc, d = D;
  a.m = static_cast<float*>(scratch);
  a.cst = a.m + bh * (a.nc + 1);
  a.dcst = a.cst + bhc * d * d;
  a.nst = a.dcst + bhc * d * d;
  a.dnst = a.nst + bhc * d;
  a.pm = a.dnst + bhc * d;
  a.dvm = a.pm + bhc * T * T;
  a.nq = a.dvm + bhc * T * T;
  a.rr = a.nq + bhc * T;
  a.dnq = a.rr + bhc * T;
  a.ydp = a.dnq + bhc * T;
  a.rp = a.ydp + bhc * a.nsl * T;
  a.vp = a.rp + bhc * a.nsl * T;
  a.gs = a.vp + bhc * a.nsl * T;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t s0 = sizeof(float) * (2 * static_cast<size_t>(a.nc) + 2 * T * (NTH / 32));
  if (s0 > SMEM_MAX) return cudaErrorInvalidValue;          // S beyond ~1.8 M rows
  const int sw = static_cast<int>(walk_smem(D));
  using L = Limits<E>;
  cudaError_t err;
  if ((err = rt::smem_at_least(mlstm_bwd_gates, static_cast<int>(s0), L::gates)) ||
      (err = rt::smem_at_least(mlstm_bwd_walk<E, false>, sw, L::walk)) ||
      (err = rt::smem_at_least(mlstm_bwd_walk<E, true>, sw, L::rwalk)) ||
      (err = rt::smem_at_least(mlstm_bwd_chunk<E>, static_cast<int>(kChunkSmem), L::chunk)) ||
      (err = rt::smem_at_least(mlstm_bwd_num<E>, static_cast<int>(kNumSmem), L::num)) ||
      (err = rt::smem_at_least(mlstm_bwd_grads<E>, static_cast<int>(kGradsSmem), L::grads)))
    return err;
  const dim3 walk((D + DR - 1) / DR, H, B), chunks(a.nc, H, B), slabs(a.nsl, a.nc, B * H);
  mlstm_bwd_gates<<<dim3(H, B), NTH, s0, st>>>(a);
  mlstm_bwd_walk<E, false><<<walk, WNT, sw, st>>>(a);
  mlstm_bwd_chunk<E><<<chunks, NTH, kChunkSmem, st>>>(a);
  mlstm_bwd_num<E><<<slabs, NTH, kNumSmem, st>>>(a);
  mlstm_bwd_rows<<<chunks, T, 0, st>>>(a);
  mlstm_bwd_walk<E, true><<<walk, WNT, sw, st>>>(a);
  mlstm_bwd_grads<E><<<slabs, NTH, kGradsSmem, st>>>(a);
  mlstm_bwd_gsum<<<dim3(H, B), 32, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mlstm_scan_bwd_bf16(const void* q, const void* k, const void* v, const void* li,
                                   const void* lf, const void* dy, void* dq, void* dk, void* dv,
                                   void* dli, void* dlf, void* scratch, int B, int S, int H, int D,
                                   float scale, void* stream) {
  return launch<bf16>(q, k, v, li, lf, dy, dq, dk, dv, dli, dlf, scratch, B, S, H, D, scale,
                      stream);
}

extern "C" int mlstm_scan_bwd_f32(const void* q, const void* k, const void* v, const void* li,
                                  const void* lf, const void* dy, void* dq, void* dk, void* dv,
                                  void* dli, void* dlf, void* scratch, int B, int S, int H, int D,
                                  float scale, void* stream) {
  return launch<float>(q, k, v, li, lf, dy, dq, dk, dv, dli, dlf, scratch, B, S, H, D, scale,
                       stream);
}

// floats of scratch a call needs (the wrapper allocates them)
extern "C" long long mlstm_scan_bwd_scratch(int B, int S, int H, int D) {
  return static_cast<long long>(scratch_floats(B, S, H, D));
}

RT_EXPORT_ERROR_STRING(mlstm_scan_bwd)
