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
// cancel (ref.mlstm_scan_bwd_chunked_ref writes the mma.sync passes in
// torch, ref.mlstm_scan_bwd_walk_ref the wgmma passes' order).
//
// Layout: q, k, v, dy (B,S,H,D) bf16 or fp32, one dtype; logi, logf (B,S,H)
// fp32; dq, dk, dv like q; dlogi, dlogf fp32.  D <= 1024.  The passes
// follow from the shape alone: bf16 at D 512 (xlstm's) takes the wgmma
// passes (namespace tc), every other bf16 D and fp32 the mma.sync / FMA
// passes.  Scratch: the wrapper allocates mlstm_scan_bwd_scratch floats.
//
// bf16 at D 512, the wgmma passes (five launches):
//   1. mlstm_bwd_tc_gates, a block per (row, head): the stabilisers, then a
//      warp per chunk: every row's li, bcum, m_row, gexp and inj, and the
//      chunk's decay, once, into scratch.
//   2. mlstm_bwd_tc_walk<fwd>, grid (D/64, H, B), two warpgroups: a block owns
//      a 64-column slab of C, all 512 rows, held transposed as a wgmma
//      accumulator (C^T: 64 x 256 a warpgroup, 128 fp32 registers a thread).
//      Per chunk, u^T = C_in^T dy^T on the slab (C_in as bf16 hi and lo
//      register fragments, dy read K-major; the two warpgroups' halves summed
//      in shared memory in order), then C^T <- decay C^T + (k o inj)^T v
//      ((k o inj)^T as hi and lo fragments, v read MN-major).  Writes u (the
//      read-out's dy . C_in q^T and dq's state part both come from it, so C_in
//      is never written), n_in, and the slab's q . u and q . n_in.  n is
//      carried beside the slab, 64 threads a chunk.
//   3. mlstm_bwd_tc_chunk, grid (chunks, H, B), two warpgroups: S = q k^T and
//      DV = dy v^T (warpgroup 0, rows t) and their transposes (1, rows s), over
//      eight 64-column slices; the rows: nq = rowsum P + gexp D^-1/2 q . n_in
//      and yd = rowsum(P o DV) + gexp D^-1/2 q . u, r and dnq (for the reverse
//      walk), R; dP, (P o r)^T and G's sums; then per 64 columns dq = D^-1/2
//      (dP k + gexp (r u + dnq n_in)) (0), dk's and dv's chunk parts D^-1/2
//      dP^T q and (P o r)^T dy (1, fp32 into scratch).
//   4. mlstm_bwd_tc_walk<rev>, grid (2 D/64, H, B): the same walk in reverse
//      from zero, in both orientations (design (b)): blocks below D/64 hold a
//      slab of dC^T (dC^T <- decay dC^T + (q o g)^T dy, g = gexp r D^-1/2) and
//      take dk = its chunk part + inj (v dC_out + dn_out) and V, the slab's
//      k . (dk's state part), with dn carried beside; the others a slab of
//      dC's rows (dC <- decay dC + (dy o g)^T q) and take dv = its chunk part
//      + inj k dC_out^T whole.  No dC is written.
//   5. mlstm_bwd_gsum, as below (R whole, V by slab).
// A walk's X tile (64 x 512 bf16) loads while the update and the stores run,
// its Z tile and slabs while the next chunk's product runs (cp.async).
// The other design timed against this one, (a): the reverse walk in one
// orientation, dv's state part as per-slab partials through scratch (the
// dC^T slab through shared memory as hi and lo planes, 64 rows at a time,
// times k's slab; a last pass summed the slabs), took 0.4833 ms at the
// training shape against (b)'s 0.4314, 0.2377 against 0.1657 at q
// (4,256,2,512) and 3.0546 against 1.8424 at 1 x 4096 (an H100 80GB HBM3,
// tools/kernel_variants.py, one run) and was dropped.
//
// Work at xlstm's training shape, q (4,512,4,512) (8 chunks, 128 (row,
// head, chunk), 8 slabs; a split product counted twice): each walk
// orientation 2 x 2 x 2 T D^2 = 16.8 M flops a slab-chunk, 17.2 G; the chunk
// pass 4 x 2 T^2 D + 3 x 2 x 2 T^2 D = 42 M a chunk, 5.4 G: 57 GFLOP on
// wgmma, 0.058 ms at the bf16 rate.  Bytes: q, k, v, dy read and dq, dk, dv
// written once (29.4 MB); u, dk's and dv's chunk parts (fp32, 50.3 MB of
// scratch, the mma.sync passes' 274 MB) each written once and read once; the walks'
// tiles come again from L2 for each of a row's eight slabs: ~0.13 GB of
// device memory, 0.039 ms at 3.35 TB/s.  The bound (chip_smoke.py) counts
// the sequential recurrence's backward state work, ~10 D^2 flops a token and
// head (21.5 GFLOP, 0.0217 ms: operations bound it).  What holds the passes
// above it is the walks' 8 chunks in sequence on 128 and 256 blocks (one an
// SM): a chunk's two products, its stores and its barriers are latency.
//
// Every other width, and fp32 (eight launches):
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
// In both paths every sum runs in a fixed order (no atomics), so two calls
// on the same inputs give bit-equal gradients.  Rows past S enter with logi = -1e30,
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
// gradients.  These passes took 3.8144 ms
// at the training shape on an H100 (PERF.md §6): each walk steps its
// chunks' 64-column slices one after another at the latency of a load, a
// product and two barriers a slice, and the slab passes restage the
// chunk's matrices.
#include "mlstm.cuh"
#include "wgmma.cuh"

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
  float* rp;     // (B,H,nc,NRP,T) R per slab (the wgmma passes: NRP 1, R whole)
  float* vp;     // (B,H,nc,NSL,T) V per slab
  float* gs;     // (B,H,nc,3,T)   G's sums below and above the diagonal, and its diagonal
  // the wgmma passes' scratch (cst, nst, dcst, dnst, pm, dvm, ydp unused)
  float* gv;     // (B,H,nc,5,T)   per row: li, bcum, m_row, gexp, inj
  float* dec;    // (B,H,nc)       the decay
  float* u;      // (B,H,nc,T,D)   dy C_in
  float* nin;    // (B,H,nc,D)     n entering each chunk
  float* qu;     // (B,H,nc,NSL,T) q . u per slab
  float* qn;     // (B,H,nc,NSL,T) q . n_in per slab
  float* dkc;    // (B,H,nc,T,D)   dk's chunk part
  float* dvc;    // (B,H,nc,T,D)   dv's chunk part
  int S, H, D, nc, nsl, nrp;
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
    a.rp[(ci * a.nrp + j) * T + threadIdx.x] = R;
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
    for (int j = 0; j < a.nrp; ++j) R += a.rp[(ci * a.nrp + j) * T + t];
    for (int j = 0; j < a.nsl; ++j) V += a.vp[(ci * a.nsl + j) * T + t];
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

// ---------------------------------------------------------------------------
// bf16 at head dim 512: the passes on wgmma (namespace tc; the header's design).
// ---------------------------------------------------------------------------
namespace tc {

constexpr int DH = 512;           // the head dim these passes take
constexpr int WT = 256;           // threads of the walks and the chunk pass: two warpgroups
constexpr int NW = DH / 2 / 64;   // 64-column sub-tiles of a walk's state per warpgroup
constexpr int KSL = 64;           // columns of a chunk-pass slice
constexpr int NK = DH / KSL;      // slices of a row
constexpr int YW = 72;            // row stride (bf16) of a walk's plain 64-column slab
constexpr int OW = 65;            // row stride (fp32) of a walk's product tile
static_assert(NK % 2 == 0, "the chunk pass's second sweep starts on ring stage 0");
static_assert(KSL % 64 == 0, "the chunk pass's second sweep takes 64-column pieces");

using sm90::frags;
using sm90::split2;
using sm90::zero;

// acc (64 x 64) += A B^T over KSL columns, both K-major (Layout<KSL>, 64-row
// tiles at a_addr and b_addr).  Issued, not fenced, not committed.
__device__ __forceinline__ void ss_acc(float (&acc)[32], uint32_t a_addr, uint32_t b_addr) {
  constexpr int RB = sm90::Layout<KSL>::RB;
  const uint64_t da = sm90::desc<KSL>(a_addr), db = sm90::desc<KSL>(b_addr);
#pragma unroll
  for (int kk = 0; kk < KSL / 16; ++kk) {
    const uint32_t o = kk * 32 / RB * T * RB + kk * 32 % RB;
    sm90::wgmma_ss(acc, sm90::desc_at(da, o), sm90::desc_at(db, o), 1);
  }
}

// acc (64 x 64) += A B: A register fragments (K 64), B the 64-column sub-tile
// pc of a 64-row tile of KSL columns at b_addr, read MN-major.
__device__ __forceinline__ void rs_piece(float (&acc)[32], const uint32_t (&a)[4][4],
                                         uint32_t b_addr, int pc) {
  constexpr int RB = sm90::Layout<KSL>::RB;
  const uint64_t db = sm90::desc<KSL>(b_addr);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs(acc, a[kk], sm90::desc_at(db, pc * T * RB + kk * 16 * RB));
}

// 1. The gates, a block per (row, head): the stabilisers as the forward's
// gates pass, then per chunk (a warp each) the rows' li, bcum, m_row, gexp
// and inj, and the decay.
__global__ void __launch_bounds__(WT) mlstm_bwd_tc_gates(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  const int h = blockIdx.x, b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = static_cast<size_t>(b) * a.S * a.H + h;
  float* m = a.m + (static_cast<size_t>(b) * a.H + h) * (a.nc + 1);
  mlstm::chunk_stabilisers<T>(a.li + base, a.lf + base, a.S, a.H, a.nc, m, true, sm);
  __syncthreads();
  float* lis = sm + 2 * a.nc + warp * 2 * T;
  float* bcum = lis + T;
  float* mrow = sm + 2 * a.nc + 2 * T * (WT / 32) + warp * T;
  for (int c = warp; c < a.nc; c += WT / 32) {
    const size_t off = base + static_cast<size_t>(c) * T * a.H;
    mlstm::warp_gates<T>(a.li + off, a.lf + off, a.H, min(T, a.S - c * T), lis, bcum);
    const float m_in = m[c], m_out = m[c + 1], F = bcum[T - 1];
    mlstm::warp_row_stab<T>(bcum, lis, m_in, mrow);
    const size_t ci = chunk_idx(a, b, h, c);
    float* gv = a.gv + ci * 5 * T;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * lane + i;
      gv[r] = lis[r];
      gv[T + r] = bcum[r];
      gv[2 * T + r] = mrow[r];
      gv[3 * T + r] = expf(bcum[r] + m_in - mrow[r]);
      gv[4 * T + r] = expf(lis[r] + (F - bcum[r]) - m_out);
    }
    if (lane == 0) a.dec[ci] = expf(F + m_in - m_out);
    __syncwarp();                       // the warp's next chunk rewrites lis, bcum, mrow
  }
}

// Shared memory of a walk: the chunk's X and Z tiles (64 x 512, swizzled),
// its plain 64-column Y and E slabs, the two warpgroups' product tiles
// [2][64][OW], in reverse the slab of dk's or dv's chunk part [T][64]
// fp32, and fp32 vectors: the update's row coefficients ca, the vector's
// cn, inj, and the carried vector by chunk parity [2][64].
struct WalkCfg {
  static constexpr int TILE = T * DH * 2;
  static constexpr int SLAB = T * YW * 2;
  static constexpr int OUT = 64 * OW * 4;
  static constexpr int PART = T * 64 * 4;
  static constexpr int SMEM = 2 * TILE + 2 * SLAB + 2 * OUT + PART + 5 * T * 4 + 1024;   // + alignment slack
  static_assert(SMEM <= SMEM_MAX, "a walk block fits a block's shared memory");
};

// 2 and 4. The walks: a block owns a 64-column slab of the state (its 64
// columns and all 512 rows, or with REV's second half 64 rows and all
// columns), held transposed as a wgmma accumulator: warpgroup w has the
// slab's 64 indices m by 256 indices n (4 x 32 fp32 registers a thread).
// Per chunk, with X, Y, Z the chunk's rows of three of q, k, v, dy:
//   O[m][t] = sum_n acc[m][n] X[t][n]   (acc as bf16 hi and lo fragments, X
//                                        read K-major; the warpgroups' halves
//                                        summed in shared memory, in order)
//   acc    <- decay acc + (Y o ca)^T Z   ((Y o ca)^T as hi and lo fragments,
//                                        Z read MN-major)
// Forward (m e, n d): acc C^T, X dy, Y k, Z v, ca inj: O is u^T = (dy
// C_in)^T; writes u, n_in, and the slab's q . u and q . n_in.  Reverse,
// first half: acc dC^T, X v, Y q, Z dy, ca gexp r D^-1/2: O is (v
// dC_out)^T, dk = dk's chunk part + inj (v dC_out + dn_out), and the slab's
// k . (dk's state part).  Second half (m d, n e): acc dC, X k, Y dy, Z q: O
// is (k dC_out^T)^T, dv = dv's chunk part + inj k dC_out^T.  The vector n
// (dn) is carried beside the first half's state.  X loads while the update
// and the stores run, Y, Z and E while the next chunk's product runs
// (cp.async, one group each).
template <bool REV>
__global__ void __launch_bounds__(WT, 1) mlstm_bwd_tc_walk(Args a) {
  using C = WalkCfg;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint32_t base;
  unsigned char* smem = sm90::aligned_smem(smem_raw, base);
  unsigned char* xs = smem;
  unsigned char* zs = smem + C::TILE;
  bf16* ys = reinterpret_cast<bf16*>(smem + 2 * C::TILE);
  bf16* es = ys + T * YW;
  float* os = reinterpret_cast<float*>(smem + 2 * C::TILE + 2 * C::SLAB);   // [2][64][OW]
  float* ps = os + 2 * 64 * OW;                                             // [T][64]
  float* ca = ps + T * 64;
  float* cn = ca + T;
  float* iv = cn + T;
  float* nv = iv + T;                                                       // [2][64]
  const uint32_t x_addr = base, z_addr = base + C::TILE;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int nsl = a.nsl, slab = blockIdx.x % nsl, m0 = slab * 64;
  const int orient = REV ? static_cast<int>(blockIdx.x) / nsl : 0;   // 1: dC by rows
  const int h = blockIdx.y, b = blockIdx.z, nc = a.nc, S = a.S;
  const size_t rs = static_cast<size_t>(a.H) * DH;
  const size_t head = static_cast<size_t>(b) * S * rs + static_cast<size_t>(h) * DH;
  const bf16* qg = static_cast<const bf16*>(a.q) + head;
  const bf16* kg = static_cast<const bf16*>(a.k) + head;
  const bf16* vg = static_cast<const bf16*>(a.v) + head;
  const bf16* yg = static_cast<const bf16*>(a.dy) + head;
  const bf16* X = !REV ? yg : orient == 0 ? vg : kg;
  const bf16* Y = !REV ? kg : orient == 0 ? qg : yg;
  const bf16* Z = !REV ? vg : orient == 0 ? yg : qg;
  const bf16* E = !REV ? qg : orient == 0 ? kg : nullptr;
  const bool carry = orient == 0;       // the vector n, or dn, beside the state

  // chunk k of the walk (c = k forward, nc - 1 - k in reverse); one cp.async
  // group each, empty past the walk's end
  auto load_x = [&](int k) {
    if (k < nc) {
      const int c = REV ? nc - 1 - k : k;
      sm90::load_tile<DH, T, true, WT>(xs, X, rs, c * T, S, DH, tid);
    }
    rt::cp_async_commit();
  };
  auto load_z = [&](int k) {
    if (k < nc) {
      const int c = REV ? nc - 1 - k : k, rows = min(T, S - c * T);
      const size_t off = static_cast<size_t>(c) * T * rs + m0;
      sm90::load_tile<DH, T, true, WT>(zs, Z, rs, c * T, S, DH, tid);
      rt::stage_async(ys, YW, Y + off, rs, rows, 64, T, 64, true);
      if (E != nullptr) rt::stage_async(es, YW, E + off, rs, rows, 64, T, 64, true);
      if (REV)                          // dk's (dv's) chunk part on the slab, every row
        rt::stage_async(ps, 64, (orient == 0 ? a.dkc : a.dvc) + chunk_idx(a, b, h, c) * T * DH + m0,
                        DH, T, 64, T, 64, true);
    }
    rt::cp_async_commit();
  };

  // chunk k's vectors into registers, read a chunk ahead: the row t = tid
  // (tid < T) of ca, cn and inj, and the decay
  const float scale = a.scale;
  float vca = 0.f, vcn = 0.f, viv = 0.f, vdec = 0.f;
  auto read_vectors = [&](int k) {
    if (k >= nc) return;
    const size_t ci = chunk_idx(a, b, h, REV ? nc - 1 - k : k);
    vdec = a.dec[ci];
    if (tid < T) {
      const float* gv = a.gv + ci * 5 * T;
      viv = gv[4 * T + tid];
      if (REV) {
        const float gs = gv[3 * T + tid] * scale;
        vca = gs * a.rr[ci * T + tid];
        vcn = gs * a.dnq[ci * T + tid];
      } else {
        vca = vcn = viv;
      }
    }
  };

  float acc[NW][32];
#pragma unroll
  for (int sb = 0; sb < NW; ++sb) zero(acc[sb]);
  if (tid < 64) nv[tid] = 0.f;
  load_x(0);
  load_z(0);
  read_vectors(0);
  const int r0 = 16 * warp + g;
  for (int k = 0; k < nc; ++k) {
    const int c = REV ? nc - 1 - k : k, rows = min(T, S - c * T);
    const size_t ci = chunk_idx(a, b, h, c);
    const bool last = k + 1 == nc;      // the state past the walk's end is not needed
    const float decay = vdec;
    if (tid < T) {
      ca[tid] = vca;
      cn[tid] = vcn;
      iv[tid] = viv;
    }
    rt::cp_async_wait<1>();
    sm90::fence_async_shared();
    __syncthreads();                    // X_k and the chunk's vectors; chunk k - 1 done

    // O's part over this warpgroup's n, a 64-column sub-tile of the state at
    // a time (four k-steps, hi then lo)
    float o[32];
    zero(o);
    {
      const uint64_t dx = sm90::desc<DH>(x_addr);
#pragma unroll
      for (int sb = 0; sb < NW; ++sb) {
        uint32_t fh[4][4], fl[4][4];
        frags(acc[sb], fh, fl);
        const uint32_t col = (wg * NW + sb) * T * 128;
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          sm90::wgmma_rs_k(o, fh[kk], sm90::desc_at(dx, col + kk * 32));
          sm90::wgmma_rs_k(o, fl[kk], sm90::desc_at(dx, col + kk * 32));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
      }
    }
    {
      float* mo = os + wg * 64 * OW;
#pragma unroll
      for (int e = 0; e < 32; ++e)
        mo[(r0 + 8 * ((e >> 1) & 1)) * OW + 8 * (e >> 2) + 2 * q + (e & 1)] = o[e];
    }
    __syncthreads();                    // both halves of O; X_k read
    load_x(k + 1);
    rt::cp_async_wait<1>();
    sm90::fence_async_shared();
    __syncthreads();                    // Z_k, Y_k, E_k

    // the update, acc <- decay acc + (Y o ca)^T Z, issued before the stores
    // so the tensor cores run beside them
    if (!last) {
#pragma unroll
      for (int sb = 0; sb < NW; ++sb)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[sb][e] *= decay;
      uint32_t fh[4][4], fl[4][4];      // (Y o ca)^T: rows m of the slab, depth t
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = r0 + 8 * (e & 1), t = 16 * kk + 2 * q + 8 * (e >> 1);
          split2(to_f(ys[t * YW + p]) * ca[t], to_f(ys[(t + 1) * YW + p]) * ca[t + 1], fh[kk][e],
                 fl[kk][e]);
        }
      const uint64_t dz = sm90::desc<DH>(z_addr);
      sm90::wgmma_fence();
#pragma unroll
      for (int sb = 0; sb < NW; ++sb) {
        const uint32_t col = (wg * NW + sb) * T * 128;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          sm90::wgmma_rs(acc[sb], fh[kk], sm90::desc_at(dz, col + kk * 16 * 128));
          sm90::wgmma_rs(acc[sb], fl[kk], sm90::desc_at(dz, col + kk * 16 * 128));
        }
      }
      sm90::wgmma_commit();
    }

    // the stores: element (m, t) of O at thread e % 256 (m fastest), the two
    // halves summed in order
    const float* o0 = os;
    const float* o1 = os + 64 * OW;
    const float* ncur = nv + (k & 1) * 64;
    if (!REV) {
      float* ug = a.u + ci * T * DH + m0;
      for (int e = tid; e < 64 * T; e += WT) {
        const int m = e & 63, t = e >> 6;
        ug[static_cast<size_t>(t) * DH + m] = o0[m * OW + t] + o1[m * OW + t];
      }
      if (tid < 64) a.nin[ci * DH + m0 + tid] = ncur[tid];
    } else {
      bf16* dst = static_cast<bf16*>(orient == 0 ? a.dk : a.dv) + head +
                  static_cast<size_t>(c) * T * rs + m0;
      for (int e = tid; e < 64 * T; e += WT) {
        const int m = e & 63, s = e >> 6;
        const float st = iv[s] * (o0[m * OW + s] + o1[m * OW + s] + (carry ? ncur[m] : 0.f));
        if (s < rows) dst[static_cast<size_t>(s) * rs + m] = __float2bfloat16(ps[s * 64 + m] + st);
      }
    }
    if (carry) {                        // the slab's dots, four lanes a row, in order
      const int t = tid >> 2, p = tid & 3;
      float su = 0.f, sn = 0.f;
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        const int m = 16 * p + i;
        const float ev = to_f(es[t * YW + m]), om = o0[m * OW + t] + o1[m * OW + t];
        if (REV) {
          su = fmaf(ev, iv[t] * (om + ncur[m]), su);
        } else {
          su = fmaf(ev, om, su);
          sn = fmaf(ev, ncur[m], sn);
        }
      }
      su = quad_sum(su);
      sn = quad_sum(sn);
      if (p == 0) {
        const size_t o = (ci * nsl + slab) * T + t;
        if (REV) {
          a.vp[o] = su;
        } else {
          a.qu[o] = su;
          a.qn[o] = sn;
        }
      }
      if (!last && tid < 64) {          // the vector: n <- decay n + (Y o cn)^T 1
        float s = 0.f;
        for (int t2 = 0; t2 < T; ++t2) s = fmaf(cn[t2], to_f(ys[t2 * YW + tid]), s);
        nv[((k + 1) & 1) * 64 + tid] = decay * ncur[tid] + s;
      }
    }
    if (!last) {
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int sb = 0; sb < NW; ++sb) sm90::fence_regs(acc[sb]);
    }
    read_vectors(k + 1);
    __syncthreads();                    // Y_k, Z_k, E_k, O and the vectors read
    load_z(k + 1);
  }
  rt::cp_async_wait<0>();               // no copy outlives the block
}

// Shared memory of the chunk pass: a ring of two stages, each the chunk's
// rows of q, k, dy and v in a KSL-column slice (swizzled; the second sweep:
// q, k, dy, and u's and n_in's slice in fp32), then fp32 vectors: li, bcum,
// m_row, gexp, the slabs' q . u and q . n_in summed, r and dnq.
struct ChunkCfg {
  static constexpr int TILE = T * KSL * 2;
  static constexpr int US = KSL + 4;        // row stride (fp32) of the staged u
  static constexpr int STAGE = (3 * TILE + (T * US + KSL) * 4 + 1023) / 1024 * 1024;
  static_assert(4 * TILE <= STAGE, "a stage holds the first sweep's four tiles");
  static constexpr int SMEM = 2 * STAGE + 8 * T * 4 + 1024;   // + alignment slack
  static_assert(SMEM <= SMEM_MAX, "a chunk block fits a block's shared memory");
};

// 3. Per (row, head, chunk), two warpgroups: warpgroup 0 in rows t (S = q
// k^T and DV = dy v^T), warpgroup 1 in rows s (S^T and DV^T: the
// transposed operands as register fragments), over KSL-column slices.
// Then warpgroup 0 takes the rows: P = S D^-1/2 o W, nq = rowsum P + gexp
// D^-1/2 q . n_in, yd = rowsum(P o DV) + gexp D^-1/2 q . u (the walk's
// slabs' dots summed in order), r and dnq (written for the reverse walk),
// R; dP = (r DV + dnq) o W, and G's sums below and on the diagonal;
// warpgroup 1 dP^T, (P o r)^T and G's sums above it.  Then per 64 columns
// (a second sweep over the slices): dq = D^-1/2 (dP k + gexp (r u + dnq
// n_in)) (warpgroup 0), dk's and dv's chunk parts D^-1/2 dP^T q and (P o
// r)^T dy (warpgroup 1, fp32 for the reverse walk), every fp32 operand as
// hi and lo fragments.
__global__ void __launch_bounds__(WT, 1) mlstm_bwd_tc_chunk(Args a) {
  using C = ChunkCfg;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint32_t base;
  unsigned char* smem = sm90::aligned_smem(smem_raw, base);
  float* lis = reinterpret_cast<float*>(smem + 2 * C::STAGE);
  float* bcum = lis + T;
  float* mrow = bcum + T;
  float* gexp = mrow + T;
  float* QU = gexp + T;
  float* QN = QU + T;
  float* rsm = QN + T;
  float* dsm = rsm + T;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, S = a.S, rows = min(T, S - c * T);
  const size_t rs = static_cast<size_t>(a.H) * DH;
  const size_t head = static_cast<size_t>(b) * S * rs + static_cast<size_t>(h) * DH;
  const size_t ci = chunk_idx(a, b, h, c);
  const bf16* src[4] = {static_cast<const bf16*>(a.q) + head, static_cast<const bf16*>(a.k) + head,
                        static_cast<const bf16*>(a.dy) + head, static_cast<const bf16*>(a.v) + head};
  // step i of the two sweeps into stage i % 2 (one group; the second sweep
  // takes q, k, dy, u and n_in)
  auto load = [&](int i) {
    if (i < 2 * NK) {
      unsigned char* st = smem + (i & 1) * C::STAGE;
      const int col = (i % NK) * KSL;
      for (int j = 0; j < (i < NK ? 4 : 3); ++j)
        sm90::load_tile<KSL, T, true, WT>(st + j * C::TILE, src[j] + col, rs, c * T, S, KSL, tid);
      if (i >= NK) {
        float* us = reinterpret_cast<float*>(st + 3 * C::TILE);
        rt::stage_async(us, C::US, a.u + ci * T * DH + col, DH, T, KSL, T, KSL, true);
        rt::stage_async(us + T * C::US, KSL, a.nin + ci * DH + col, 0, 1, KSL, 1, KSL, true);
      }
    }
    rt::cp_async_commit();
  };
  load(0);
  load(1);
  if (tid < T) {
    const float* gv = a.gv + ci * 5 * T;
    lis[tid] = gv[tid];
    bcum[tid] = gv[T + tid];
    mrow[tid] = gv[2 * T + tid];
    gexp[tid] = gv[3 * T + tid];
    float su = 0.f, sn = 0.f;
    for (int j = 0; j < a.nsl; ++j) {
      su += a.qu[(ci * a.nsl + j) * T + tid];
      sn += a.qn[(ci * a.nsl + j) * T + tid];
    }
    QU[tid] = su;
    QN[tid] = sn;
  }

  float s1[32], s2[32];                 // S and DV (warpgroup 0), S^T and DV^T (1)
  zero(s1);
  zero(s2);
  for (int i = 0; i < NK; ++i) {
    rt::cp_async_wait<1>();
    sm90::fence_async_shared();
    __syncthreads();
    const uint32_t qa = base + (i & 1) * C::STAGE, ka = qa + C::TILE, ya = ka + C::TILE,
                   va = ya + C::TILE;
    sm90::wgmma_fence();
    ss_acc(s1, wg ? ka : qa, wg ? qa : ka);
    ss_acc(s2, wg ? va : ya, wg ? ya : va);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s1);
    sm90::fence_regs(s2);
    __syncthreads();                    // the stage is read
    load(i + 2);
  }

  // P (or P^T) and the weights W; warpgroup 0 the rows' sums
  const float scale = a.scale;
  const int r0 = 16 * warp + g;
  float wv[32], ps[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int rr = r0 + 8 * ((e >> 1) & 1), cc = 8 * (e >> 2) + 2 * q + (e & 1);
    const int t = wg ? cc : rr, s = wg ? rr : cc;
    const float w = s <= t ? expf(bcum[t] - bcum[s] + lis[s] - mrow[t]) : 0.f;
    wv[e] = w;
    s1[e] *= scale * w;
    ps[(e >> 1) & 1] += s1[e];
    pd[(e >> 1) & 1] += s1[e] * s2[e];
  }
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = r0 + 8 * i;
      const float rowp = quad_sum(ps[i]), ydi = quad_sum(pd[i]);
      const float gs = gexp[t] * scale;
      const float nq = rowp + gs * QN[t], yd = ydi + gs * QU[t];
      const float floor = expf(-mrow[t]);
      const float r = 1.f / fmaxf(fabsf(nq), floor);
      const float dn = fabsf(nq) > floor ? -yd * r * r * (nq > 0.f ? 1.f : -1.f) : 0.f;
      if (q == 0) {
        rsm[t] = r;
        dsm[t] = dn;
        a.rr[ci * T + t] = r;
        a.dnq[ci * T + t] = dn;
        a.rp[ci * T + t] = gs * (r * QU[t] + dn * QN[t]);
      }
    }
  }
  __syncthreads();                      // r and dnq

  // dP = (r DV + dnq) o W (or its transpose), G = (r DV + dnq) o P's sums,
  // (P o r)^T (warpgroup 1)
  float* gsg = a.gs + ci * 3 * T;
  {
    float gsum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int rr = r0 + 8 * ((e >> 1) & 1), cc = 8 * (e >> 2) + 2 * q + (e & 1);
      const int t = wg ? cc : rr, s = wg ? rr : cc;
      const float x = rsm[t] * s2[e] + dsm[t], gv = x * s1[e];
      if (s < t) gsum[(e >> 1) & 1] += gv;
      if (wg == 0 && s == t) gsg[2 * T + t] = gv;
      s2[e] = x * wv[e];
      s1[e] *= rsm[t];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float sum = quad_sum(gsum[i]);
      if (q == 0) gsg[(wg ? T : 0) + r0 + 8 * i] = sum;
    }
  }
  uint32_t dph[4][4], dpl[4][4], prh[4][4], prl[4][4];
  frags(s2, dph, dpl);
  frags(s1, prh, prl);

  // the second sweep: per 64 columns, dq (warpgroup 0), dk's and dv's chunk
  // parts (1)
  bf16* dq = static_cast<bf16*>(a.dq) + head + static_cast<size_t>(c) * T * rs;
  for (int j = 0; j < NK; ++j) {
    rt::cp_async_wait<1>();
    sm90::fence_async_shared();
    __syncthreads();
    const uint32_t qa = base + (j & 1) * C::STAGE, ka = qa + C::TILE, ya = ka + C::TILE;
    const float* us = reinterpret_cast<const float*>(smem + (j & 1) * C::STAGE + 3 * C::TILE);
#pragma unroll
    for (int pc = 0; pc < KSL / 64; ++pc) {
      float o1[32], o2[32];
      zero(o1);
      zero(o2);
      // the same products in both warpgroups (no divergent wgmma issue);
      // warpgroup 0 keeps only the first
      sm90::wgmma_fence();
      rs_piece(o1, dph, wg ? qa : ka, pc);
      rs_piece(o1, dpl, wg ? qa : ka, pc);
      rs_piece(o2, prh, ya, pc);
      rs_piece(o2, prl, ya, pc);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o1);
      sm90::fence_regs(o2);
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int rr = r0 + 8 * ((e >> 1) & 1), cl = pc * 64 + 8 * (e >> 2) + 2 * q,
                  col = j * KSL + cl;
        if (wg == 0) {
          const float2 uu = *reinterpret_cast<const float2*>(us + rr * C::US + cl);
          const float2 nn = *reinterpret_cast<const float2*>(us + T * C::US + cl);
          const float gs = scale * gexp[rr];
          const float v0 = scale * o1[e] + gs * (rsm[rr] * uu.x + dsm[rr] * nn.x);
          const float v1 = scale * o1[e + 1] + gs * (rsm[rr] * uu.y + dsm[rr] * nn.y);
          if (rr < rows)
            *reinterpret_cast<uint32_t*>(dq + static_cast<size_t>(rr) * rs + col) =
                sm90::pack_bf16(v0, v1);
        } else {
          const size_t o = (ci * T + rr) * DH + col;
          *reinterpret_cast<float2*>(a.dkc + o) = make_float2(scale * o1[e], scale * o1[e + 1]);
          *reinterpret_cast<float2*>(a.dvc + o) = make_float2(o2[e], o2[e + 1]);
        }
      }
    }
    __syncthreads();                    // the stage is read
    load(NK + j + 2);
  }
  rt::cp_async_wait<0>();               // no copy outlives the block
}

// floats of scratch: u, dk's and dv's chunk parts, n_in, then the vectors
inline size_t scratch_floats(int B, int S, int H) {
  const size_t nc = (static_cast<size_t>(S) + T - 1) / T, bh = static_cast<size_t>(B) * H,
               bhc = bh * nc, nsl = DH / 64;
  return bhc * (3 * T * DH + DH + 11 * T + 3 * nsl * T + 1) + bh * (nc + 1);
}

inline size_t gates_smem(int nc) { return sizeof(float) * (2 * nc + 3 * T * (WT / 32)); }

cudaError_t run(Args a, float* scratch, int B, cudaStream_t st) {
  static std::atomic<int> lg[32], lw[32], lr[32], lc[32];
  const size_t bhc = static_cast<size_t>(B) * a.H * a.nc, nsl = a.nsl;
  a.u = scratch;
  a.dkc = a.u + bhc * T * DH;
  a.dvc = a.dkc + bhc * T * DH;
  a.nin = a.dvc + bhc * T * DH;
  a.gv = a.nin + bhc * DH;
  a.qu = a.gv + bhc * 5 * T;
  a.qn = a.qu + bhc * nsl * T;
  a.vp = a.qn + bhc * nsl * T;
  a.rr = a.vp + bhc * nsl * T;
  a.dnq = a.rr + bhc * T;
  a.rp = a.dnq + bhc * T;
  a.gs = a.rp + bhc * T;
  a.dec = a.gs + bhc * 3 * T;
  a.m = a.dec + bhc;
  a.nrp = 1;
  const size_t sg = gates_smem(a.nc);
  if (sg > SMEM_MAX) return cudaErrorInvalidValue;          // S beyond ~1.8 M rows
  cudaError_t err;
  if ((err = rt::smem_at_least(mlstm_bwd_tc_gates, static_cast<int>(sg), lg)) ||
      (err = rt::smem_at_least(mlstm_bwd_tc_walk<false>, WalkCfg::SMEM, lw)) ||
      (err = rt::smem_at_least(mlstm_bwd_tc_walk<true>, WalkCfg::SMEM, lr)) ||
      (err = rt::smem_at_least(mlstm_bwd_tc_chunk, ChunkCfg::SMEM, lc)))
    return err;
  mlstm_bwd_tc_gates<<<dim3(a.H, B), WT, sg, st>>>(a);
  mlstm_bwd_tc_walk<false><<<dim3(a.nsl, a.H, B), WT, WalkCfg::SMEM, st>>>(a);
  mlstm_bwd_tc_chunk<<<dim3(a.nc, a.H, B), WT, ChunkCfg::SMEM, st>>>(a);
  mlstm_bwd_tc_walk<true><<<dim3(2 * a.nsl, a.H, B), WT, WalkCfg::SMEM, st>>>(a);
  mlstm_bwd_gsum<<<dim3(a.H, B), 32, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

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
  Args a{};
  a.q = q, a.k = k, a.v = v, a.dy = dy;
  a.li = static_cast<const float*>(li);
  a.lf = static_cast<const float*>(lf);
  a.dq = dq, a.dk = dk, a.dv = dv;
  a.dli = static_cast<float*>(dli);
  a.dlf = static_cast<float*>(dlf);
  a.S = S, a.H = H, a.D = D, a.nc = (S + T - 1) / T, a.nsl = (D + SW - 1) / SW;
  a.nrp = a.nsl;
  a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<E, bf16>::value)
    if (D == tc::DH) return tc::run(a, static_cast<float*>(scratch), B, st);
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

// floats of scratch a call needs (the wrapper allocates them): bf16 when
// bf16 is nonzero, else fp32
extern "C" long long mlstm_scan_bwd_scratch(int B, int S, int H, int D, int bf16) {
  return static_cast<long long>(bf16 && D == tc::DH ? tc::scratch_floats(B, S, H)
                                                    : scratch_floats(B, S, H, D));
}

RT_EXPORT_ERROR_STRING(mlstm_scan_bwd)
