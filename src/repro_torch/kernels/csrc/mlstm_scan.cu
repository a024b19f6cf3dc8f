// Chunked, stabilised mLSTM (xLSTM matrix memory) scan for Hopper.
//
// Replaces the Pallas kernel repro/kernels/mlstm_scan.py:mlstm_scan
// (_mlstm_kernel, pallas_call at :77).  Same function, chunk by chunk, for
// each (batch row, head), with qs = q D^-1/2 and bcum = cumsum(logf) over
// the chunk:
//   w[t,s]  = bcum_t - bcum_s + li_s  (s <= t),   m_row = max(max_s w, bcum + m)
//   y       = (scores v + gexp qs C^T) / max(|scores 1 + gexp qs.n|, exp(-m_row)),
//             scores = (qs k^T) o exp(w - m_row),  gexp = exp(bcum + m - m_row)
//   m_new   = max(bcum_T + m, max_s(li_s + bcum_T - bcum_s))
//   C, n    <- exp(bcum_T + m - m_new) (C, n) + sum_s inj_s (v_s k_s^T, k_s),
//             inj_s = exp(li_s + bcum_T - bcum_s - m_new),
// carrying fp32 C (D,D), n (D) and the scalar m.  y is exact for any chunk
// length and invariant to the stabiliser, so the kernels' chunk is their
// own (the caller's chunk is a TPU tile size that only the twin uses).
//
// Layout: q/k/v (B,S,H,D) bf16 or fp32, one dtype; logi/logf (B,S,H) fp32;
// y like q.  D <= 1024.
//
// bf16 design (tensor cores; three launches a call).  The stabiliser
// sequence depends on the gates alone, so after a cheap first pass q, k and
// v enter nothing sequential but the (C, n) carry:
//   1. mlstm_gates, a block per (row, head): every chunk's incoming m.
//   2. mlstm_scores, grid (chunks, H, B): per chunk, q k^T once on the
//      tensor cores (bf16 operands, fp32 sums), scaled after the product
//      ((q k^T) D^-1/2: q D^-1/2 is no bf16 value at D 512) and stabilised,
//      scores = (q k^T) D^-1/2 o exp(w - m_row), and their row sums, into
//      scratch.
//   3. mlstm_walk, grid (D/16, H, B): the carry, the only loop over chunks.
//      C is split by rows (1 MiB of fp32 at D 512 fits no SM); a block owns
//      16 rows of C, held as two bf16 matrices C = hi + lo (16 mantissa
//      bits), and n, and per chunk reads the chunk's scores (not its own
//      q k^T): scores v (TF32), q C^T = q hi^T + q lo^T and the update
//      (v o inj)^T k with v o inj split the same way (bf16 mma.sync, operand
//      pairs loaded 4 bytes at a time, k through ldmatrix), n on the CUDA
//      cores.  q and k arrive in 64-column slices by cp.async, a slice
//      ahead.
// Rows past S enter with logi = -1e30 and logf = 0, as the reference pads.
// Scratch (the wrapper allocates it, mlstm_scan_bf16_scratch floats): the
// scores (B,H,nc,T,T), row sums (B,H,nc,T) and m (B,H,nc): 4.2 MB at S
// 4096, H 4.  kBf16Intra (a design variant) rounds the stabilised scores
// and v o inj to bf16 (no lo product).
//
// FLOPs performed at xlstm's shapes (H 4, D 512, T 64), per batch row, head
// and chunk, whole tiles counted: q k^T 6 x 16 x 32 x 2 D = 3.1 M (tiles
// above the diagonal skipped), scores v 2 x 160 x 16 x D = 2.6 M, q C^T
// 2 x 2 T D^2 = 67.1 M (hi and lo), the update 67.1 M likewise (none in the
// last chunk).  Per call: 4x128 3.41 GFLOP, 1x4096 35.6, 1x1000 8.69, on
// the tensor cores (2x the carry's 4 D^2 flops per token and head: the
// hi + lo split).  What bounds it: the minimal work's operations at the
// bf16 rate and its bytes come close (4 D^2 flops per token and head on 8 D
// bytes of q, k, v and y); the walk, with one block per SM at B 1, runs at
// the latency of its dependent mma chains and barriers per 64-column
// slice (PERF.md).
//
// fp32 keeps the CUDA-core kernel below unchanged: a block per (row, head,
// 16 rows of C) steps 64 rows at a time and recomputes the chunk's q.k^T.
#include "mlstm.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: the CUDA-core kernel (one block per (row, head, 16 rows of C))
// ---------------------------------------------------------------------------

constexpr int Q = 64;        // rows per step
constexpr int DT = 16;       // rows of C (columns of y) per block
constexpr int E = 64;        // columns of q/k per slice
constexpr int NT = 256;      // threads per block (16 x 16)
constexpr int DMAX = 1024;   // largest head dim
constexpr int QS = Q + 1;    // padded stride (odd: no bank conflicts)

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(D) * DT + D + 2 * E * QS + 2 * Q * DT + Q * QS +
                          6 * Q + 4);
}

template <typename T>
__global__ void __launch_bounds__(NT)
mlstm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ li, const float* __restrict__ lf,
                  T* __restrict__ y, int S, int H, int D, float scale) {
  extern __shared__ float smem[];
  float* cs = smem;              // [D][DT]  C[d0+d][e] at cs[e * DT + d]
  float* ns = cs + D * DT;       // [D]      n
  float* qT = ns + D;            // [E][QS]  qs slice, column-major: qT[c * QS + t]
  float* kT = qT + E * QS;       // [E][QS]  k slice
  float* vs = kT + E * QS;       // [Q][DT]  v[:, d0:d0+DT]
  float* vi = vs + Q * DT;       // [Q][DT]  inj_s v_s
  float* sc = vi + Q * DT;       // [Q][QS]  scores
  float* lis = sc + Q * QS;      // [Q]      logi
  float* bcum = lis + Q;         // [Q]      cumsum(logf)
  float* mrow = bcum + Q;        // [Q]
  float* gex = mrow + Q;         // [Q]
  float* inj = gex + Q;          // [Q]
  float* nqs = inj + Q;          // [Q]      qs.n
  float* scal = nqs + Q;         // [1]      m_new

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % 16, ty = tid / 16;
  const int d0 = blockIdx.x * DT, h = blockIdx.y, b = blockIdx.z;
  const int dw = min(DT, D - d0);
  const size_t row = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * S * row + static_cast<size_t>(h) * D;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base + d0;
  T* yb = y + base + d0;
  const float* lib = li + static_cast<size_t>(b) * S * H + h;
  const float* lfb = lf + static_cast<size_t>(b) * S * H + h;

  for (int e = tid; e < D * DT; e += NT) cs[e] = 0.f;
  for (int e = tid; e < D; e += NT) ns[e] = 0.f;
  float m_old = rt::kNegInf;

  for (int s0 = 0; s0 < S; s0 += Q) {
    const int rows = min(Q, S - s0);
    __syncthreads();  // the previous step's readers are done
    if (tid < Q) {
      const bool ok = tid < rows;
      lis[tid] = ok ? lib[static_cast<size_t>(s0 + tid) * H] : rt::kNegInf;
      bcum[tid] = ok ? lfb[static_cast<size_t>(s0 + tid) * H] : 0.f;
    }
    for (int e = tid; e < Q * DT; e += NT) {
      const int r = e / DT, c = e % DT;
      vs[e] = (r < rows && c < dw) ? rt::to_f(vb[static_cast<size_t>(s0 + r) * row + c]) : 0.f;
    }
    __syncthreads();
    if (warp == 0) {  // inclusive cumsum of logf, two rows per lane
      const float l0 = bcum[2 * lane], l1 = bcum[2 * lane + 1];
      float acc = l0 + l1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, acc, off);
        if (lane >= off) acc += u;
      }
      __syncwarp();
      bcum[2 * lane + 1] = acc;
      bcum[2 * lane] = acc - l1;
    }
    __syncthreads();
    const float blast = bcum[Q - 1];
    if (tid < Q) {  // row stabiliser and state weight of row t
      const int t = tid;
      const float glog = bcum[t] + m_old;
      float mx = glog;
      for (int s = 0; s <= t; ++s) mx = fmaxf(mx, bcum[t] - bcum[s] + lis[s]);
      mx = fmaxf(mx, rt::kNegInf);
      mrow[t] = mx;
      gex[t] = expf(glog - mx);
    } else if (warp == 2) {  // the carry's new stabiliser
      float mx = fmaxf(lis[2 * lane] + (blast - bcum[2 * lane]),
                       lis[2 * lane + 1] + (blast - bcum[2 * lane + 1]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) scal[0] = fmaxf(blast + m_old, mx);
    }
    __syncthreads();
    const float m_new = scal[0];
    const float c_decay = expf(blast + m_old - m_new);
    if (tid < Q) inj[tid] = expf(lis[tid] + (blast - bcum[tid]) - m_new);
    __syncthreads();
    for (int e = tid; e < Q * DT; e += NT) vi[e] = vs[e] * inj[e / DT];

    // one pass over D in slices of E columns: q.k^T, qs C^T and qs.n with the
    // old carry, then the slice of C and n advanced to the step's end
    float sacc[4][4], st[4], nq_acc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      st[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
    }
    for (int e0 = 0; e0 < D; e0 += E) {
      const int ew = min(E, D - e0);
      __syncthreads();  // the previous slice's readers are done (and vi is written)
      for (int idx = tid; idx < Q * E; idx += NT) {
        const int r = idx / E, c = idx % E;
        const bool ok = r < rows && c < ew;
        const size_t off = static_cast<size_t>(s0 + r) * row + e0 + c;
        qT[c * QS + r] = ok ? rt::to_f(qb[off]) * scale : 0.f;
        kT[c * QS + r] = ok ? rt::to_f(kb[off]) : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < ew; ++c) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qT[c * QS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = kT[c * QS + tx + 16 * j];
        const float cv = cs[(e0 + c) * DT + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          st[i] = fmaf(cv, qv[i], st[i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
        }
      }
      if (tid < Q)
        for (int c = 0; c < ew; ++c) nq_acc = fmaf(ns[e0 + c], qT[c * QS + tid], nq_acc);
      __syncthreads();  // every reader of the old slice of C and n is done
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = ty + 16 * i;
        if (e < ew) {
          float acc = 0.f;
          for (int s = 0; s < Q; ++s) acc = fmaf(vi[s * DT + tx], kT[e * QS + s], acc);
          cs[(e0 + e) * DT + tx] = cs[(e0 + e) * DT + tx] * c_decay + acc;
        }
      }
      if (tid < ew) {
        float acc = 0.f;
        for (int s = 0; s < Q; ++s) acc = fmaf(inj[s], kT[tid * QS + s], acc);
        ns[e0 + tid] = ns[e0 + tid] * c_decay + acc;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tx + 16 * j;
        sc[t * QS + s] = s <= t ? sacc[i][j] * expf(bcum[t] - bcum[s] + lis[s] - mrow[t]) : 0.f;
      }
    }
    if (tid < Q) nqs[tid] = nq_acc;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {  // y: thread owns column d0 + tx, rows ty + 16i
      const int t = ty + 16 * i;
      float yi = 0.f, rs = 0.f;
      for (int s = 0; s < Q; ++s) {
        const float p = sc[t * QS + s];
        yi = fmaf(p, vs[s * DT + tx], yi);
        rs += p;
      }
      const float g = gex[t];
      const float den = fmaxf(fabsf(rs + g * nqs[t]), expf(-mrow[t]));
      if (t < rows && tx < dw)
        yb[static_cast<size_t>(s0 + t) * row + tx] = rt::from_f<T>((yi + g * st[i]) / den);
    }
    m_old = m_new;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* li, const void* lf, void* y,
           int B, int S, int H, int D, float scale, void* stream) {
  if (D < 1 || D > DMAX || H < 1) return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(mlstm_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((D + DT - 1) / DT, H, B);
  mlstm_scan_kernel<T><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(li), static_cast<const float*>(lf), static_cast<T*>(y), S, H, D,
      scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: chunk-parallel mLSTM on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
using rt::stage_async;
using rt::stride_bf16;
using rt::stride_gq;
using rt::warp_mma;
using mlstm::chunk_stabilisers;
using mlstm::warp_gates;
using mlstm::warp_row_stab;

constexpr int TM = 64;                 // chunk length of the bf16 path
constexpr int DR = 16;                 // rows of C per walk block
constexpr int SEW = 64;                // q/k columns per staged slice, scores pass
constexpr int EW = 64;                 // q/k columns per staged slice, walk
constexpr int MNT = 256;               // threads per block, gates and scores passes
constexpr int WNT = 256;               // threads per block, walk
constexpr bool kBf16Intra = false;     // design variant: chunk matrices in bf16
static_assert(TM % 32 == 0 && TM <= 128, "the chunk is 32, 64, 96 or 128 rows");
static_assert(EW % (8 * (WNT / 32)) == 0, "the update gives each warp 8k columns of a slice");
static_assert(WNT % TM == 0, "q . n splits rows evenly");

struct MlstmArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* li;
  const float* lf;
  bf16* y;
  float* sc;      // (B, H, nc, T, T)  stabilised scores per chunk
  float* rs;      // (B, H, nc, T)     their row sums
  float* m_in;    // (B, H, nc)        the stabiliser entering each chunk
  int S, H, D, nc;
  float scale;
  bool vd;        // q/k/v rows move in 16-byte pieces
};

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

// Pass 1: the stabiliser entering every chunk, from the gates alone
// (mlstm.cuh).
__global__ void __launch_bounds__(MNT) mlstm_gates(MlstmArgs a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t base = static_cast<size_t>(b) * a.S * a.H + h;
  chunk_stabilisers<TM>(a.li + base, a.lf + base, a.S, a.H, a.nc,
                        a.m_in + (static_cast<size_t>(b) * a.H + h) * a.nc, false,
                        reinterpret_cast<float*>(tc_smem));
}

// Pass 2, every (row, head, chunk) in parallel: the scores (q k^T) D^-1/2 o
// exp(w - m_row), w[t,s] = bcum_t - bcum_s + li_s for s <= t, with q k^T
// once per chunk on the tensor cores (bf16 operands, fp32 sums), and their
// row sums.  The scale multiplies the fp32 product: q D^-1/2 is no bf16
// value.  Warps own 16 x 32 tiles; tiles above the diagonal are skipped;
// the 64-column slices of q and k are double-buffered (cp.async).
template <int T>
__global__ void __launch_bounds__(MNT) mlstm_scores(MlstmArgs a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  constexpr int QH = stride_bf16(SEW), UNITS = (T / 16) * (T / 32);
  constexpr int UPW = (UNITS + MNT / 32 - 1) / (MNT / 32);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const int rows = min(T, a.S - c * T), D = a.D;
  float* lis = reinterpret_cast<float*>(tc_smem);
  float* bcum = lis + T;
  float* mrow = bcum + T;
  float* rsum = mrow + T;
  bf16* qs = reinterpret_cast<bf16*>(rsum + T);    // [2][T][QH] slices of q
  bf16* ks = qs + 2 * T * QH;                       // [2][T][QH] slices of k
  const size_t rs = static_cast<size_t>(a.H) * D;
  const size_t off = (static_cast<size_t>(b) * a.S + static_cast<size_t>(c) * T) * rs +
                     static_cast<size_t>(h) * D;
  const auto stage = [&](int e0, int buf) {
    stage_async(qs + buf * T * QH, QH, a.q + off + e0, rs, rows, min(SEW, D - e0), T, SEW, a.vd);
    stage_async(ks + buf * T * QH, QH, a.k + off + e0, rs, rows, min(SEW, D - e0), T, SEW, a.vd);
    rt::cp_async_commit();
  };
  stage(0, 0);
  const size_t chunk = (static_cast<size_t>(b) * a.H + h) * a.nc + c;
  if (warp == 0) {
    const size_t goff = (static_cast<size_t>(b) * a.S + static_cast<size_t>(c) * T) * a.H + h;
    warp_gates<T>(a.li + goff, a.lf + goff, a.H, rows, lis, bcum);
    warp_row_stab<T>(bcum, lis, a.m_in[chunk], mrow);
  }
  for (int t = threadIdx.x; t < T; t += MNT) rsum[t] = 0.f;
  float acc[UPW][4][4] = {};
  for (int e0 = 0, buf = 0; e0 < D; e0 += SEW, buf ^= 1) {
    rt::cp_async_wait<0>();
    __syncthreads();                  // slice e0 is in; every reader of the other buffer is done
    if (e0 + SEW < D) stage(e0 + SEW, buf ^ 1);
    const bf16* qb = qs + buf * T * QH;
    const bf16* kb = ks + buf * T * QH;
#pragma unroll
    for (int i = 0; i < UPW; ++i) {
      const int u = warp + i * (MNT / 32), r0 = (u % (T / 16)) * 16, n0 = (u / (T / 16)) * 32;
      if (u >= UNITS || n0 > r0 + 15) continue;
      warp_mma<true, 4>(acc[i], 0, SEW, [&](int r, int k) { return f32(qb[(r0 + r) * QH + k]); },
                        [&](int k, int n) { return f32(kb[(n0 + n) * QH + k]); });
    }
  }
  float* sb = a.sc + chunk * T * T;
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    const int u = warp + i * (MNT / 32), r0 = (u % (T / 16)) * 16, n0 = (u / (T / 16)) * 32;
    if (u >= UNITS || n0 > r0 + 15) continue;
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = r0 + g + 8 * half, s = n0 + 8 * j + 2 * q;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = s + e <= t ? acc[i][j][2 * half + e] * a.scale *
                                  expf(bcum[t] - bcum[s + e] + lis[s + e] - mrow[t])
                            : 0.f;
        *reinterpret_cast<float2*>(sb + t * T + s) = make_float2(v[0], v[1]);
        part[half] += v[0] + v[1];
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float p = part[half];
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      if (q == 0) atomicAdd(&rsum[r0 + g + 8 * half], p);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += MNT) a.rs[chunk * T + t] = rsum[t];
}

// Shared memory of the walk.
template <int T>
struct Walk {
  static constexpr int QH = stride_bf16(EW), SC = stride_gq(T), VT = stride_bf16(T),
                       VH = stride_bf16(DR);
  // warp w owns the 16 x 8 tile w % UNITS of a chunk's y block; the KPART
  // warps of a tile split each slice's q C^T between them
  static constexpr int UNITS = (T / 16) * (DR / 8), KPART = WNT / 32 / UNITS;
  static_assert(KPART >= 1 && WNT / 32 % UNITS == 0 && EW % (16 * KPART) == 0,
                "walk tiles per warp");
  int DP, CH;
  float *ns, *sc, *lis, *bcum, *mrow, *gexp, *inj, *qn, *rsum, *graw, *red;
  bf16 *chi, *clo, *vth, *vtl, *qs, *ks, *vs;
  __device__ Walk(unsigned char* sm, int D) {
    DP = (D + EW - 1) / EW * EW;
    CH = stride_bf16(DP);
    ns = reinterpret_cast<float*>(sm);  // [DP]      n
    sc = ns + DP;                       // [T][SC]   the chunk's scores
    lis = sc + T * SC;
    bcum = lis + T;
    mrow = bcum + T;
    gexp = mrow + T;
    inj = gexp + T;
    qn = inj + T;
    rsum = qn + T;                      // [2][T]    row sums, this chunk's and the next's
    graw = rsum + 2 * T;                // [2][2][T] raw logi, logf, likewise
    red = graw + 4 * T;                 // [KPART-1][UNITS][32][4] partial q C^T tiles
    chi = reinterpret_cast<bf16*>(red + (KPART - 1) * UNITS * 128);  // [DR][CH] C = hi + lo
    clo = chi + DR * CH;
    vth = clo + DR * CH;                // [DR][VT]  (v o inj)^T = hi + lo
    vtl = vth + DR * VT;
    qs = vtl + DR * VT;                 // [2][T][QH] slices of q
    ks = qs + 2 * T * QH;               // [2][T][QH] slices of k
    vs = ks + 2 * T * QH;               // [T][VH]   v[:, d0:d0+16]
  }
  static size_t bytes(int D) {
    const size_t dp = (static_cast<size_t>(D) + EW - 1) / EW * EW;
    return sizeof(float) * (dp + T * SC + 12 * T + (KPART - 1) * UNITS * 128) +
           sizeof(bf16) * (2 * DR * stride_bf16(dp) + 2 * DR * VT + 4 * T * QH + T * VH);
  }
};

// Pass 3, the carry walk: a block owns rows [d0, d0 + 16) of C and n, and per
// chunk computes its 16 columns of y from the chunk's precomputed scores
// (scores . v, TF32) and the carry (q C^T over 64-column slices of q), then
// advances its rows of C by (v o inj)^T k and n.  C is kept as a pair of
// bf16 matrices, C = hi + lo (16 mantissa bits, more than TF32's 10; 1 MiB
// of fp32 at D 512 would fit no SM whole), so both carry products are bf16
// mma.sync with operand pairs loaded 4 bytes at a time (k through
// ldmatrix): q C^T = q hi^T + q lo^T, and the update (hi + lo)(v o inj)^T k.
// Every load is a cp.async issued a slice ahead: the next slice of q and k,
// and at a chunk's last slice the next chunk's scores, v, row sums and
// gates.
template <int T>
__global__ void __launch_bounds__(WNT) mlstm_walk(MlstmArgs a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  using W = Walk<T>;
  constexpr int QH = W::QH, SC = W::SC, VT = W::VT, VH = W::VH;
  constexpr int UNITS = W::UNITS, KPART = W::KPART, UNT = EW / 8 / (WNT / 32);
  const W m(tc_smem, a.D);
  const int D = a.D, CH = m.CH, nsl = (D + EW - 1) / EW;
  const int d0 = blockIdx.x * DR, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const int dw = min(DR, D - d0);
  for (int e = threadIdx.x; e < m.DP; e += WNT) m.ns[e] = 0.f;
  for (int e = threadIdx.x; e < 2 * DR * CH; e += WNT) m.chi[e] = bf16{};   // hi and lo
  const size_t rs = static_cast<size_t>(a.H) * D;
  const size_t head = static_cast<size_t>(b) * a.S * rs + static_cast<size_t>(h) * D;
  const size_t hc = (static_cast<size_t>(b) * a.H + h) * a.nc;
  const auto stage_slice = [&](int c, int e0, int buf) {
    const size_t off = head + static_cast<size_t>(c) * T * rs + e0;
    const int rows = min(T, a.S - c * T), cols = min(EW, D - e0);
    stage_async(m.qs + buf * T * QH, QH, a.q + off, rs, rows, cols, T, EW, a.vd);
    stage_async(m.ks + buf * T * QH, QH, a.k + off, rs, rows, cols, T, EW, a.vd);
  };
  const auto stage_chunk = [&](int c) {   // scores, v columns, row sums and gates of chunk c
    const int rows = min(T, a.S - c * T);
    stage_async(m.sc, SC, a.sc + (hc + c) * T * T, T, T, T, T, T, true);
    stage_async(m.vs, VH, a.v + head + static_cast<size_t>(c) * T * rs + d0, rs, rows, dw, T, DR,
                a.vd);
    stage_async(m.rsum + (c & 1) * T, T, a.rs + (hc + c) * T, T, 1, T, 1, T, true);
    const size_t goff = (static_cast<size_t>(b) * a.S + static_cast<size_t>(c) * T) * a.H + h;
    float* gr = m.graw + (c & 1) * 2 * T;
    for (int r = threadIdx.x; r < T; r += WNT) {
      const bool ok = r < rows;
      const size_t o = goff + static_cast<size_t>(ok ? r : 0) * a.H;
      rt::cp_async4(gr + r, a.li + o, ok ? 4 : 0);
      rt::cp_async4(gr + T + r, a.lf + o, ok ? 4 : 0);
    }
  };
  stage_chunk(0);
  stage_slice(0, 0, 0);
  rt::cp_async_commit();
  int buf = 0;
  for (int c = 0; c < a.nc; ++c) {
    const int rows = min(T, a.S - c * T);
    const bool last = c + 1 == a.nc;
    const float m_in = a.m_in[hc + c], m_new = last ? m_in : a.m_in[hc + c + 1];
    rt::cp_async_wait<0>();
    __syncthreads();                // chunk c and its first slice are in
    if (warp == 0) {
      const float* gr = m.graw + (c & 1) * 2 * T;
      warp_gates<T>(gr, gr + T, 1, rows, m.lis, m.bcum);
      warp_row_stab<T>(m.bcum, m.lis, m_in, m.mrow);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += WNT) {
      m.gexp[t] = expf(m.bcum[t] + m_in - m.mrow[t]);
      m.inj[t] = expf(m.lis[t] + (m.bcum[T - 1] - m.bcum[t]) - m_new);
      m.qn[t] = 0.f;
    }
    const float c_decay = expf(m.bcum[T - 1] + m_in - m_new);
    __syncthreads();
    for (int e = threadIdx.x; e < T * DR; e += WNT) {   // (v o inj)^T as hi + lo
      const int s = e % T, d = e / T;
      const float v = f32(m.vs[s * VH + d]) * m.inj[s];
      const bf16 hv = __float2bfloat16(v);
      m.vth[d * VT + s] = hv;
      m.vtl[d * VT + s] = __float2bfloat16(v - f32(hv));
    }
    // q C^T accumulates its hi and lo products apart: two independent chains
    // q C^T accumulates its hi and lo products apart (two independent chains)
    const int u = warp % UNITS, kp = warp / UNITS;
    const int r0 = (u % (T / 16)) * 16, n0 = (u / (T / 16)) * 8;
    float acc_i[1][4] = {}, acc_s[2][4] = {};
    if (kp == 0)                    // scores . v over s <= t (TF32)
      warp_mma<kBf16Intra, 1>(acc_i, 0, r0 + 16, [&](int r, int k) { return m.sc[(r0 + r) * SC + k]; },
                              [&](int k, int n) { return f32(m.vs[k * VH + n0 + n]); });
    for (int j = 0; j < nsl; ++j, buf ^= 1) {
      const int e0 = j * EW;
      if (j > 0) rt::cp_async_wait<0>();
      __syncthreads();              // slice j is in; vi is written; the other buffer is free
      if (j + 1 < nsl) {
        stage_slice(c, e0 + EW, buf ^ 1);
      } else if (!last) {
        stage_slice(c + 1, 0, buf ^ 1);
        stage_chunk(c + 1);         // scores and v of chunk c were read before the slices
      }
      rt::cp_async_commit();
      const bf16* qb = m.qs + buf * T * QH;
      const bf16* kb = m.ks + buf * T * QH;
      {                             // q C^T = q hi^T + q lo^T with the incoming C
        const bf16* qa = qb + (r0 + g) * QH + 2 * q;
        const bf16* ch = m.chi + (n0 + g) * CH + e0 + 2 * q;
        const bf16* cl = m.clo + (n0 + g) * CH + e0 + 2 * q;
#pragma unroll
        for (int k = kp * (EW / KPART); k < (kp + 1) * (EW / KPART); k += 16) {
          const uint32_t af[4] = {rt::ld_pair(qa + k), rt::ld_pair(qa + 8 * QH + k),
                                  rt::ld_pair(qa + k + 8), rt::ld_pair(qa + 8 * QH + k + 8)};
          rt::mma_bf16(acc_s[0], af, rt::ld_pair(ch + k), rt::ld_pair(ch + k + 8));
          rt::mma_bf16(acc_s[1], af, rt::ld_pair(cl + k), rt::ld_pair(cl + k + 8));
        }
      }
      {                             // q . n: WNT / T threads a row, shuffled together
        constexpr int TPR = WNT / T;
        const int t = threadIdx.x / TPR, part = threadIdx.x % TPR;
        float s = 0.f, s2 = 0.f;
#pragma unroll 4
        for (int k = part; k < EW; k += 2 * TPR) {
          s = fmaf(f32(qb[t * QH + k]), m.ns[e0 + k], s);
          s2 = fmaf(f32(qb[t * QH + k + TPR]), m.ns[e0 + k + TPR], s2);
        }
        s += s2;
#pragma unroll
        for (int o = 1; o < TPR; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (part == 0) m.qn[t] += s;
      }
      if (last) continue;
      __syncthreads();              // every reader of this slice of C and n is done
      {                             // C[d][e] = c_decay C + sum_s vi[s][d] k[s][e]
        float acc[UNT][2][4] = {};   // hi and lo products apart, as above
        const int n0 = warp * 8 * UNT;
        const bf16* vh = m.vth + g * VT + 2 * q;
        const bf16* vl = m.vtl + g * VT + 2 * q;
#pragma unroll
        for (int k = 0; k < T; k += 16) {
          const uint32_t ah[4] = {rt::ld_pair(vh + k), rt::ld_pair(vh + 8 * VT + k),
                                  rt::ld_pair(vh + k + 8), rt::ld_pair(vh + 8 * VT + k + 8)};
          const uint32_t al[4] = {rt::ld_pair(vl + k), rt::ld_pair(vl + 8 * VT + k),
                                  rt::ld_pair(vl + k + 8), rt::ld_pair(vl + 8 * VT + k + 8)};
#pragma unroll
          for (int jj = 0; jj < UNT; ++jj) {
            uint32_t b0, b1;
            rt::ldmatrix_x2_trans(b0, b1, kb + (k + (lane & 15)) * QH + n0 + 8 * jj);
            rt::mma_bf16(acc[jj][0], ah, b0, b1);
            if (!kBf16Intra) rt::mma_bf16(acc[jj][1], al, b0, b1);
          }
        }
#pragma unroll
        for (int jj = 0; jj < UNT; ++jj) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int off = (g + 8 * half) * CH + e0 + n0 + 8 * jj + 2 * q;
            auto* ph = reinterpret_cast<__nv_bfloat162*>(m.chi + off);
            auto* pl = reinterpret_cast<__nv_bfloat162*>(m.clo + off);
            const float2 oh = __bfloat1622float2(*ph), ol = __bfloat1622float2(*pl);
            rt::split_bf16((oh.x + ol.x) * c_decay + (acc[jj][0][2 * half] + acc[jj][1][2 * half]),
                           (oh.y + ol.y) * c_decay +
                               (acc[jj][0][2 * half + 1] + acc[jj][1][2 * half + 1]),
                           *ph, *pl);
          }
        }
      }
      // n += inj^T k: a warp per 8 columns at a time, its lanes' four row
      // groups shuffled together (no block barrier)
      for (int e = warp * 8 + (lane & 7); e < EW; e += WNT / 4) {
        float s = 0.f, s2 = 0.f;
#pragma unroll 4
        for (int t = lane >> 3; t < T; t += 8) {
          s = fmaf(m.inj[t], f32(kb[t * QH + e]), s);
          s2 = fmaf(m.inj[t + 4], f32(kb[(t + 4) * QH + e]), s2);
        }
        s += s2;
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane < 8) m.ns[e0 + e] = m.ns[e0 + e] * c_decay + s;
      }
    }
    if (kp > 0)
      for (int i = 0; i < 4; ++i)
        m.red[((kp - 1) * UNITS + u) * 128 + lane * 4 + i] = acc_s[0][i] + acc_s[1][i];
    __syncthreads();                // qn and the partial tiles are complete
    if (kp > 0) continue;
    float ys[4];
    for (int i = 0; i < 4; ++i) {
      ys[i] = acc_s[0][i] + acc_s[1][i];
      for (int p = 1; p < KPART; ++p) ys[i] += m.red[((p - 1) * UNITS + u) * 128 + lane * 4 + i];
    }
    bf16* yb = a.y + head + static_cast<size_t>(c) * T * rs + d0;
    const float* rsum = m.rsum + (c & 1) * T;
    const int d = n0 + 2 * q;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = r0 + g + 8 * half;
      if (t >= rows) continue;
      const float gs = m.gexp[t] * a.scale;
      const float den = fmaxf(fabsf(rsum[t] + gs * m.qn[t]), expf(-m.mrow[t]));
      const float y0 = (acc_i[0][2 * half] + gs * ys[2 * half]) / den;
      const float y1 = (acc_i[0][2 * half + 1] + gs * ys[2 * half + 1]) / den;
      bf16* o = yb + static_cast<size_t>(t) * rs + d;
      if (d + 1 < dw && D % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y0, y1);
      } else {
        if (d < dw) o[0] = __float2bfloat16(y0);
        if (d + 1 < dw) o[1] = __float2bfloat16(y1);
      }
    }
  }
}

size_t scratch_floats(int B, int S, int H) {
  const size_t nc = (static_cast<size_t>(S) + TM - 1) / TM;
  return static_cast<size_t>(B) * H * nc * (static_cast<size_t>(TM) * TM + TM + 1);
}

std::atomic<int> g_gates_smem[32], g_scores_smem[32], g_walk_smem[32];   // limits set, per device

int launch_tc(const void* q, const void* k, const void* v, const void* li, const void* lf,
              void* y, void* scratch, int B, int S, int H, int D, float scale, void* stream) {
  if (D < 1 || D > DMAX || H < 1) return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  MlstmArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.li = static_cast<const float*>(li);
  a.lf = static_cast<const float*>(lf);
  a.y = static_cast<bf16*>(y);
  a.S = S, a.H = H, a.D = D, a.nc = (S + TM - 1) / TM, a.scale = scale;
  const size_t chunks = static_cast<size_t>(B) * H * a.nc;
  a.sc = static_cast<float*>(scratch);
  a.rs = a.sc + chunks * TM * TM;
  a.m_in = a.rs + chunks * TM;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  a.vd = D % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  const size_t s0 = sizeof(float) * (2 * static_cast<size_t>(a.nc) + 2 * TM * (MNT / 32));
  const size_t s1 = sizeof(float) * 4 * TM + sizeof(bf16) * 4 * TM * stride_bf16(SEW);
  const size_t s2 = Walk<TM>::bytes(D);
  if (s0 > 227 * 1024) return cudaErrorInvalidValue;       // S beyond ~1.8 M rows
  cudaError_t err = rt::smem_at_least(mlstm_gates, static_cast<int>(s0), g_gates_smem);
  if (err != cudaSuccess) return err;
  mlstm_gates<<<dim3(H, B), MNT, s0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = rt::smem_at_least(mlstm_scores<TM>, static_cast<int>(s1), g_scores_smem)) != cudaSuccess)
    return err;
  mlstm_scores<TM><<<dim3(a.nc, H, B), MNT, s1, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = rt::smem_at_least(mlstm_walk<TM>, static_cast<int>(s2), g_walk_smem)) != cudaSuccess)
    return err;
  mlstm_walk<TM><<<dim3((D + DR - 1) / DR, H, B), WNT, s2, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mlstm_scan_bf16(const void* q, const void* k, const void* v, const void* li,
                               const void* lf, void* y, void* scratch, int B, int S, int H, int D,
                               float scale, void* stream) {
  return launch_tc(q, k, v, li, lf, y, scratch, B, S, H, D, scale, stream);
}

// floats of scratch the bf16 path needs (the wrapper allocates them)
extern "C" long long mlstm_scan_bf16_scratch(int B, int S, int H) {
  return static_cast<long long>(scratch_floats(B, S, H));
}

extern "C" int mlstm_scan_f32(const void* q, const void* k, const void* v, const void* li,
                              const void* lf, void* y, int B, int S, int H, int D, float scale,
                              void* stream) {
  return launch<float>(q, k, v, li, lf, y, B, S, H, D, scale, stream);
}

RT_EXPORT_ERROR_STRING(mlstm_scan)
