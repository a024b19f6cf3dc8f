// Chunked Mamba2 SSD scan (one B/C group) for Hopper.
//
// Replaces the Pallas kernel repro/kernels/ssm_scan.py:ssm_scan (_ssd_kernel,
// pallas_call at :79).  Same function: for each (batch row, head)
//   h_t = exp(A dt_t) h_{t-1} + dt_t (x_t outer B_t),   y_t = h_t . C_t,
// evaluated chunk by chunk: with cum = cumsum(A dt) over the chunk,
//   y     = (C B^T o L o dt) x + exp(cum) (C h^T),  L[t,s] = exp(cum_t - cum_s), s <= t
//   h_out = exp(cum_T) h + sum_s dt_s exp(cum_T - cum_s) x_s outer B_s,
// with an fp32 (P,N) state carried across chunks and emitted at the end.
// The chunked form is exact for any chunk length, so the kernels' chunk is
// their own (the caller's chunk is a TPU tile size that only the twin uses).
//
// Layout: x (B,S,H,P), dt (B,S,H), B/C (B,S,N), all one dtype (bf16 or
// fp32); A (H,) fp32; y like x; h_final (B,H,P,N) fp32.  N <= 128; the bf16
// path takes P <= 256.
//
// bf16 design (tensor cores; three launches a call).  The TPU walked the
// chunks in order with the whole state in VMEM; here only the carry is
// sequential, and every product runs on mma.sync:
//   1. ssd_states, grid (H + 1, chunks, B): block H computes G = C B^T once
//      per (batch row, chunk) for every head (bf16 operands, fp32 sums:
//      exact products), into scratch; blocks h < H compute the chunk's own
//      state contribution S_c = (x o w)^T B, w_s = dt_s exp(cum_T - cum_s)
//      (TF32), and cum_T, into scratch.
//   2. ssd_carry, one thread per four state elements: h_c = exp(cum_T) h_{c-1} +
//      S_c, overwriting S_c with the chunk's incoming state h_{c-1}, and
//      h_final.  Elementwise fp32, the only loop over chunks.
//   3. ssd_output, grid (H x P/64, chunks, B), a warp per 16 rows of a
//      chunk: y = (G o L o dt) x + exp(cum) C h_{c-1}^T as one TF32
//      accumulation (the first product skips the tiles above the diagonal,
//      and L's exponent is taken only for s <= t, so extreme decay cannot
//      overflow), written in bf16.
// Rows past S enter as dt = 0, x = B = C = 0: identity steps, as the
// reference pads.  Scratch (the wrapper allocates it, ssm_scan_bf16_scratch
// floats): G (B,nc,T,T), the per-chunk states (B,nc,H,P,N) and cum_T
// (B,nc,H); the states are nc H P N 4 bytes a row, 67 MB at S 4096, T 64
// for zamba2 (H 32, P 128, N 64).  kFusedCarry (a design variant) replaces
// passes 2 and 3 by one kernel whose blocks own (row, head, 64 columns of
// P) and walk the chunks with the state in shared memory (two launches);
// kBf16Intra (a variant) rounds the chunk matrices G o L o dt and x o w to
// bf16 for bf16 products.
//
// FLOPs performed at zamba2's shapes (H 32, P 128, N 64, T 64), per batch
// row and chunk, whole tiles counted: G 2 T^2 N = 0.52 M; the states 2 T P N
// H = 33.6 M; y 2 x 160 x 16 x P H (the tiles on and below the diagonal)
// + 2 T N P H = 21.0 M + 33.6 M.  Per call: 4x128 0.71 GFLOP, 1x4096 5.67,
// 1x1000 1.42, on the tensor cores (1.06x the sequential recurrence's
// 5 P N H S).  What bounds it: bytes.  Per token and head the scan needs
// ~5 P N flops of state work on ~4 P bytes of x and y, below the card's
// ridge even at the fp32 rate; the chunk states' scratch (written, read and
// rewritten by the carry, read again) adds 16 nc H P N bytes, 268 MB at
// 1x4096, T 64: more than x and y (67 MB).
//
// fp32 keeps the CUDA-core kernel below unchanged: one block per (batch
// row, head, 32 state rows) walks the sequence 64 rows a step, recomputing
// C B^T per block, every product an fp32 FMA.
#include <algorithm>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: the CUDA-core kernel (one block per (row, head, 32 state rows))
// ---------------------------------------------------------------------------

constexpr int Q = 64;        // rows per step
constexpr int PT = 32;       // state rows (P columns) per block
constexpr int NT = 256;      // threads per block
constexpr int NMAX = 128;    // largest state size N
constexpr int QS = Q + 1;    // padded strides (odd: no bank conflicts)
constexpr int MS = Q + 1;

size_t smem_bytes(int N) {
  return sizeof(float) * (static_cast<size_t>(Q) * PT + 2 * static_cast<size_t>(N) * QS +
                          static_cast<size_t>(Q) * MS + static_cast<size_t>(N) * PT + 3 * Q);
}

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_scan(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
         const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ y,
         float* __restrict__ hout, int S, int H, int P, int N) {
  extern __shared__ float smem[];
  float* xs = smem;              // [Q][PT]   x rows of this P tile
  float* bs = xs + Q * PT;       // [N][QS]   B, n-major
  float* cs = bs + N * QS;       // [N][QS]   C, n-major
  float* ms = cs + N * QS;       // [Q][MS]   M[t][s] = (C_t.B_s) L[t,s] dt_s
  float* hs = ms + Q * MS;       // [N][PT]   state h[p][n], stored n-major
  float* cum = hs + N * PT;      // [Q]
  float* dts = cum + Q;          // [Q]
  float* wv = dts + Q;           // [Q]       dt_s exp(cum_last - cum_s)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int pw = min(PT, P - p0);
  const float a = A[h];
  const size_t xrow = static_cast<size_t>(H) * P;
  const T* xb = x + static_cast<size_t>(b) * S * xrow + static_cast<size_t>(h) * P + p0;
  T* yb = y + static_cast<size_t>(b) * S * xrow + static_cast<size_t>(h) * P + p0;
  const T* dtb = dt + static_cast<size_t>(b) * S * H + h;
  const T* bb = Bm + static_cast<size_t>(b) * S * N;
  const T* cb = Cm + static_cast<size_t>(b) * S * N;

  for (int e = tid; e < N * PT; e += NT) hs[e] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    const int rows = min(Q, S - s0);
    __syncthreads();  // the previous step's readers and state writers are done
    for (int e = tid; e < Q * PT; e += NT) {
      const int r = e / PT, c = e % PT;
      xs[e] = (r < rows && c < pw) ? rt::to_f(xb[static_cast<size_t>(s0 + r) * xrow + c]) : 0.f;
    }
    for (int e = tid; e < Q * N; e += NT) {
      const int r = e / N, n = e % N;
      const bool ok = r < rows;
      const size_t off = static_cast<size_t>(s0 + r) * N + n;
      bs[n * QS + r] = ok ? rt::to_f(bb[off]) : 0.f;
      cs[n * QS + r] = ok ? rt::to_f(cb[off]) : 0.f;
    }
    if (tid < Q) dts[tid] = tid < rows ? rt::to_f(dtb[static_cast<size_t>(s0 + tid) * H]) : 0.f;
    __syncthreads();

    if (warp == 0) {  // inclusive cumsum of A dt over the Q rows, two per lane
      const float l0 = a * dts[2 * lane], l1 = a * dts[2 * lane + 1];
      float v = l0 + l1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      cum[2 * lane + 1] = v;
      cum[2 * lane] = v - l1;
    }
    __syncthreads();
    const float clast = cum[Q - 1];
    if (tid < Q) wv[tid] = dts[tid] * expf(clast - cum[tid]);

    {  // M = (C B^T) o L o dt, thread (tx, ty) owns rows ty+16i, columns tx+16j
      const int tx = tid % 16, ty = tid / 16;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[n * QS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[n * QS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          ms[t * MS + s] = s <= t ? acc[i][j] * expf(cum[t] - cum[s]) * dts[s] : 0.f;
        }
      }
    }
    __syncthreads();

    {  // y: lane owns column p = lane, rows warp + 8i
      float yi[8], ys[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) yi[i] = ys[i] = 0.f;
      for (int s = 0; s < Q; ++s) {
        const float xv = xs[s * PT + lane];
#pragma unroll
        for (int i = 0; i < 8; ++i) yi[i] = fmaf(ms[(warp + 8 * i) * MS + s], xv, yi[i]);
      }
      for (int n = 0; n < N; ++n) {
        const float hv = hs[n * PT + lane];
#pragma unroll
        for (int i = 0; i < 8; ++i) ys[i] = fmaf(cs[n * QS + warp + 8 * i], hv, ys[i]);
      }
      if (lane < pw) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = warp + 8 * i;
          if (t < rows)
            yb[static_cast<size_t>(s0 + t) * xrow + lane] =
                rt::from_f<T>(yi[i] + expf(cum[t]) * ys[i]);
        }
      }
    }
    __syncthreads();  // every reader of the old state is done

    {  // state: lane owns p = lane, warp owns n = warp + 8k
      const float decay = expf(clast);
      for (int n = warp; n < N; n += NT / 32) {
        float acc = 0.f;
        for (int s = 0; s < Q; ++s) acc = fmaf(wv[s] * xs[s * PT + lane], bs[n * QS + s], acc);
        hs[n * PT + lane] = hs[n * PT + lane] * decay + acc;
      }
    }
  }
  __syncthreads();
  float* hb = hout + (static_cast<size_t>(b) * H + h) * P * N;
  for (int e = tid; e < pw * N; e += NT) {
    const int p = e / N, n = e % N;
    hb[static_cast<size_t>(p0 + p) * N + n] = hs[n * PT + p];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* hout, int B, int S, int H, int P, int N, void* stream) {
  if (N < 1 || N > NMAX || P < 1 || H < 1) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const size_t smem = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((P + PT - 1) / PT, H, B);
  ssd_scan<T><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(hout), S, H, P, N);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: chunk-parallel SSD on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
using rt::stage_async;
using rt::stride_bf16;
using rt::stride_gq;
using rt::warp_cumsum;
using rt::warp_mma;

constexpr int TC = 64;                 // chunk length of the bf16 path
constexpr bool kFusedCarry = false;    // design variant: passes 2 and 3 fused
constexpr bool kBf16Intra = false;     // design variant: chunk matrices in bf16
constexpr int PW = 64;                 // columns of P per output block
constexpr int SNT = 256;               // threads of the state pass
constexpr int CNT = 256;               // threads of the carry pass
constexpr int PMAX = 256;              // largest P of the bf16 path
static_assert(TC % 64 == 0 && TC <= 128, "the chunk is 64 or 128 rows");

struct SsdArgs {
  const bf16* x;
  const bf16* dt;
  const float* A;
  const bf16* Bm;
  const bf16* Cm;
  bf16* y;
  float* g;       // (B, nc, T, T)     G = C B^T per chunk
  float* st;      // (B, nc, H, P, N)  chunk states, then incoming states
  float* ct;      // (B, nc, H)        cum_T per chunk and head
  float* hout;    // (B, H, P, N)
  int S, H, P, N, nc;
  bool vx, vn, vh;  // x rows, B/C rows, state rows move in 16-byte pieces
};

__host__ __device__ constexpr int pad16(int w) { return (w + 15) / 16 * 16; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

// dt of the chunk's rows (0 past S) and cum = cumsum(A dt), by the block
// (synchronises)
template <int T>
__device__ __forceinline__ void chunk_cum(const SsdArgs& a, int b, int c, int h, int rows,
                                          float* dts, float* cum) {
  const bf16* dtb = a.dt + (static_cast<size_t>(b) * a.S + static_cast<size_t>(c) * T) * a.H + h;
  const float ah = a.A[h];
  for (int r = threadIdx.x; r < T; r += blockDim.x) {
    const float d = r < rows ? f32(dtb[static_cast<size_t>(r) * a.H]) : 0.f;
    dts[r] = d;
    cum[r] = ah * d;
  }
  __syncthreads();
  if (threadIdx.x < 32) warp_cumsum<T>(cum);
  __syncthreads();
}

size_t states_smem(int P, int N) {
  const size_t bh = stride_bf16(pad16(N)), xh = stride_bf16(pad16(P));
  return 3 * sizeof(float) * TC + sizeof(bf16) * TC * (bh + std::max(bh, xh));
}

// Pass 1: G per (row, chunk) in block H; a head's chunk state elsewhere.
template <int T>
__global__ void __launch_bounds__(SNT) ssd_states(SsdArgs a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const int rows = min(T, a.S - c * T), N = a.N, P = a.P;
  const int NP = pad16(N), BH = stride_bf16(NP);
  const size_t row0 = static_cast<size_t>(b) * a.S + static_cast<size_t>(c) * T;
  float* dts = reinterpret_cast<float*>(tc_smem);
  float* cum = dts + T;
  float* w = cum + T;
  bf16* bs = reinterpret_cast<bf16*>(w + T);        // [T][BH] B rows
  stage_async(bs, BH, a.Bm + row0 * N, N, rows, N, T, NP, a.vn);
  if (h == a.H) {                                   // G = C B^T, for every head
    bf16* cs = bs + T * BH;                         // [T][BH] C rows
    stage_async(cs, BH, a.Cm + row0 * N, N, rows, N, T, NP, a.vn);
    rt::cp_async_commit();
    rt::cp_async_wait<0>();
    __syncthreads();
    float* gb = a.g + (static_cast<size_t>(b) * a.nc + c) * T * T;
    for (int u = warp; u < (T / 16) * (T / 64); u += SNT / 32) {
      const int r0 = (u % (T / 16)) * 16, n0 = (u / (T / 16)) * 64;
      if (n0 > r0 + 15) continue;                   // above the diagonal: never read
      float acc[8][4] = {};
      warp_mma<true, 8>(acc, 0, NP, [&](int r, int k) { return f32(cs[(r0 + r) * BH + k]); },
                        [&](int k, int n) { return f32(bs[(n0 + n) * BH + k]); });
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* o = gb + static_cast<size_t>(r0 + g) * T + n0 + 8 * j + 2 * q;
        *reinterpret_cast<float2*>(o) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(o + 8 * T) = make_float2(acc[j][2], acc[j][3]);
      }
    }
    return;
  }
  const int PP = pad16(P), XH = stride_bf16(PP);
  bf16* xs = bs + T * BH;                           // [T][XH] x rows of head h
  stage_async(xs, XH, a.x + row0 * a.H * P + static_cast<size_t>(h) * P,
              static_cast<size_t>(a.H) * P, rows, P, T, PP, a.vx);
  rt::cp_async_commit();
  chunk_cum<T>(a, b, c, h, rows, dts, cum);         // while the tiles arrive
  const float last = cum[T - 1];
  for (int r = threadIdx.x; r < T; r += SNT) w[r] = dts[r] * expf(last - cum[r]);
  if (threadIdx.x == 0) a.ct[(static_cast<size_t>(b) * a.nc + c) * a.H + h] = last;
  rt::cp_async_wait<0>();
  __syncthreads();
  // S_c[p][n] = sum_s x[s][p] w[s] B[s][n]: 16 rows of P x 64 of N a unit
  float* sb = a.st + ((static_cast<size_t>(b) * a.nc + c) * a.H + h) * P * N;
  const int mt = PP / 16, units = mt * ((N + 63) / 64);
  for (int u = warp; u < units; u += SNT / 32) {
    const int p0 = (u % mt) * 16, n0 = (u / mt) * 64;
    float acc[8][4] = {};
    warp_mma<kBf16Intra, 8>(
        acc, 0, T, [&](int r, int k) { return f32(xs[k * XH + p0 + r]) * w[k]; },
        [&](int k, int n) { return n0 + n < NP ? f32(bs[k * BH + n0 + n]) : 0.f; });
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 8 * j + 2 * q;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + g + 8 * (i >> 1), nn = n + (i & 1);
        if (p < P && nn < N) sb[static_cast<size_t>(p) * N + nn] = acc[j][i];
      }
    }
  }
}

// Pass 2: the carry, one thread per V state elements (16-byte pieces where
// P N allows); the next U chunks' loads are in flight while this batch's
// dependent FMAs and stores run.
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

template <int V>
__global__ void __launch_bounds__(CNT) ssd_carry(SsdArgs a) {
  constexpr int U = 4;
  const int PN = a.P * a.N;
  const int e = (blockIdx.x * CNT + threadIdx.x) * V, h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const size_t step = static_cast<size_t>(a.H) * PN;
  float* p = a.st + (static_cast<size_t>(b) * a.nc * a.H + h) * PN + e;
  const float* cb = a.ct + static_cast<size_t>(b) * a.nc * a.H + h;
  Piece<V> s[U], hv;
  float d[U];
#pragma unroll
  for (int j = 0; j < V; ++j) hv.v[j] = 0.f;
#pragma unroll
  for (int i = 0; i < U; ++i)
    if (i < a.nc) {
      s[i].load(p + i * step);
      d[i] = cb[i * a.H];
    }
  for (int c0 = 0; c0 < a.nc; c0 += U) {
    Piece<V> sc[U];
    float dc[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      sc[i] = s[i];
      dc[i] = d[i];
      const int c = c0 + U + i;
      if (c < a.nc) {
        s[i].load(p + c * step);
        d[i] = cb[c * a.H];
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int c = c0 + i;
      if (c < a.nc) {
        hv.store(p + c * step);
        const float dec = expf(dc[i]);
#pragma unroll
        for (int j = 0; j < V; ++j) hv.v[j] = hv.v[j] * dec + sc[i].v[j];
      }
    }
  }
  hv.store(a.hout + (static_cast<size_t>(b) * a.H + h) * PN + e);
}

// Shared memory of the output pass (and of the fused variant).
template <int T>
struct OutTile {
  int GS, HS, BH, XH;
  float *gs, *hs, *ss, *dts, *cum, *ecum;
  bf16 *cs, *xs;
  __device__ OutTile(unsigned char* sm, int N) {
    GS = stride_gq(T);
    HS = stride_gq(pad16(N));
    BH = stride_bf16(pad16(N));
    XH = stride_bf16(PW);
    gs = reinterpret_cast<float*>(sm);   // [T][GS]  G
    hs = gs + T * GS;                    // [PW][HS] incoming state h[p][n]
    ss = hs + PW * HS;                   // [PW][HS] the chunk's own state (fused variant)
    dts = ss + (kFusedCarry ? PW * HS : 0);
    cum = dts + T;
    ecum = cum + T;
    cs = reinterpret_cast<bf16*>(ecum + T);   // [T][BH] C rows
    xs = cs + T * BH;                    // [T][XH] x rows, PW columns of P
  }
};

template <int T>
size_t out_smem(int N) {
  const size_t hs = static_cast<size_t>(PW) * stride_gq(pad16(N));
  return sizeof(float) * (static_cast<size_t>(T) * stride_gq(T) + hs * (kFusedCarry ? 2 : 1) +
                          3 * T) +
         sizeof(bf16) * T * (stride_bf16(pad16(N)) + stride_bf16(PW));
}

// Issue chunk c's G, C and x columns [p0, p0 + PW) as cp.async (committed
// with whatever the caller issued before), then dt and cum while they
// arrive; returns with everything in shared memory.
template <int T>
__device__ void stage_chunk(const SsdArgs& a, const OutTile<T>& m, int b, int c, int h, int p0,
                            int rows) {
  const size_t row0 = static_cast<size_t>(b) * a.S + static_cast<size_t>(c) * T;
  stage_async(m.gs, m.GS, a.g + (static_cast<size_t>(b) * a.nc + c) * T * T, T, T, T, T, T, true);
  stage_async(m.cs, m.BH, a.Cm + row0 * a.N, a.N, rows, a.N, T, pad16(a.N), a.vn);
  stage_async(m.xs, m.XH, a.x + row0 * a.H * a.P + static_cast<size_t>(h) * a.P + p0,
              static_cast<size_t>(a.H) * a.P, rows, min(PW, a.P - p0), T, PW, a.vx);
  rt::cp_async_commit();
  chunk_cum<T>(a, b, c, h, rows, m.dts, m.cum);
  for (int r = threadIdx.x; r < T; r += blockDim.x) m.ecum[r] = expf(m.cum[r]);
  rt::cp_async_wait<0>();
  __syncthreads();
}

// y of chunk c, columns [p0, p0 + PW): a warp per 16 rows.
template <int T>
__device__ void chunk_y(const SsdArgs& a, const OutTile<T>& m, int b, int c, int h, int p0,
                        int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const int r0 = warp * 16;
  constexpr int NT = PW / 8;
  float acc[NT][4] = {};
  // (G o L o dt) x over the columns s <= t, the exponent taken only there
  warp_mma<kBf16Intra, NT>(
      acc, 0, r0 + 16,
      [&](int r, int k) {
        const int t = r0 + r;
        return k <= t ? m.gs[t * m.GS + k] * expf(m.cum[t] - m.cum[k]) * m.dts[k] : 0.f;
      },
      [&](int k, int n) { return f32(m.xs[k * m.XH + n]); });
  // + exp(cum) C h^T, the carried state in TF32
  warp_mma<false, NT>(
      acc, 0, (a.N + 7) / 8 * 8,
      [&](int r, int k) { return m.ecum[r0 + r] * f32(m.cs[(r0 + r) * m.BH + k]); },
      [&](int k, int n) { return m.hs[n * m.HS + k]; });
  const size_t xrow = static_cast<size_t>(a.H) * a.P;
  bf16* yb = a.y + (static_cast<size_t>(b) * a.S + static_cast<size_t>(c) * T) * xrow +
             static_cast<size_t>(h) * a.P + p0;
  const int pw = min(PW, a.P - p0);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = 8 * j + 2 * q;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = r0 + g + 8 * half;
      if (t >= rows) continue;
      bf16* o = yb + static_cast<size_t>(t) * xrow + col;
      if (col + 1 < pw && (a.P % 2) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o) =
            __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
      } else {
        if (col < pw) o[0] = __float2bfloat16(acc[j][2 * half]);
        if (col + 1 < pw) o[1] = __float2bfloat16(acc[j][2 * half + 1]);
      }
    }
  }
}

// the incoming (or own) state of chunk c, rows [p0, p0 + PW), as cp.async
template <int T>
__device__ __forceinline__ void stage_state(const SsdArgs& a, const OutTile<T>& m, float* dst,
                                            int b, int c, int h, int p0) {
  const float* sb = a.st + ((static_cast<size_t>(b) * a.nc + c) * a.H + h) * a.P * a.N;
  stage_async(dst, m.HS, sb + static_cast<size_t>(p0) * a.N, a.N, a.P - p0, a.N, PW, pad16(a.N),
              a.vh);
}

// Pass 3: y of every (row, chunk, head, 64 columns of P) in parallel.
template <int T>
__global__ void __launch_bounds__(T / 16 * 32) ssd_output(SsdArgs a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int npt = (a.P + PW - 1) / PW;
  const int h = blockIdx.x / npt, p0 = (blockIdx.x % npt) * PW, c = blockIdx.y, b = blockIdx.z;
  const OutTile<T> m(tc_smem, a.N);
  stage_state<T>(a, m, m.hs, b, c, h, p0);
  stage_chunk<T>(a, m, b, c, h, p0, min(T, a.S - c * T));
  chunk_y<T>(a, m, b, c, h, p0, min(T, a.S - c * T));
}

// Variant: passes 2 and 3 in one kernel, a block per (row, head, 64 columns
// of P) walking the chunks with the state in shared memory.
template <int T>
__global__ void __launch_bounds__(T / 16 * 32) ssd_fused(SsdArgs a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int p0 = blockIdx.x * PW, h = blockIdx.y, b = blockIdx.z;
  const OutTile<T> m(tc_smem, a.N);
  for (int e = threadIdx.x; e < PW * m.HS; e += blockDim.x) m.hs[e] = 0.f;
  for (int c = 0; c < a.nc; ++c) {
    const int rows = min(T, a.S - c * T);
    __syncthreads();
    stage_state<T>(a, m, m.ss, b, c, h, p0);
    stage_chunk<T>(a, m, b, c, h, p0, rows);
    chunk_y<T>(a, m, b, c, h, p0, rows);
    __syncthreads();
    const float dec = expf(a.ct[(static_cast<size_t>(b) * a.nc + c) * a.H + h]);
    for (int e = threadIdx.x; e < PW * m.HS; e += blockDim.x) m.hs[e] = m.hs[e] * dec + m.ss[e];
  }
  __syncthreads();
  float* hb = a.hout + (static_cast<size_t>(b) * a.H + h) * a.P * a.N;
  for (int e = threadIdx.x; e < PW * a.N; e += blockDim.x) {
    const int p = e / a.N, n = e % a.N;
    if (p0 + p < a.P) hb[static_cast<size_t>(p0 + p) * a.N + n] = m.hs[p * m.HS + n];
  }
}

size_t scratch_floats(int B, int S, int H, int P, int N) {
  const size_t nc = (static_cast<size_t>(S) + TC - 1) / TC;
  return static_cast<size_t>(B) * nc * (static_cast<size_t>(TC) * TC +
                                        static_cast<size_t>(H) * P * N + H);
}

std::atomic<int> g_states_smem[32], g_out_smem[32];   // limits set, per device

int launch_tc(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
              void* y, void* hout, void* scratch, int B, int S, int H, int P, int N,
              void* stream) {
  if (N < 1 || N > NMAX || P < 1 || P > PMAX || H < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return cudaSuccess;
  if (S == 0) return cudaMemsetAsync(hout, 0, sizeof(float) * B * H * P * N, st);
  SsdArgs a;
  a.x = static_cast<const bf16*>(x);
  a.dt = static_cast<const bf16*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = static_cast<const bf16*>(Bm);
  a.Cm = static_cast<const bf16*>(Cm);
  a.y = static_cast<bf16*>(y);
  a.hout = static_cast<float*>(hout);
  a.S = S, a.H = H, a.P = P, a.N = N, a.nc = (S + TC - 1) / TC;
  a.g = static_cast<float*>(scratch);
  a.st = a.g + static_cast<size_t>(B) * a.nc * TC * TC;
  a.ct = a.st + static_cast<size_t>(B) * a.nc * H * P * N;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  a.vx = P % 8 == 0 && aligned(x);
  a.vn = N % 8 == 0 && aligned(Bm) && aligned(Cm);
  a.vh = N % 4 == 0 && aligned(scratch);

  const int s1 = static_cast<int>(states_smem(P, N)), s3 = static_cast<int>(out_smem<TC>(N));
  cudaError_t err = rt::smem_at_least(ssd_states<TC>, s1, g_states_smem);
  if (err != cudaSuccess) return err;
  ssd_states<TC><<<dim3(H + 1, a.nc, B), SNT, s1, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int npt = (P + PW - 1) / PW;
  if constexpr (kFusedCarry) {
    if ((err = rt::smem_at_least(ssd_fused<TC>, s3, g_out_smem)) != cudaSuccess) return err;
    ssd_fused<TC><<<dim3(npt, H, B), TC / 16 * 32, s3, st>>>(a);
    return cudaGetLastError();
  }
  if (P * N % 4 == 0 && aligned(scratch) && aligned(hout))
    ssd_carry<4><<<dim3((P * N / 4 + CNT - 1) / CNT, H, B), CNT, 0, st>>>(a);
  else
    ssd_carry<1><<<dim3((P * N + CNT - 1) / CNT, H, B), CNT, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = rt::smem_at_least(ssd_output<TC>, s3, g_out_smem)) != cudaSuccess) return err;
  ssd_output<TC><<<dim3(H * npt, a.nc, B), TC / 16 * 32, s3, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssm_scan_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, void* y, void* hout, void* scratch, int B, int S,
                             int H, int P, int N, void* stream) {
  return launch_tc(x, dt, A, Bm, Cm, y, hout, scratch, B, S, H, P, N, stream);
}

// floats of scratch the bf16 path needs (the wrapper allocates them)
extern "C" long long ssm_scan_bf16_scratch(int B, int S, int H, int P, int N) {
  return static_cast<long long>(scratch_floats(B, S, H, P, N));
}

extern "C" int ssm_scan_f32(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, void* y, void* hout, int B, int S, int H, int P,
                            int N, void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, y, hout, B, S, H, P, N, stream);
}

RT_EXPORT_ERROR_STRING(ssm_scan)
