// Chunked Mamba2 SSD scan (one B/C group) for Hopper.
//
// Replaces the Pallas kernel repro/kernels/ssm_scan.py:ssm_scan (_ssd_kernel,
// pallas_call at :79).  Same function: for each (batch row, head)
//   h_t = exp(A dt_t) h_{t-1} + dt_t (x_t outer B_t),   y_t = h_t . C_t,
// evaluated chunk by chunk: with cum = cumsum(A dt) over the chunk,
//   y     = (C B^T o L o dt) x + exp(cum) (C h^T),  L[t,s] = exp(cum_t - cum_s), s <= t
//   h_out = exp(cum_T) h + sum_s dt_s exp(cum_T - cum_s) x_s outer B_s,
// with an fp32 (P,N) state carried across chunks and emitted at the end.
//
// Layout: x (B,S,H,P), dt (B,S,H), B/C (B,S,N), all one dtype (bf16 or
// fp32); A (H,) fp32; y like x; h_final (B,H,P,N) fp32.  N <= 128.
//
// Design.  On the TPU the chunk axis was the sequential innermost grid axis
// and the whole (P,N) state and (T,T) chunk matrices sat in VMEM.  Here a
// block owns a (batch row, head, PT columns of P) tile for its whole life
// and walks the sequence itself: the rows of the state (the P dim) are
// independent, so a P tile's state h[p0:p0+PT, :] stays in shared memory
// and the grid (P/PT, H, B) fills the card (128 blocks at B 1 for zamba2's
// H 32, P 128).  B and C are shared by every head (one group) and each
// block reloads its chunk of them.  The block steps Q = 64 rows at a time:
// the chunked form is exact for any chunk length, so the caller's chunk
// (a TPU tile size: 256 rows fed the MXU) does not change the result, and
// 64 rows keep the quadratic (Q,Q) term small for the CUDA cores.  The
// exponent of L is taken only for s <= t (the dead triangle is never
// exponentiated, so extreme decay cannot overflow); rows past S enter as
// dt = 0, x = B = C = 0: identity steps, as the reference pads.
//
// Bound: per token and head the scan does ~4 P N flops on 2 P + 2N/H input
// and P output elements, far below the card's ridge, so the bound is bytes
// (x in, y out).  This first version multiplies on the CUDA cores in fp32
// and recomputes C B^T in every head and P tile; tensor cores and a shared
// C B^T per chunk are later steps.
#include "common.cuh"

namespace {

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

}  // namespace

extern "C" int ssm_scan_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, void* y, void* hout, int B, int S, int H, int P,
                             int N, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, hout, B, S, H, P, N, stream);
}

extern "C" int ssm_scan_f32(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, void* y, void* hout, int B, int S, int H, int P,
                            int N, void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, y, hout, B, S, H, P, N, stream);
}

RT_EXPORT_ERROR_STRING(ssm_scan)
