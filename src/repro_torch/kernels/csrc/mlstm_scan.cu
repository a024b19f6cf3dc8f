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
// carrying fp32 C (D,D), n (D) and the scalar m.
//
// Layout: q/k/v (B,S,H,D) bf16 or fp32, one dtype; logi/logf (B,S,H) fp32;
// y like q.  D <= 1024.
//
// Design.  The TPU kernel kept the whole C (D,D) in VMEM; at xlstm's D 512
// that is 1 MiB, and a block here has at most 227 KB of shared memory.  One
// block per (batch row, head) would also give only B*4 blocks for 132 SMs.
// So C is split by rows (the v dim): a block owns C[d0:d0+16, :] and writes
// y[:, d0:d0+16], which need all of q and k but only v[:, d0:d0+16]; the
// grid (D/16, H, B) gives 128 blocks at B 1.  n, m and the (Q,Q) score
// matrix are per (batch row, head): every block recomputes them (the q.k^T
// product is repeated in each of the D/16 row tiles; PERF.md counts the
// redundancy).  A chunk of q or k (rows x D) does not fit either, so the
// block walks D in slices of 64 columns, and in one pass per slice adds the
// slice's share of q.k^T, of qs C^T and of qs.n, then advances that slice of
// C and n to the chunk's end.  The block steps Q = 64 rows at a time: the
// chunked form is exact for any chunk length (y does not depend on the
// stabiliser), so the caller's chunk (a TPU tile size) does not change the
// result.  Rows past S enter with logi = -1e30 and logf = 0, as the
// reference pads.
//
// Bound: the carried C makes every token cost ~4 D^2 flops per head
// (qs C^T and the rank-1 update) against ~4 D bytes in and 2 D out, so at
// D 512 the scan is bound by operations.  This first version multiplies on
// the CUDA cores in fp32; tensor cores come later.
#include "common.cuh"

namespace {

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

}  // namespace

extern "C" int mlstm_scan_bf16(const void* q, const void* k, const void* v, const void* li,
                               const void* lf, void* y, int B, int S, int H, int D, float scale,
                               void* stream) {
  return launch<__nv_bfloat16>(q, k, v, li, lf, y, B, S, H, D, scale, stream);
}

extern "C" int mlstm_scan_f32(const void* q, const void* k, const void* v, const void* li,
                              const void* lf, void* y, int B, int S, int H, int D, float scale,
                              void* stream) {
  return launch<float>(q, k, v, li, lf, y, B, S, H, D, scale, stream);
}

RT_EXPORT_ERROR_STRING(mlstm_scan)
