// Blocked causal / windowed GQA attention forward (prefill) for Hopper.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:flash_attention
// (_flash_kernel, pallas_call at :85).  Same function: fp32 online softmax,
// kv head = q head / group, causal mask offset by q_offset, sliding window
// kpos > qpos - window, keys at or past kv_len masked, finite -1e30 masks.
//
// Layout: q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D), o like q; contiguous, bf16 or
// fp32; D <= 128.
//
// Design.  On the TPU the kv axis was the innermost, sequential grid axis
// and the accumulators lived in VMEM scratch across grid steps.  Here blocks
// run in parallel and in no order, so one block owns a (BQ query rows, one
// q head, one batch row) tile for its whole life and loops over K/V tiles
// itself, keeping acc/m/l in registers.  Grid = (ceil(Sq/BQ), Hq, B),
// 256 threads as a 16x16 grid: thread (tx,ty) owns query rows ty+16i
// (i<4), score columns tx+16c (c<4) and output columns tx+16c (c<8).  Q
// (pre-scaled) and K are staged d-major in shared memory with a padded
// stride, so the row/column reads of the inner product are conflict-free;
// P goes through shared memory once per tile for the P.V product.  Causal
// and window masks also skip whole K/V tiles outside the band.
//
// Bound: at the serving shapes (S up to a few thousand, D 128) attention
// does ~4*S*S*D*H/2 flops on ~4*S*H*D bytes, far above the card's ridge,
// so the bound is operations.  This first version multiplies on the CUDA
// cores in fp32 (67 TFLOP/s peak, not the 989 of the bf16 tensor cores);
// wgmma with TMA-fed tiles is the next step for this kernel.
#include "common.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int DMAX = 128;       // largest head dim the block's buffers hold
constexpr int NT = 256;         // threads per block (16 x 16)
constexpr int RPT = BQ / 16;    // query rows per thread
constexpr int CPT = BK / 16;    // score columns per thread
constexpr int DPT = DMAX / 16;  // output columns per thread
constexpr int QS = BQ + 1;      // padded strides (odd: no bank conflicts)
constexpr int KS = BK + 1;
constexpr size_t kSmemBytes = sizeof(float) * (DMAX * QS + DMAX * KS + BK * DMAX + BK * QS);

template <typename T>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int Sq, int Skv, int Hq, int Hkv, int D, float scale,
          int causal, int window, int q_offset, int kv_len) {
  extern __shared__ float smem[];
  float* q_s = smem;                  // [DMAX][QS]  q_s[d * QS + r], pre-scaled
  float* k_s = q_s + DMAX * QS;       // [DMAX][KS]  k_s[d * KS + j]
  float* v_s = k_s + DMAX * KS;       // [BK][DMAX]  v_s[j * DMAX + d]
  float* p_s = v_s + BK * DMAX;       // [BK][QS]    p_s[j * QS + r]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_row = static_cast<size_t>(Hq) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const T* qb = q + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(hk) * D;
  const T* vb = v + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(hk) * D;
  T* ob = o + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    q_s[d * QS + r] = (q0 + r < Sq) ? rt::to_f(qb[(q0 + r) * q_row + d]) * scale : 0.f;
  }

  // the band of keys any row of this block can see
  const int n_valid = min(Skv, kv_len);
  int kv_end = n_valid;
  if (causal) kv_end = min(kv_end, q_offset + min(q0 + BQ, Sq));
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_offset + q0 - window + 1) / BK * BK;

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = rt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  for (int n0 = kv_begin; n0 < kv_end; n0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += NT) {
      const int j = e / D, d = e % D;
      const bool ok = n0 + j < n_valid;
      const size_t off = static_cast<size_t>(n0 + j) * kv_row + d;
      k_s[d * KS + j] = ok ? rt::to_f(kb[off]) : 0.f;
      v_s[j * DMAX + d] = ok ? rt::to_f(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = q_s[d * QS + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = k_s[d * KS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      float rmax = rt::kNegInf;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int kpos = n0 + tx + 16 * c;
        const bool ok = kpos < n_valid && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[i][c] = ok ? s[i][c] : rt::kNegInf;
        rmax = fmaxf(rmax, s[i][c]);
      }
      // the 16 threads that share a row are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        rsum += s[i][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int c = 0; c < CPT; ++c) p_s[(tx + 16 * c) * QS + ty + 16 * i] = s[i][c];
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = p_s[j * QS + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = v_s[j * DMAX + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = tx + 16 * c;
      if (d < D) ob[r * q_row + d] = rt::from_f<T>(acc[i][c] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
           int Hq, int Hkv, int D, float scale, int causal, int window, int q_offset,
           int kv_len, void* stream) {
  if (D < 1 || D > DMAX || Hkv < 1 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd<T><<<grid, NT, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, Hq, Hkv, D, scale, causal, window, q_offset, kv_len);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                    int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                                    int causal, int window, int q_offset, int kv_len,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale, causal, window,
                               q_offset, kv_len, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B,
                                   int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                                   int causal, int window, int q_offset, int kv_len,
                                   void* stream) {
  return launch<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, scale, causal, window, q_offset,
                       kv_len, stream);
}

RT_EXPORT_ERROR_STRING(flash_attention)
