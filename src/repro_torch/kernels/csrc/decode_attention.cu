// Single-token GQA decode attention over a padded KV cache, for Hopper.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py:decode_attention
// (_decode_kernel, pallas_call at :86).  Same function: one query token per
// batch row attends to cache rows [0, cache_len[b]) with an fp32 online
// softmax; the whole GQA group of query heads shares each K/V tile.
//
// Layout: q (B,Hq,D), k/v caches (B,S,Hkv,D), cache_len (B,) int32, o like
// q; contiguous, bf16 or fp32; D <= 128, group = Hq/Hkv <= 16.  A row needs
// cache_len >= 1 (decode writes its own token before it attends); lengths
// above S are clamped to S.
//
// Design.  One block per (kv head, batch row) holds the group's queries in
// shared memory and walks its cache row in BK-key tiles up to cache_len,
// never touching the padding past it.  Per tile: K and V are staged in
// shared memory as fp32 (K with an odd stride, so the per-key dot products
// read conflict-free), each thread scores (query, key) pairs, one warp per
// query row does the max / exp / sum of the online softmax, and each thread
// updates its share of the group x D accumulators.  Products run on the
// CUDA cores: with one query token per row there is nothing for the tensor
// cores to reuse.
//
// Bound: bytes.  The kernel must read every valid cache row once (2 x
// len x D x 2 bytes per kv head in bf16) and does ~4 flops per byte, far
// below the card's ridge.  At decode batch sizes the grid has B x Hkv
// blocks, fewer than the 132 SMs, so most of the card idles: splitting the
// cache walk across blocks (partial softmax states plus a combine pass) is
// the next step for this kernel.
#include "common.cuh"

namespace {

constexpr int NT = 128;         // threads per block (4 warps)
constexpr int NW = NT / 32;
constexpr int BK = 64;          // keys per tile
constexpr int DMAX = 128;       // largest head dim the buffers hold
constexpr int GMAX = 16;        // largest GQA group
constexpr int KS = DMAX + 1;    // odd stride for K rows
constexpr int APT = GMAX * DMAX / NT;  // accumulators per thread
constexpr int SPT = GMAX * BK / NT;    // scores per thread
constexpr size_t kSmemBytes =
    sizeof(float) * (GMAX * DMAX + BK * KS + BK * DMAX + GMAX * BK + 2 * GMAX);

template <typename T>
__global__ void __launch_bounds__(NT)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const int* __restrict__ cache_len, T* __restrict__ o, int S, int Hq, int Hkv, int D,
           float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                  // [G][DMAX] pre-scaled queries
  float* k_s = q_s + GMAX * DMAX;     // [BK][KS]
  float* v_s = k_s + BK * KS;         // [BK][DMAX]
  float* p_s = v_s + BK * DMAX;       // [G][BK]  scores, then probabilities
  float* alpha_s = p_s + GMAX * BK;   // [G]      this tile's rescale factor
  float* l_s = alpha_s + GMAX;        // [G]      running denominators

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int len = min(cache_len[b], S);
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const T* qb = q + (static_cast<size_t>(b) * Hq + static_cast<size_t>(hk) * G) * D;
  const T* kb = k + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(hk) * D;
  const T* vb = v + static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(hk) * D;
  T* ob = o + (static_cast<size_t>(b) * Hq + static_cast<size_t>(hk) * G) * D;

  for (int e = tid; e < G * D; e += NT) q_s[e / D * DMAX + e % D] = rt::to_f(qb[e]) * scale;
  if (tid < G) l_s[tid] = 0.f;
  float m_row[GMAX / NW];             // running max of the rows this warp owns
#pragma unroll
  for (int i = 0; i < GMAX / NW; ++i) m_row[i] = rt::kNegInf;
  float acc[APT];
#pragma unroll
  for (int i = 0; i < APT; ++i) acc[i] = 0.f;

  for (int n0 = 0; n0 < len; n0 += BK) {
    __syncthreads();  // q_s / the previous tile's readers are done
    for (int e = tid; e < BK * D; e += NT) {
      const int j = e / D, d = e % D;
      const bool ok = n0 + j < len;
      const size_t off = static_cast<size_t>(n0 + j) * kv_row + d;
      k_s[j * KS + d] = ok ? rt::to_f(kb[off]) : 0.f;
      v_s[j * DMAX + d] = ok ? rt::to_f(vb[off]) : 0.f;
    }
    __syncthreads();

    // scores: pair e = g * BK + j, consecutive threads on consecutive keys
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int e = tid + i * NT;
      if (e < G * BK) {
        const int g = e / BK, j = e % BK;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(q_s[g * DMAX + d], k_s[j * KS + d], s);
        p_s[e] = (n0 + j < len) ? s : rt::kNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp w owns query rows w, w + NW, ...
#pragma unroll
    for (int i = 0; i < GMAX / NW; ++i) {
      const int g = warp + i * NW;
      if (g < G) {
        float* row = p_s + g * BK;
        float rmax = rt::kNegInf;
        for (int j = lane; j < BK; j += 32) rmax = fmaxf(rmax, row[j]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
        const float m_new = fmaxf(m_row[i], rmax);
        float rsum = 0.f;
        for (int j = lane; j < BK; j += 32) {
          const float p = expf(row[j] - m_new);
          row[j] = p;
          rsum += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
        const float alpha = expf(m_row[i] - m_new);
        m_row[i] = m_new;
        if (lane == 0) {
          alpha_s[g] = alpha;
          l_s[g] = l_s[g] * alpha + rsum;
        }
      }
    }
    __syncthreads();

    // acc[g][d] = acc * alpha[g] + sum_j p[g][j] v[j][d]
#pragma unroll
    for (int i = 0; i < APT; ++i) {
      const int e = tid + i * NT;
      if (e < G * D) {
        const int g = e / D, d = e % D;
        float a = acc[i] * alpha_s[g];
        const float* prow = p_s + g * BK;
        for (int j = 0; j < BK; ++j) a = fmaf(prow[j], v_s[j * DMAX + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < APT; ++i) {
    const int e = tid + i * NT;
    if (e < G * D) ob[e] = rt::from_f<T>(acc[i] / fmaxf(l_s[e / D], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* cache_len, void* o, int B,
           int S, int Hq, int Hkv, int D, float scale, void* stream) {
  if (D < 1 || D > DMAX || Hkv < 1 || Hq % Hkv != 0 || Hq / Hkv > GMAX)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      decode_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, B);
  decode_fwd<T><<<grid, NT, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(cache_len), static_cast<T*>(o), S, Hq, Hkv, D, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* cache_len, void* o, int B, int S, int Hq,
                                     int Hkv, int D, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, cache_len, o, B, S, Hq, Hkv, D, scale, stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* cache_len, void* o, int B, int S, int Hq,
                                    int Hkv, int D, float scale, void* stream) {
  return launch<float>(q, k, v, cache_len, o, B, S, Hq, Hkv, D, scale, stream);
}

RT_EXPORT_ERROR_STRING(decode_attention)
