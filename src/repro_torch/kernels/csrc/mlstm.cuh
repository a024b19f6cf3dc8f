// The mLSTM scan's gates, shared by the forward (mlstm_scan.cu) and its
// backward (mlstm_scan_bwd.cu): both rerun the same stabilisers from the
// same code, so they agree bit for bit.
#pragma once

#include "common.cuh"

namespace mlstm {

// Chunk c's gates, by one warp, from li/lf (rows at stride `stride`, `rows`
// of them valid): lis = logi (-1e30 past S, as the reference pads) and
// bcum = cumsum(logf) (logf 0 past S).
template <int T>
__device__ __forceinline__ void warp_gates(const float* li, const float* lf, size_t stride,
                                           int rows, float* lis, float* bcum) {
  constexpr int E = T / 32;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int r = lane * E + i;
    lis[r] = r < rows ? li[r * stride] : rt::kNegInf;
    bcum[r] = r < rows ? lf[r * stride] : 0.f;
  }
  rt::warp_cumsum<T>(bcum);             // each lane reads back only what it wrote
  __syncwarp();
}

// Every row's stabiliser, by one warp: m_row_t = max(bcum_t + m_in, max_{s <= t}
// w[t,s]), with max_s w[t,s] = bcum_t + max_{s <= t}(li_s - bcum_s), a
// prefix max (each lane reads only the rows its warp_gates call wrote).
template <int T>
__device__ __forceinline__ void warp_row_stab(const float* bcum, const float* lis, float m_in,
                                              float* mrow) {
  constexpr int E = T / 32;
  constexpr float kLowest = -3.0e38f;
  const int lane = threadIdx.x & 31;
  float loc[E], run = kLowest;
#pragma unroll
  for (int i = 0; i < E; ++i) loc[i] = run = fmaxf(run, lis[lane * E + i] - bcum[lane * E + i]);
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = fmaxf(incl, u);
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = kLowest;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float bt = bcum[lane * E + i];
    mrow[lane * E + i] = fmaxf(fmaxf(bt + m_in, bt + fmaxf(before, loc[i])), rt::kNegInf);
  }
  __syncwarp();
}

// The stabiliser entering every chunk of one (row, head), from the gates
// alone, by the whole block: a warp per chunk gives its cumsum F and tail
// max_s(li_s + F - bcum_s); one thread then walks m_next = max(F + m, tail)
// over the chunks into mo[0..nc), and with `final` also the stabiliser
// leaving the last chunk into mo[nc].  `sm` holds 2 nc + 2 T (blockDim / 32)
// floats; li/lf point at the (row, head)'s first gate (rows at stride H).
template <int T>
__device__ __forceinline__ void chunk_stabilisers(const float* li, const float* lf, int S, int H,
                                                  int nc, float* mo, bool final, float* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  float* ft = sm;                                    // [nc][2] F, tail
  float* lis = ft + 2 * nc + warp * 2 * T;          // this warp's chunk
  float* bcum = lis + T;
  constexpr int E = T / 32;
  for (int c = warp; c < nc; c += warps) {
    const size_t off = static_cast<size_t>(c) * T * H;
    warp_gates<T>(li + off, lf + off, H, min(T, S - c * T), lis, bcum);
    const float F = bcum[T - 1];
    float tail = rt::kNegInf;
#pragma unroll
    for (int i = 0; i < E; ++i) tail = fmaxf(tail, lis[lane * E + i] + (F - bcum[lane * E + i]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) tail = fmaxf(tail, __shfl_xor_sync(0xffffffffu, tail, o));
    if (lane == 0) {
      ft[2 * c] = F;
      ft[2 * c + 1] = tail;
    }
    __syncwarp();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = rt::kNegInf;
    for (int c = 0; c < nc; ++c) {
      mo[c] = m;
      m = fmaxf(ft[2 * c] + m, ft[2 * c + 1]);
    }
    if (final) mo[nc] = m;
  }
}

}  // namespace mlstm
