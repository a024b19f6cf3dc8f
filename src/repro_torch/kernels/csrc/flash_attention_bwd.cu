// Blocked causal / windowed GQA attention backward (training) for Hopper.
//
// The reference has no TPU kernel for this: it trains through plain jnp
// attention and differentiates it with jax.value_and_grad
// (repro/models/steps.py:44).  This computes the gradient of the plain twin
// (kernels/ref.py:flash_attention_ref), with the same masks: key j is seen
// by query i iff j < Skv, j <= i when causal, and i - j < window when
// window > 0 (q_offset 0, every key valid).  Given q, k, v, the output's
// gradient dO and the forward's fp32 log-sum-exp lse (B,Hq,Sq)
// (flash_attention.cu's LSE variant):
//
//   P = exp(scale Q K^T - lse), recomputed, masked;  dP = dO V^T
//   Delta_i = sum_j P_ij dP_ij                       flash_bwd_dq, pass 1
//   dS = P o (dP - Delta)
//   dQ = scale dS K                                  flash_bwd_dq, pass 2
//   dV = P^T dO,  dK = scale dS^T Q                  flash_bwd_dkdv
//
// Delta is the softmax backward's own row sum from the recomputed P and the
// fp32 dP, not rowsum(dO o O) from the stored bf16 output.  Both equal
// sum_j P_ij dP_ij exactly; in bf16 the second carries O's rounding (up to
// 2^-9 of |O|) into every dS of the row.  Where one key takes nearly all of
// a row's weight, dS is small and that rounding is not, and dq misses the
// fp32 gradient by several times the tolerance
// (ref.flash_attention_bwd_order_ref emulates both orders in the tests).
// The price is a first pass over the key tiles in the dQ kernel (Q K^T and
// dO V^T again).  The dQ kernel runs first and leaves Delta for the dK/dV
// kernel.  dS enters dQ = dS K and dK = dS^T Q as two bf16 halves (hi + lo,
// 16 mantissa bits, two tensor-core products each), not one: sum_j dS_ij
// is zero, so where a row's keys share a large common part dq cancels to
// far below sum_j |dS_ij| |k_j|, and one bf16 rounding of dS (2^-9) missed
// the fp32 gradient on a recorded call of the granite training step.
//
// Layout: q, dO, dq (B,Sq,Hq,D); k, v, dk, dv (B,Skv,Hkv,D); contiguous,
// bf16 or fp32; D <= 128.  dq, dk, dv are summed in fp32 and stored in the
// input dtype.
//
// On the card blocks run in parallel and in no order, so a sum across
// blocks needs atomics or a second pass.  Here each gradient has one owner:
// a dK/dV block owns 64 keys of one kv head for its whole life and loops
// over the query heads of its group (GQA: dK and dV sum over them inside the
// block) and over the 64-row query tiles that can see its keys; a dQ block
// owns 64 query rows of one head and loops over the key tiles it can see.
// Both recompute P.  No float atomics: the sums run in a fixed order, so
// the gradients repeat run to run.
//
// Bound: at the training shape (S 1024, D 128) five S x S x D products
// (Q K^T, dO V^T, P^T dO, dS^T Q, dS K), ~10 S^2 D H B / 2 flops causal, on
// ~7 S H D B bytes: far above the card's ridge, so the bound is operations.
// This kernel runs nine (Q K^T and dO V^T in both passes of the dQ kernel
// and in the dK/dV kernel), eleven in bf16 (the split dS).  This first
// kernel is simple rather than fast: four warps a block, each owning 16
// rows of its side, every product on mma.sync (bf16 operands from shared
// memory through rt::warp_mma, fp32 sums) or, for fp32 inputs, exact fp32
// FMAs in the same fragment layout.  In bf16, P is rounded to bf16 as the
// operand of dV = P^T dO; dP, Delta and dS are formed in fp32.  Tiles are
// staged with cp.async where D is a whole number of 16-byte vectors and
// pointers are aligned; P and dS pass through shared memory (fp32) between
// products.
#include "common.cuh"

namespace {

constexpr int kMaxHeadDim = 128;  // the wrapper's MAX_HEAD_DIM_BWD
constexpr int NT = 128;           // four warps
constexpr int BR = 64;            // rows a block owns: keys (dK/dV) or queries (dQ)
constexpr int BC = 64;            // rows of the other side a tile

using bf16 = __nv_bfloat16;

template <typename T> __host__ __device__ constexpr int row_stride(int w);
template <> __host__ __device__ constexpr int row_stride<bf16>(int w) { return rt::stride_bf16(w); }
template <> __host__ __device__ constexpr int row_stride<float>(int w) { return rt::stride_gq(w); }

// Shared memory: four tiles of 64 rows x DP columns (their row stride LD),
// one fp32 tile of 64 x 64 (P, then dS) and two vectors of 64 (lse, Delta).
template <typename T, int DP> struct Smem {
  static constexpr int LD = row_stride<T>(DP);
  static constexpr int LDP = rt::stride_gq(BC);
  static constexpr int TILE = BR * LD;                     // elements of one tile
  static constexpr size_t BYTES =
      4 * TILE * sizeof(T) + (BR * LDP + 2 * BR) * sizeof(float);
  static_assert(TILE * sizeof(T) % 16 == 0, "tiles stay 16-byte aligned");
  static_assert(BYTES <= 232448, "a block may use at most 227 KB of shared memory");
};

// acc (this warp's 16 x 8 NTILE fp32 tile, mma.sync's accumulator layout)
// += A (16 x [0,K)) . B ([0,K) x 8 NTILE).  bf16: rt::warp_mma on the tensor
// cores (K a multiple of 16); fp32: exact FMAs into the same layout.
template <bool TC, int NTILE, class FA, class FB>
__device__ __forceinline__ void mm(float (&acc)[NTILE][4], int K, FA a, FB b) {
  if constexpr (TC) {
    rt::warp_mma<true, NTILE>(acc, 0, K, a, b);
  } else {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    for (int k = 0; k < K; ++k) {
      const float a0 = a(g, k), a1 = a(g + 8, k);
#pragma unroll
      for (int j = 0; j < NTILE; ++j) {
        const float b0 = b(k, 8 * j + 2 * q), b1 = b(k, 8 * j + 2 * q + 1);
        acc[j][0] = fmaf(a0, b0, acc[j][0]);
        acc[j][1] = fmaf(a0, b1, acc[j][1]);
        acc[j][2] = fmaf(a1, b0, acc[j][2]);
        acc[j][3] = fmaf(a1, b1, acc[j][3]);
      }
    }
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// mm with A's fp32 values (dS) kept to 16 of their 24 mantissa bits on the
// tensor cores: A = hi + lo, both bf16, two products; fp32: mm.
template <bool TC, int NTILE, class FA, class FB>
__device__ __forceinline__ void mm_split(float (&acc)[NTILE][4], int K, FA a, FB b) {
  if constexpr (TC) {
    rt::warp_mma<true, NTILE>(acc, 0, K, [&](int r, int c) { return round_bf16(a(r, c)); }, b);
    rt::warp_mma<true, NTILE>(
        acc, 0, K, [&](int r, int c) { const float x = a(r, c); return x - round_bf16(x); }, b);
  } else {
    mm<false>(acc, K, a, b);
  }
}

template <int NTILE>
__device__ __forceinline__ void zero(float (&acc)[NTILE][4]) {
#pragma unroll
  for (int j = 0; j < NTILE; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

__device__ __forceinline__ bool visible(int qi, int kj, int Sq, int Skv, int causal, int window) {
  return qi < Sq && kj < Skv && (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
}

// Stage n rows of one head of a (B,S,H,D) tensor (``src`` its first row,
// rows ``row_stride_`` apart) into a BR x DP tile, zeros past n rows and D
// columns; the caller commits and waits.
template <typename T, int DP>
__device__ __forceinline__ void stage(T* dst, const T* src, size_t row_stride_, int n, int D,
                                      bool vec) {
  rt::stage_async(dst, Smem<T, DP>::LD, src, row_stride_, n, D, BR, DP, vec);
}

// dK, dV for 64 keys [n0, n0 + 64) of kv head blockIdx.y, batch row
// blockIdx.z; warp w owns keys n0 + 16 w + [0, 16).
template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq,
               int Skv, int Hq, int Hkv, int D, float scale, int causal, int window, int vec) {
  using M = Smem<T, DP>;
  constexpr bool TC = sizeof(T) == 2;
  constexpr int LD = M::LD, LDP = M::LDP, NO = DP / 8, NS = BC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + M::TILE;
  T* q_s = v_s + M::TILE;
  T* do_s = q_s + M::TILE;
  float* p_s = reinterpret_cast<float*>(do_s + M::TILE);
  float* lse_s = p_s + BR * LDP;
  float* dl_s = lse_s + BR;

  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int kw = (tid / 32) * 16;
  const int n0 = blockIdx.x * BR, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const size_t q_row = static_cast<size_t>(Hq) * D, kv_row = static_cast<size_t>(Hkv) * D;
  const size_t kv_off = (static_cast<size_t>(b) * Skv + n0) * kv_row + static_cast<size_t>(hk) * D;
  const int n_keys = min(BR, Skv - n0);
  stage<T, DP>(k_s, k + kv_off, kv_row, n_keys, D, vec);
  stage<T, DP>(v_s, v + kv_off, kv_row, n_keys, D, vec);
  rt::cp_async_commit();
  rt::cp_async_wait<0>();

  // the query rows that can see a key of this block
  const int q_end = window > 0 ? min(Sq, n0 + BR - 1 + window) : Sq;
  const int q_begin = causal ? min(n0, q_end) / BC * BC : 0;

  float dk_acc[NO][4], dv_acc[NO][4], s[NS][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const size_t q_off = static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * D;
    const float* lh = lse + (static_cast<size_t>(b) * Hq + h) * Sq;
    const float* dh = delta + (static_cast<size_t>(b) * Hq + h) * Sq;
    for (int i0 = q_begin; i0 < q_end; i0 += BC) {
      __syncthreads();   // the previous tile's readers are done
      const int n_rows = min(BC, Sq - i0);
      stage<T, DP>(q_s, q + q_off + static_cast<size_t>(i0) * q_row, q_row, n_rows, D, vec);
      stage<T, DP>(do_s, dout + q_off + static_cast<size_t>(i0) * q_row, q_row, n_rows, D, vec);
      if (tid < BC) {
        lse_s[tid] = tid < n_rows ? lh[i0 + tid] : 0.f;
        dl_s[tid] = tid < n_rows ? dh[i0 + tid] : 0.f;
      }
      rt::cp_async_commit();
      rt::cp_async_wait<0>();
      __syncthreads();

      // S^T = K Q^T (this warp's 16 keys x 64 queries), then P^T into p_s
      zero(s);
      mm<TC>(s, DP, [&](int r, int c) { return rt::to_f(k_s[(kw + r) * LD + c]); },
             [&](int c, int n) { return rt::to_f(q_s[n * LD + c]); });
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + 8 * (e >> 1), n = 8 * j + 2 * qd + (e & 1);
          const bool ok = visible(i0 + n, n0 + kw + r, Sq, Skv, causal, window);
          p_s[(kw + r) * LDP + n] = ok ? expf(s[j][e] * scale - lse_s[n]) : 0.f;
        }
      __syncwarp();
      // dV += P^T dO
      mm<TC>(dv_acc, BC, [&](int r, int c) { return p_s[(kw + r) * LDP + c]; },
             [&](int c, int n) { return rt::to_f(do_s[c * LD + n]); });
      // dP^T = V dO^T
      zero(s);
      mm<TC>(s, DP, [&](int r, int c) { return rt::to_f(v_s[(kw + r) * LD + c]); },
             [&](int c, int n) { return rt::to_f(do_s[n * LD + c]); });
      __syncwarp();      // every lane's reads of P^T are done
      // dS^T = P^T o (dP^T - Delta), over P^T in place
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + 8 * (e >> 1), n = 8 * j + 2 * qd + (e & 1);
          float& p = p_s[(kw + r) * LDP + n];
          p = p * (s[j][e] - dl_s[n]);
        }
      __syncwarp();
      // dK += dS^T Q (scaled at the store)
      mm_split<TC>(dk_acc, BC, [&](int r, int c) { return p_s[(kw + r) * LDP + c]; },
                   [&](int c, int n) { return rt::to_f(q_s[c * LD + n]); });
    }
  }

  T* dkb = dk + kv_off;
  T* dvb = dv + kv_off;
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = kw + g + 8 * (e >> 1), col = 8 * j + 2 * qd + (e & 1);
      if (r < n_keys && col < D) {
        dkb[r * kv_row + col] = rt::from_f<T>(dk_acc[j][e] * scale);
        dvb[r * kv_row + col] = rt::from_f<T>(dv_acc[j][e]);
      }
    }
}

// dQ, and Delta, for 64 query rows [i0, i0 + 64) of head blockIdx.y, batch
// row blockIdx.z; warp w owns rows i0 + 16 w + [0, 16).
template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv,
             int D, float scale, int causal, int window, int vec) {
  using M = Smem<T, DP>;
  constexpr bool TC = sizeof(T) == 2;
  constexpr int LD = M::LD, LDP = M::LDP, NO = DP / 8, NS = BC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + M::TILE;
  T* k_s = do_s + M::TILE;
  T* v_s = k_s + M::TILE;
  float* p_s = reinterpret_cast<float*>(v_s + M::TILE);
  float* lse_s = p_s + BR * LDP;
  float* dl_s = lse_s + BR;

  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int qw = (tid / 32) * 16;
  const int i0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_row = static_cast<size_t>(Hq) * D, kv_row = static_cast<size_t>(Hkv) * D;
  const size_t q_off = (static_cast<size_t>(b) * Sq + i0) * q_row + static_cast<size_t>(h) * D;
  const size_t kv_off = static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(hk) * D;
  const int n_rows = min(BR, Sq - i0);
  stage<T, DP>(q_s, q + q_off, q_row, n_rows, D, vec);
  stage<T, DP>(do_s, dout + q_off, q_row, n_rows, D, vec);
  if (tid < BR) lse_s[tid] = tid < n_rows ? lse[(static_cast<size_t>(b) * Hq + h) * Sq + i0 + tid]
                                         : 0.f;
  rt::cp_async_commit();
  rt::cp_async_wait<0>();

  // the keys any row of this block can see
  const int kv_end = causal ? min(Skv, i0 + n_rows) : Skv;
  const int kv_begin = window > 0 ? max(0, i0 - window + 1) / BC * BC : 0;

  // P and dP of key tile n0 for this warp's 16 rows: s (probabilities,
  // masked), dp
  float s[NS][4], dp[NS][4];
  auto scores = [&](int n0) {
    __syncthreads();   // the previous tile's readers are done (and q_s, do_s landed)
    const int n_keys = min(BC, Skv - n0);
    stage<T, DP>(k_s, k + kv_off + static_cast<size_t>(n0) * kv_row, kv_row, n_keys, D, vec);
    stage<T, DP>(v_s, v + kv_off + static_cast<size_t>(n0) * kv_row, kv_row, n_keys, D, vec);
    rt::cp_async_commit();
    rt::cp_async_wait<0>();
    __syncthreads();
    zero(s);
    mm<TC>(s, DP, [&](int r, int c) { return rt::to_f(q_s[(qw + r) * LD + c]); },
           [&](int c, int n) { return rt::to_f(k_s[n * LD + c]); });
    zero(dp);
    mm<TC>(dp, DP, [&](int r, int c) { return rt::to_f(do_s[(qw + r) * LD + c]); },
           [&](int c, int n) { return rt::to_f(v_s[n * LD + c]); });
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = qw + g + 8 * (e >> 1), n = 8 * j + 2 * qd + (e & 1);
        const bool ok = visible(i0 + r, n0 + n, Sq, Skv, causal, window);
        s[j][e] = ok ? expf(s[j][e] * scale - lse_s[r]) : 0.f;
      }
  };

  // pass 1: Delta_i = sum_j P_ij dP_ij (this lane's columns, then its quad's)
  float dsum[2] = {0.f, 0.f};
  for (int n0 = kv_begin; n0 < kv_end; n0 += BC) {
    scores(n0);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dsum[e >> 1] = fmaf(s[j][e], dp[j][e], dsum[e >> 1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], 1);
    dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], 2);
    const int r = qw + g + 8 * i;
    if (qd == 0) {
      dl_s[r] = dsum[i];
      if (r < n_rows) delta[(static_cast<size_t>(b) * Hq + h) * Sq + i0 + r] = dsum[i];
    }
  }
  __syncwarp();

  // pass 2: dS = P o (dP - Delta) into p_s; dQ += dS K
  float dq_acc[NO][4];
  zero(dq_acc);
  for (int n0 = kv_begin; n0 < kv_end; n0 += BC) {
    scores(n0);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = qw + g + 8 * (e >> 1), n = 8 * j + 2 * qd + (e & 1);
        p_s[r * LDP + n] = s[j][e] * (dp[j][e] - dl_s[r]);
      }
    __syncwarp();
    // dQ += dS K (scaled at the store)
    mm_split<TC>(dq_acc, BC, [&](int r, int c) { return p_s[(qw + r) * LDP + c]; },
                 [&](int c, int n) { return rt::to_f(k_s[c * LD + n]); });
  }

  T* dqb = dq + q_off;
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = qw + g + 8 * (e >> 1), col = 8 * j + 2 * qd + (e & 1);
      if (r < n_rows && col < D) dqb[r * q_row + col] = rt::from_f<T>(dq_acc[j][e] * scale);
    }
}

template <typename T, int DP>
cudaError_t launch_dp(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                      float* delta, T* dq, T* dk, T* dv, int B, int Sq, int Skv, int Hq, int Hkv,
                      int D, float scale, int causal, int window, int vec, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(Smem<T, DP>::BYTES);
  static std::atomic<unsigned> set_kv{0}, set_q{0};
  cudaError_t err = rt::smem_limit_once(flash_bwd_dkdv<T, DP>, smem, set_kv);
  if (err != cudaSuccess) return err;
  err = rt::smem_limit_once(flash_bwd_dq<T, DP>, smem, set_q);
  if (err != cudaSuccess) return err;
  flash_bwd_dq<T, DP><<<dim3((Sq + BR - 1) / BR, Hq, B), NT, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Skv, Hq, Hkv, D, scale, causal, window, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<T, DP><<<dim3((Skv + BR - 1) / BR, Hkv, B), NT, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Skv, Hq, Hkv, D, scale, causal, window, vec);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q_, const void* k_, const void* v_, const void* do_, const float* lse,
           float* delta, void* dq_, void* dk_, void* dv_, int B, int Sq,
           int Skv, int Hq, int Hkv, int D, float scale, int causal, int window, void* stream_) {
  if (D < 1 || D > kMaxHeadDim || Hkv < 1 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Skv == 0) return cudaSuccess;
  const auto q = static_cast<const T*>(q_);
  const auto k = static_cast<const T*>(k_);
  const auto v = static_cast<const T*>(v_);
  const auto dout = static_cast<const T*>(do_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q_) | reinterpret_cast<uintptr_t>(k_) |
                         reinterpret_cast<uintptr_t>(v_) | reinterpret_cast<uintptr_t>(do_);
  const int vec = D * sizeof(T) % 16 == 0 && ptrs % 16 == 0;
  const auto dq = static_cast<T*>(dq_);
  const auto dk = static_cast<T*>(dk_);
  const auto dv = static_cast<T*>(dv_);
  return D <= 64 ? launch_dp<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv,
                                    D, scale, causal, window, vec, stream)
                 : launch_dp<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq,
                                     Hkv, D, scale, causal, window, vec, stream);
}

}  // namespace

// delta: (B,Hq,Sq) fp32 scratch (Delta, from the dQ kernel to the dK/dV one)
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, float* delta,
                                        void* dq, void* dk, void* dv, int B, int Sq, int Skv,
                                        int Hq, int Hkv, int D, float scale, int causal,
                                        int window, void* stream) {
  return launch<bf16>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv, D, scale,
                      causal, window, stream);
}

extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, float* delta,
                                       void* dq, void* dk, void* dv, int B, int Sq, int Skv,
                                       int Hq, int Hkv, int D, float scale, int causal,
                                       int window, void* stream) {
  return launch<float>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv, D, scale,
                       causal, window, stream);
}

RT_EXPORT_ERROR_STRING(flash_attention_bwd)
