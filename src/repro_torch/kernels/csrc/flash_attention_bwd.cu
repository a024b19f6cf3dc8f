// Blocked causal / windowed GQA attention backward (training) for Hopper.
//
// The reference has no TPU kernel for this: it trains through plain jnp
// attention and differentiates it with jax.value_and_grad
// (repro/models/steps.py:44).  This computes the gradient of the plain twin
// (kernels/ref.py:flash_attention_ref), with the same masks: key j is seen
// by query i iff j < Skv, j <= i when causal, and i - j < window when
// window > 0 (q_offset 0, every key valid).  Given q, k, v, the output's
// gradient dO, and from the forward's LSE variant (flash_attention.cu) the
// fp32 log-sum-exp lse (B,Hq,Sq) and the fp32 output O32 (B,Sq,Hq,D):
//
//   Delta_i = sum_d dO_id O32_id                     flash_bwd_dq, prologue
//   P = exp(scale Q K^T - lse), recomputed, masked;  dP = dO V^T
//   dS = P o (dP - Delta)
//   dQ = scale dS K                                  flash_bwd_dq
//   dV = P^T dO,  dK = scale dS^T Q                  flash_bwd_dkdv
//
// Layout: q, dO, dq (B,Sq,Hq,D); k, v, dk, dv (B,Skv,Hkv,D); contiguous,
// bf16 or fp32; D <= 128.  dq, dk, dv are summed in fp32 and stored in the
// input dtype.
//
// Bound: at the training shape (S 1024, D 128, causal) five S x S x D
// products over the visible pairs (Q K^T, dO V^T, P^T dO, dS^T Q, dS K),
// ~10 S^2 D H B / 2 flops, on ~7 S H D B bytes: far above the card's ridge,
// so the bound is operations.
//
// Repeatable gradients: on the card blocks run in parallel and in no
// order, so a sum across blocks needs atomics or a second pass.  Here each
// gradient has one owner block and sums in a fixed order, with no float
// atomics, so the gradients repeat bit for bit run to run: a dK/dV block
// owns keys of one kv head for its whole life and loops over the query
// heads of its group (GQA: dK and dV sum over them inside the block) and
// the query tiles that can see its keys; a dQ block owns query rows of one
// head and loops over the key tiles they can see.  The price is that both
// kernels recompute P and dP: the dQ kernel's Q K^T and dO V^T are two
// products the usual flash backward (dQ by atomics from the dK/dV loop)
// does not run.
//
// The order of rounding (ref.flash_attention_bwd_order_ref emulates it;
// tests/test_torch_kernels.py holds it and the alternatives to the fp32
// gradient on the CPU; tools/flash_bwd_probe.py on the card's recorded
// calls of a granite training step, where the kernel matches its
// emulation: the shares below are the largest over dq, dk, dv there, of
// the card's rule).  Two kinds of gradient row defeat the usual bf16 flash
// backward: a nearly one-hot row, where Delta = rowsum(dO o O) from the
// bf16 output carries O's rounding (2^-9 of |O|) into every small dS of the
// row (7.9x over the rule), and keys with a large common part, where
// dq = scale sum_j dS_ij k_j cancels far below sum_j |dS_ij| |k_j|
// (sum_j dS_ij = 0) and one bf16 rounding of dS survives the cancellation
// (3.3x over).  PR 20's kernel took Delta = sum_j P dP from a first pass
// (Q K^T and dO V^T once more: two products a tile).  This one:
// * Delta = rowsum(dO o O32), O32 the forward's output before its bf16
//   rounding, normalised by the sum of the bf16 P that entered its P V
//   product: a row of O32 is an exact average of the rows of V under
//   weights that sum to one, so Delta carries only the rounding of P's
//   relative weights (normalised by l, the fp32 P's sum, the first rows
//   read 977).  Where a dQ block's band of keys spans at most kExactTiles
//   (4) tiles, its rows see few keys, Delta's error is largest against
//   their gradients, and the first row's exact dq is zero: there a first
//   sweep takes Delta = sum_j P dP from the kernel's own dP (rows 0-255 of
//   a causal head; two products a tile on 10 of 136 tile pairs a head at S
//   1024).  With O32 in every block: 0.895; exact only where the band is
//   one tile: 0.484.
// * dq takes the keys centred: dq_i = scale sum_j dS_ij (k_j - c) for any
//   constant c, since sum_j dS_ij = 0.  The kernel sums dS K and the row
//   sums rs_i of the same rounded dS, and stores scale (dS K - c rs_i):
//   exactly scale sum_j dS_ij (k_j - c) with k_j - c in fp32, for the
//   rounded dS.  rs_i is Delta's error, so what is left of it in dq is
//   rs_i (sum_j P_ij k_j - c): c is the mean of the block's band of keys,
//   summed from the K tiles as they pass: 0.441 (dq 0.30-0.33), as with the
//   row's own P-weighted mean (another product); the mean of the block's
//   first tile 0.546, of its diagonal tile 0.626.  Uncentred, Delta from
//   O32 misses the common-keys input by 3.3x.
// * dS enters dQ = dS K and dK = dS^T Q as two bf16 halves (hi + lo, 16
//   mantissa bits): one bf16 dS in dQ reads 1.470, in dK 0.739; split, the
//   largest share is dv's 0.44, which P's own bf16 rounding as the operand
//   of dV = P^T dO sets.
// P, dP and dS stay fp32 in registers until they are rounded as operands.
//
// Two kernels a dtype.  bf16 (tc::): every product on wgmma (wgmma.cuh,
// shared with the forward): tiles in shared memory in the swizzled layout
// the descriptors read, the products that read two tiles as SS, those
// whose left factor is P, dS or their transposes as RS with the bf16
// fragments in registers and the tile read MN-major.  A block is one
// consumer warpgroup owning 64 rows, with a two-stage cp.async ring, so
// tile i+1 loads while tile i is multiplied; the two SS products of a
// tile go out as two wgmma groups, so P is formed while dP is multiplied
// (and in dK/dV, dS while dV is).  Two blocks share an SM and run out of
// step: one forms P while the other multiplies.  (Two warpgroups a block
// sharing the ring, as the forward has, must meet at a barrier every tile:
// 2.5-5 % slower, tools/kernel_variants.py on the H100.)
// * flash_bwd_dq_tc mirrors the forward: Q and dO resident, 64-key K/V
//   tiles through the ring; Delta in its prologue from the dO and O32 rows
//   it owns (or its first sweep), written for the dK/dV kernel; S = Q K^T
//   and dP = dO V^T (SS), P and dS in registers, dQ += dS K (RS, hi and
//   lo); the band's key sums from the K tiles in shared memory.  Four
//   products a tile.
// * flash_bwd_dkdv_tc: 64 keys of one kv head a block, K and V resident,
//   64-row Q and dO tiles (with their lse and Delta) through the ring;
//   S^T = K Q^T and dP^T = V dO^T (SS), P^T and dS^T in registers,
//   dV += P^T dO and dK += dS^T Q (RS, hi and lo).  Five products a tile.
// At D 128 a thread of the dK/dV kernel holds dK and dV (128 fp32
// registers) beside S^T and dP^T (64): 255 registers (dQ: 254), no spill,
// once each tile's wgmma descriptors are one base and 32-bit adds
// (wgmma.cuh's desc_at; formed whole and hoisted out of the loop, the
// loop-invariant descriptors spilled).
// Head dims take a compile-time tile of 16, 32, 64 or 128 columns, D
// zero-padded up to it; where D is not a whole number of 16-byte vectors or
// a pointer is misaligned, the tiles are staged with plain loads.  Both
// grids start longest first: the dQ kernel every head's last query block
// (it sees the most keys under a causal mask), the dK/dV kernel every kv
// head's first key block (seen by the most queries).
//
// fp32 (f32::): exact CUDA-core FMAs (tensor cores would round the inputs),
// for the parity checks that hold the port to 1e-3 and below.  Four warps
// a block, each owning 16 rows of its side; P and dS pass through shared
// memory between products; Delta from O32 (the fp32 output) as in bf16.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxHeadDim = 128;  // the wrapper's MAX_HEAD_DIM_BWD

// Delta_i = sum_d dO_id O32_id for the row a lane's quad shares: the four
// lanes t of a quad take the columns t, t + 4, ..., then sum across the
// quad (every lane of the warp calls this).  ok: the row exists.
template <typename T, int DP>
__device__ __forceinline__ float row_delta(const T* dorow, const float* orow, int D, int t,
                                           bool ok) {
  float s = 0.f;
  if (ok) {
#pragma unroll
    for (int u = 0; u < DP / 4; ++u) {
      const int c = t + 4 * u;
      if (c < D) s = fmaf(rt::to_f(dorow[c]), orow[c], s);
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

__device__ __forceinline__ bool visible(int qi, int kj, int Sq, int Skv, int causal, int window) {
  return qi < Sq && kj < Skv && (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int NT = 128;           // four warps
constexpr int BR = 64;            // rows a block owns: keys (dK/dV) or queries (dQ)
constexpr int BC = 64;            // rows of the other side a tile

// Shared memory: four tiles of 64 rows x DP columns (their row stride LD),
// one tile of 64 x 64 (P, then dS) and two vectors of 64 (lse, Delta).
template <int DP> struct Smem {
  static constexpr int LD = rt::stride_gq(DP);
  static constexpr int LDP = rt::stride_gq(BC);
  static constexpr int TILE = BR * LD;                     // elements of one tile
  static constexpr size_t BYTES = (4 * TILE + BR * LDP + 2 * BR) * sizeof(float);
  static_assert(TILE * sizeof(float) % 16 == 0, "tiles stay 16-byte aligned");
  static_assert(BYTES <= 232448, "a block may use at most 227 KB of shared memory");
};

// acc (this warp's 16 x 8 NTILE tile, mma.sync's accumulator layout) +=
// A (16 x [0,K)) . B ([0,K) x 8 NTILE), exact fp32 FMAs
template <int NTILE, class FA, class FB>
__device__ __forceinline__ void mm(float (&acc)[NTILE][4], int K, FA a, FB b) {
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

template <int NTILE>
__device__ __forceinline__ void zero(float (&acc)[NTILE][4]) {
#pragma unroll
  for (int j = 0; j < NTILE; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// Stage n rows of one head of a (B,S,H,D) tensor (``src`` its first row,
// rows ``rs`` apart) into a BR x DP tile, zeros past n rows and D columns;
// the caller commits and waits.
template <int DP>
__device__ __forceinline__ void stage(float* dst, const float* src, size_t rs, int n, int D,
                                      bool vec) {
  rt::stage_async(dst, Smem<DP>::LD, src, rs, n, D, BR, DP, vec);
}

// dK, dV for 64 keys [n0, n0 + 64) of kv head blockIdx.y, batch row
// blockIdx.z; warp w owns keys n0 + 16 w + [0, 16).
template <int DP>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv,
               int D, float scale, int causal, int window, int vec) {
  using M = Smem<DP>;
  constexpr int LD = M::LD, LDP = M::LDP, NO = DP / 8, NS = BC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);
  float* v_s = k_s + M::TILE;
  float* q_s = v_s + M::TILE;
  float* do_s = q_s + M::TILE;
  float* p_s = do_s + M::TILE;
  float* lse_s = p_s + BR * LDP;
  float* dl_s = lse_s + BR;

  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int kw = (tid / 32) * 16;
  const int n0 = blockIdx.x * BR, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const size_t q_row = static_cast<size_t>(Hq) * D, kv_row = static_cast<size_t>(Hkv) * D;
  const size_t kv_off = (static_cast<size_t>(b) * Skv + n0) * kv_row + static_cast<size_t>(hk) * D;
  const int n_keys = min(BR, Skv - n0);
  stage<DP>(k_s, k + kv_off, kv_row, n_keys, D, vec);
  stage<DP>(v_s, v + kv_off, kv_row, n_keys, D, vec);
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
      stage<DP>(q_s, q + q_off + static_cast<size_t>(i0) * q_row, q_row, n_rows, D, vec);
      stage<DP>(do_s, dout + q_off + static_cast<size_t>(i0) * q_row, q_row, n_rows, D, vec);
      if (tid < BC) {
        lse_s[tid] = tid < n_rows ? lh[i0 + tid] : 0.f;
        dl_s[tid] = tid < n_rows ? dh[i0 + tid] : 0.f;
      }
      rt::cp_async_commit();
      rt::cp_async_wait<0>();
      __syncthreads();

      // S^T = K Q^T (this warp's 16 keys x 64 queries), then P^T into p_s
      zero(s);
      mm(s, DP, [&](int r, int c) { return k_s[(kw + r) * LD + c]; },
         [&](int c, int n) { return q_s[n * LD + c]; });
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
      mm(dv_acc, BC, [&](int r, int c) { return p_s[(kw + r) * LDP + c]; },
         [&](int c, int n) { return do_s[c * LD + n]; });
      // dP^T = V dO^T
      zero(s);
      mm(s, DP, [&](int r, int c) { return v_s[(kw + r) * LD + c]; },
         [&](int c, int n) { return do_s[n * LD + c]; });
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
      mm(dk_acc, BC, [&](int r, int c) { return p_s[(kw + r) * LDP + c]; },
         [&](int c, int n) { return q_s[c * LD + n]; });
    }
  }

  float* dkb = dk + kv_off;
  float* dvb = dv + kv_off;
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = kw + g + 8 * (e >> 1), col = 8 * j + 2 * qd + (e & 1);
      if (r < n_keys && col < D) {
        dkb[r * kv_row + col] = dk_acc[j][e] * scale;
        dvb[r * kv_row + col] = dv_acc[j][e];
      }
    }
}

// dQ, and Delta, for 64 query rows [i0, i0 + 64) of head blockIdx.y, batch
// row blockIdx.z; warp w owns rows i0 + 16 w + [0, 16).
template <int DP>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ o32,
             float* __restrict__ delta, float* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv,
             int D, float scale, int causal, int window, int vec) {
  using M = Smem<DP>;
  constexpr int LD = M::LD, LDP = M::LDP, NO = DP / 8, NS = BC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* do_s = q_s + M::TILE;
  float* k_s = do_s + M::TILE;
  float* v_s = k_s + M::TILE;
  float* p_s = v_s + M::TILE;
  float* lse_s = p_s + BR * LDP;

  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int qw = (tid / 32) * 16;
  const int i0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_row = static_cast<size_t>(Hq) * D, kv_row = static_cast<size_t>(Hkv) * D;
  const size_t q_off = (static_cast<size_t>(b) * Sq + i0) * q_row + static_cast<size_t>(h) * D;
  const size_t kv_off = static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(hk) * D;
  const int n_rows = min(BR, Sq - i0);
  stage<DP>(q_s, q + q_off, q_row, n_rows, D, vec);
  stage<DP>(do_s, dout + q_off, q_row, n_rows, D, vec);
  if (tid < BR) lse_s[tid] = tid < n_rows ? lse[(static_cast<size_t>(b) * Hq + h) * Sq + i0 + tid]
                                         : 0.f;
  rt::cp_async_commit();

  // Delta of this lane's two rows, from dO and O32 (the fp32 output)
  float dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qw + g + 8 * i;
    const size_t off = q_off + static_cast<size_t>(r) * q_row;
    dl[i] = row_delta<float, DP>(dout + off, o32 + off, D, qd, r < n_rows);
    if (qd == 0 && r < n_rows) delta[(static_cast<size_t>(b) * Hq + h) * Sq + i0 + r] = dl[i];
  }
  rt::cp_async_wait<0>();

  // the keys any row of this block can see
  const int kv_end = causal ? min(Skv, i0 + n_rows) : Skv;
  const int kv_begin = window > 0 ? max(0, i0 - window + 1) / BC * BC : 0;

  float s[NS][4], dp[NS][4], dq_acc[NO][4];
  zero(dq_acc);
  for (int n0 = kv_begin; n0 < kv_end; n0 += BC) {
    __syncthreads();   // the previous tile's readers are done (and q_s, do_s landed)
    const int n_keys = min(BC, Skv - n0);
    stage<DP>(k_s, k + kv_off + static_cast<size_t>(n0) * kv_row, kv_row, n_keys, D, vec);
    stage<DP>(v_s, v + kv_off + static_cast<size_t>(n0) * kv_row, kv_row, n_keys, D, vec);
    rt::cp_async_commit();
    rt::cp_async_wait<0>();
    __syncthreads();
    zero(s);
    mm(s, DP, [&](int r, int c) { return q_s[(qw + r) * LD + c]; },
       [&](int c, int n) { return k_s[n * LD + c]; });
    zero(dp);
    mm(dp, DP, [&](int r, int c) { return do_s[(qw + r) * LD + c]; },
       [&](int c, int n) { return v_s[n * LD + c]; });
    // dS = P o (dP - Delta) into p_s
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = qw + g + 8 * (e >> 1), n = 8 * j + 2 * qd + (e & 1);
        const bool ok = visible(i0 + r, n0 + n, Sq, Skv, causal, window);
        const float p = ok ? expf(s[j][e] * scale - lse_s[r]) : 0.f;
        p_s[r * LDP + n] = p * (dp[j][e] - dl[e >> 1]);
      }
    __syncwarp();
    // dQ += dS K (scaled at the store)
    mm(dq_acc, BC, [&](int r, int c) { return p_s[(qw + r) * LDP + c]; },
       [&](int c, int n) { return k_s[c * LD + n]; });
  }

  float* dqb = dq + q_off;
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = qw + g + 8 * (e >> 1), col = 8 * j + 2 * qd + (e & 1);
      if (r < n_rows && col < D) dqb[r * q_row + col] = dq_acc[j][e] * scale;
    }
}

template <int DP>
cudaError_t launch_dp(const float* q, const float* k, const float* v, const float* dout,
                      const float* lse, const float* o32, float* delta, float* dq, float* dk,
                      float* dv, int B, int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                      int causal, int window, int vec, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(Smem<DP>::BYTES);
  static std::atomic<unsigned> set_kv{0}, set_q{0};
  cudaError_t err = rt::smem_limit_once(flash_bwd_dkdv<DP>, smem, set_kv);
  if (err != cudaSuccess) return err;
  err = rt::smem_limit_once(flash_bwd_dq<DP>, smem, set_q);
  if (err != cudaSuccess) return err;
  flash_bwd_dq<DP><<<dim3((Sq + BR - 1) / BR, Hq, B), NT, smem, stream>>>(
      q, k, v, dout, lse, o32, delta, dq, Sq, Skv, Hq, Hkv, D, scale, causal, window, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv<DP><<<dim3((Skv + BR - 1) / BR, Hkv, B), NT, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Skv, Hq, Hkv, D, scale, causal, window, vec);
  return cudaGetLastError();
}

int launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
           const float* o32, float* delta, float* dq, float* dk, float* dv, int B, int Sq,
           int Skv, int Hq, int Hkv, int D, float scale, int causal, int window,
           cudaStream_t stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  const int vec = D % 4 == 0 && ptrs % 16 == 0;
  return D <= 64 ? launch_dp<64>(q, k, v, dout, lse, o32, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv,
                                 D, scale, causal, window, vec, stream)
                 : launch_dp<128>(q, k, v, dout, lse, o32, delta, dq, dk, dv, B, Sq, Skv, Hq,
                                  Hkv, D, scale, causal, window, vec, stream);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;           // one consumer warpgroup a block, two blocks an SM
constexpr int BO = 64 * NT / 128; // rows a block owns: queries (dQ) or keys (dK/dV), 64 a warpgroup
constexpr int BTK = 64;           // keys a ring tile of the dQ kernel holds
constexpr int BTQ = 64;           // queries a ring tile of the dK/dV kernel holds
constexpr int NSTAGE = 2;         // the ring: tile i+1 loads while tile i is used
// The two SS products of a tile go out as two wgmma groups: P is formed
// while dP is still being multiplied, and (dK/dV) dS while dV += P^T dO is.
constexpr bool kOverlap = true;
// dQ blocks whose band of keys spans at most this many tiles take Delta =
// sum_j P dP from a first sweep (the header says why)
constexpr int kExactTiles = 4;

// Shared memory, from a 1024-byte aligned base: the block's two own tiles
// (Q and dO; K and V) of BO rows, NSTAGE ring stages of two tiles (K and V
// of BTK rows; Q and dO of BTQ), then fp32 vectors: the dQ kernel's partial
// key column sums (8 a thread), the dK/dV kernel's lse and Delta of each
// stage.
template <int DP> struct Cfg : sm90::Layout<DP> {
  static constexpr int OWN = BO * DP * 2;
  static constexpr int RING_K = BTK * DP * 2, RING_Q = BTQ * DP * 2;
  static constexpr int DQ_TILES = 2 * OWN + NSTAGE * 2 * RING_K;
  static constexpr int DKDV_TILES = 2 * OWN + NSTAGE * 2 * RING_Q;
  static constexpr int DQ_SMEM = DQ_TILES + NT * 8 * 4 + 1024;      // + alignment slack
  static constexpr int DKDV_SMEM = DKDV_TILES + NSTAGE * 2 * BTQ * 4 + 1024;
  static_assert(DQ_SMEM <= 232448 && DKDV_SMEM <= 232448,
                "a block may use at most 227 KB of shared memory");
};

// the swizzle acts on shared-memory address bits: align the tiles to 1024
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw, uint32_t& addr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  const uint32_t shift = (1024 - (a & 1023)) & 1023;
  addr = a + shift;
  return raw + shift;
}

// dQ and Delta for query rows [q0, q0 + BO) of head blockIdx.x, batch row
// blockIdx.z; warpgroup w owns rows q0 + 64 w + [0, 64), the accumulator
// layout of wgmma.cuh.
template <int DP, bool VEC>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ o32,
                float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Skv, int Hq,
                int Hkv, int D, float scale, int causal, int window) {
  using C = Cfg<DP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint32_t base;
  unsigned char* smem = aligned_smem(smem_raw, base);
  float* csum = reinterpret_cast<float*>(smem + C::DQ_TILES);

  const int tid = threadIdx.x, wgi = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
  const int g = lane / 4, t = lane % 4;
  // blocks start in launch order, x fastest: every head's last (longest,
  // under a causal mask) query block first
  const int h = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * BO, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_row = static_cast<size_t>(Hq) * D, kv_row = static_cast<size_t>(Hkv) * D;
  const size_t q_head = static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * D;
  const bf16* kb = k + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(hk) * D;
  const bf16* vb = v + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(hk) * D;

  // the band of keys any row of this block can see, in whole tiles
  const int kv_end = causal ? min(Skv, min(q0 + BO, Sq)) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BTK * BTK : 0;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BTK - 1) / BTK : 0;

  // K/V tile `it` goes to stage it % NSTAGE, NSTAGE - 1 tiles ahead of use;
  // one cp.async group per tile (empty past the end)
  auto load_kv = [&](int it) {
    if (it < n_tiles) {
      unsigned char* st = smem + 2 * C::OWN + (it % NSTAGE) * 2 * C::RING_K;
      const int r0 = kv_begin + it * BTK;
      sm90::load_tile<DP, BTK, VEC, NT>(st, kb, kv_row, r0, Skv, D, tid);
      sm90::load_tile<DP, BTK, VEC, NT>(st + C::RING_K, vb, kv_row, r0, Skv, D, tid);
    }
    if constexpr (VEC) rt::cp_async_commit();
  };
  sm90::load_tile<DP, BO, VEC, NT>(smem, q + q_head, q_row, q0, Sq, D, tid);
  sm90::load_tile<DP, BO, VEC, NT>(smem + C::OWN, dout + q_head, q_row, q0, Sq, D, tid);

  // this warpgroup's rows, and this thread's two
  const int wr0 = q0 + 64 * wgi;
  const bool has_rows = wr0 < Sq;
  const int lo = wr0, hi = min(wr0 + 63, Sq - 1);
  int row[2];
  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = wr0 + 16 * warp + g + 8 * i;
    lse2[i] = row[i] < Sq ? lse[(static_cast<size_t>(b) * Hq + h) * Sq + row[i]] * rt::kLog2e
                          : 0.f;
  }
  const float sl2 = scale * rt::kLog2e;
  const uint32_t q_addr = base + 64 * wgi * C::RB, do_addr = q_addr + C::OWN;

  // One sweep over the band's K/V tiles through the ring: every(it) once
  // tile `it` has landed; then, where the warpgroup's rows see the tile
  // (keys n0 ..), tile(it, n0, k_addr, s, dp) with S = Q K^T in s (waited
  // for) and dP = dO V^T in dp (in flight until wgmma_wait<0>).
  auto sweep = [&](auto every, auto tile) {
#pragma unroll
    for (int it = 0; it < NSTAGE - 1; ++it) load_kv(it);
    for (int it = 0; it < n_tiles; ++it) {
      if constexpr (VEC) rt::cp_async_wait<NSTAGE - 2>();
      sm90::fence_async_shared();
      __syncthreads();   // tile `it` (and Q, dO) landed; tile it - 1's stage is free
      load_kv(it + NSTAGE - 1);
      every(it);
      const int n0 = kv_begin + it * BTK;
      // skip a tile none of this warpgroup's rows can see
      if (!has_rows || (causal && n0 > hi) || (window > 0 && n0 + BTK - 1 <= lo - window))
        continue;
      const uint32_t k_addr = base + 2 * C::OWN + (it % NSTAGE) * 2 * C::RING_K;
      const uint32_t v_addr = k_addr + C::RING_K;
      float s[BTK / 2], dp[BTK / 2];
      sm90::wgmma_fence();
      sm90::ss_product<DP, BO, BTK>(s, q_addr, k_addr);
      sm90::wgmma_commit();
      sm90::ss_product<DP, BO, BTK>(dp, do_addr, v_addr);
      sm90::wgmma_commit();
      sm90::wgmma_wait<kOverlap ? 1 : 0>();
      sm90::fence_regs(s);
      tile(it, n0, k_addr, s, dp);
    }
    if constexpr (VEC) rt::cp_async_wait<0>();   // no copy outlives the sweep
    __syncthreads();                              // the ring is free again
  };
  // P = exp2(S scale log2 e - lse log2 e), masked, in s
  auto probabilities = [&](int n0, float (&s)[BTK / 2]) {
    const bool need_mask = n0 + BTK > Skv || (causal && n0 + BTK - 1 > lo) ||
                           (window > 0 && n0 <= hi - window);
#pragma unroll
    for (int j = 0; j < BTK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[4 * j + 2 * i + c];
          x = sm90::fast_exp2(fmaf(x, sl2, -lse2[i]));
          if (need_mask) x = visible(row[i], n0 + 8 * j + 2 * t + c, Sq, Skv, causal, window)
                                 ? x : 0.f;
        }
  };

  // Delta of this thread's two rows, written for the dK/dV kernel: where
  // the band spans at most kExactTiles tiles, sum_j P dP from a first sweep
  // (two products a tile); else rowsum(dO o O32)
  float dl[2] = {0.f, 0.f};
  if (n_tiles <= kExactTiles) {
    sweep([](int) {}, [&](int, int n0, uint32_t, float (&s)[BTK / 2], float (&dp)[BTK / 2]) {
      probabilities(n0, s);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
#pragma unroll
      for (int e = 0; e < BTK / 2; ++e) dl[(e >> 1) & 1] = fmaf(s[e], dp[e], dl[(e >> 1) & 1]);
    });
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dl[i] += __shfl_xor_sync(0xffffffffu, dl[i], 1);
      dl[i] += __shfl_xor_sync(0xffffffffu, dl[i], 2);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t off = q_head + static_cast<size_t>(row[i] < Sq ? row[i] : 0) * q_row;
      dl[i] = row_delta<bf16, DP>(dout + off, o32 + off, D, t, row[i] < Sq);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (row[i] < Sq && t == 0) delta[(static_cast<size_t>(b) * Hq + h) * Sq + row[i]] = dl[i];

  // c, the keys' centre: the mean of the band's keys, summed in fp32 from
  // the K tiles as they pass; this thread sums 8 columns (one 16-byte chunk
  // of a row) over every (NT / CPR)-th row
  constexpr int CPR = DP / 8, RSTEP = NT / CPR;
  static_assert(NT % CPR == 0, "whole chunks a thread");
  float cs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float acc[C::NSUB][C::NV / 2];
#pragma unroll
  for (int sb = 0; sb < C::NSUB; ++sb)
#pragma unroll
    for (int e = 0; e < C::NV / 2; ++e) acc[sb][e] = 0.f;
  float rs[2] = {0.f, 0.f};   // row sums of the rounded dS (hi + lo)
  auto key_sums = [&](int it) {
    const unsigned char* kt = smem + 2 * C::OWN + (it % NSTAGE) * 2 * C::RING_K;
#pragma unroll
    for (int u = 0; u < (BTK + RSTEP - 1) / RSTEP; ++u) {
      const int r = tid / CPR + u * RSTEP;
      if (BTK % RSTEP != 0 && r >= BTK) break;
      const uint4 v4 = *reinterpret_cast<const uint4*>(
          kt + sm90::chunk_offset<DP, BTK>(r, tid % CPR));
      const uint32_t w[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = sm90::unpack_bf16(w[e]);
        cs[2 * e] += f.x;
        cs[2 * e + 1] += f.y;
      }
    }
  };
  sweep(key_sums, [&](int, int n0, uint32_t k_addr, float (&s)[BTK / 2], float (&dp)[BTK / 2]) {
    probabilities(n0, s);
    // dS = P (dP - Delta) in dp, then as bf16 hi + lo, the A fragments of
    // k-step kk (keys 16 kk ..)
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
#pragma unroll
    for (int e = 0; e < BTK / 2; ++e) dp[e] = s[e] * (dp[e] - dl[(e >> 1) & 1]);
    uint32_t dh[BTK / 16][4], dlo[BTK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BTK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // registers 0, 2 hold row g; 1, 3 row g + 8
        const float x0 = dp[8 * kk + 2 * e], x1 = dp[8 * kk + 2 * e + 1];
        dh[kk][e] = sm90::pack_bf16(x0, x1);
        const float2 fh = sm90::unpack_bf16(dh[kk][e]);
        dlo[kk][e] = sm90::pack_bf16(x0 - fh.x, x1 - fh.y);
        const float2 fl = sm90::unpack_bf16(dlo[kk][e]);
        rs[e & 1] += (fh.x + fl.x) + (fh.y + fl.y);
      }
    // dQ += dS K (K the MN-major B operand), hi then lo
    sm90::wgmma_fence();
    sm90::rs_product<DP, BTK>(acc, dh, k_addr);
    sm90::rs_product<DP, BTK>(acc, dlo, k_addr);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int sb = 0; sb < C::NSUB; ++sb) sm90::fence_regs(acc[sb]);
  });
#pragma unroll
  for (int e = 0; e < 8; ++e) csum[(tid / CPR) * DP + (tid % CPR) * 8 + e] = cs[e];
  __syncthreads();
  if (!has_rows) return;

  const float inv_nc =
      1.f / static_cast<float>(max(1, min(Skv, kv_begin + n_tiles * BTK) - kv_begin));
  bf16* dqb = dq + q_head;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    if (row[i] >= Sq) continue;
    // dq = scale (dS K - c rs): the keys centred, for the rounded dS
#pragma unroll
    for (int sb = 0; sb < C::NSUB; ++sb)
#pragma unroll
      for (int j = 0; j < C::NV / 8; ++j) {
        const int col = sb * C::NV + 8 * j + 2 * t;
        float cc[2] = {0.f, 0.f};
#pragma unroll
        for (int p = 0; p < RSTEP; ++p) {
          cc[0] += csum[p * DP + col];
          cc[1] += csum[p * DP + col + 1];
        }
        const float x0 = scale * (acc[sb][4 * j + 2 * i] - cc[0] * inv_nc * rs[i]);
        const float x1 = scale * (acc[sb][4 * j + 2 * i + 1] - cc[1] * inv_nc * rs[i]);
        bf16* dst = dqb + static_cast<size_t>(row[i]) * q_row + col;
        if (VEC) {   // D % 8 == 0, aligned: the pair is whole and 4-byte aligned
          if (col < D) *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (col < D) dst[0] = __float2bfloat16(x0);
          if (col + 1 < D) dst[1] = __float2bfloat16(x1);
        }
      }
  }
}

// dK, dV for keys [n0, n0 + BO) of kv head blockIdx.x, batch row
// blockIdx.z; warpgroup w owns keys n0 + 64 w + [0, 64).
template <int DP, bool VEC>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv,
                  int D, float scale, int causal, int window) {
  using C = Cfg<DP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint32_t base;
  unsigned char* smem = aligned_smem(smem_raw, base);
  float* lse_s = reinterpret_cast<float*>(smem + C::DKDV_TILES);   // [NSTAGE][BTQ]
  float* dl_s = lse_s + NSTAGE * BTQ;                          // [NSTAGE][BTQ]

  const int tid = threadIdx.x, wgi = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
  const int g = lane / 4, t = lane % 4;
  // blocks start in launch order, x fastest: every kv head's first key
  // block (seen by the most queries under a causal mask) first
  const int hk = blockIdx.x, n0 = blockIdx.y * BO, b = blockIdx.z;
  const int group = Hq / Hkv;
  const size_t q_row = static_cast<size_t>(Hq) * D, kv_row = static_cast<size_t>(Hkv) * D;
  const size_t kv_head = static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(hk) * D;

  // the query tiles that can see a key of this block, for each query head
  const int q_end = window > 0 ? min(Sq, n0 + BO - 1 + window) : Sq;
  const int q_begin = causal ? min(n0, q_end) / BTQ * BTQ : 0;
  const int n_qt = q_end > q_begin ? (q_end - q_begin + BTQ - 1) / BTQ : 0;
  const int n_tiles = group * n_qt;

  // Q/dO tile `it` (query head hk * group + it / n_qt) with its lse and
  // Delta goes to stage it % NSTAGE; one cp.async group per tile
  auto load_q = [&](int it) {
    if (it < n_tiles) {
      const int h = hk * group + it / n_qt, i0 = q_begin + (it % n_qt) * BTQ, st = it % NSTAGE;
      const size_t q_head = static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * D;
      unsigned char* qs = smem + 2 * C::OWN + st * 2 * C::RING_Q;
      sm90::load_tile<DP, BTQ, VEC, NT>(qs, q + q_head, q_row, i0, Sq, D, tid);
      sm90::load_tile<DP, BTQ, VEC, NT>(qs + C::RING_Q, dout + q_head, q_row, i0, Sq, D, tid);
      if (tid < BTQ) {
        const bool ok = i0 + tid < Sq;
        const size_t ro = (static_cast<size_t>(b) * Hq + h) * Sq + (ok ? i0 + tid : 0);
        rt::cp_async4(lse_s + st * BTQ + tid, lse + ro, ok ? 4 : 0);
        rt::cp_async4(dl_s + st * BTQ + tid, delta + ro, ok ? 4 : 0);
      }
    }
    rt::cp_async_commit();
  };
  sm90::load_tile<DP, BO, VEC, NT>(smem, k + kv_head, kv_row, n0, Skv, D, tid);
  sm90::load_tile<DP, BO, VEC, NT>(smem + C::OWN, v + kv_head, kv_row, n0, Skv, D, tid);
#pragma unroll
  for (int it = 0; it < NSTAGE - 1; ++it) load_q(it);

  // this warpgroup's keys, and this thread's two
  const int key_lo = n0 + 64 * wgi, key_hi = min(key_lo + 63, Skv - 1);
  const bool has_keys = key_lo < Skv;
  const int key[2] = {key_lo + 16 * warp + g, key_lo + 16 * warp + g + 8};
  const float sl2 = scale * rt::kLog2e;

  float dk_acc[C::NSUB][C::NV / 2], dv_acc[C::NSUB][C::NV / 2];
#pragma unroll
  for (int sb = 0; sb < C::NSUB; ++sb)
#pragma unroll
    for (int e = 0; e < C::NV / 2; ++e) {
      dk_acc[sb][e] = 0.f;
      dv_acc[sb][e] = 0.f;
    }
  const uint32_t k_addr = base + 64 * wgi * C::RB, v_addr = k_addr + C::OWN;
  for (int it = 0; it < n_tiles; ++it) {
    rt::cp_async_wait<NSTAGE - 2>();
    sm90::fence_async_shared();
    __syncthreads();   // tile `it` (and K, V) landed; tile it - 1's stage is free
    load_q(it + NSTAGE - 1);
    const int i0 = q_begin + (it % n_qt) * BTQ;
    // skip a tile no query of which sees a key of this warpgroup
    if (!has_keys || (causal && i0 + BTQ - 1 < key_lo) || (window > 0 && i0 - key_hi >= window))
      continue;
    const int st = it % NSTAGE;
    const uint32_t q_addr = base + 2 * C::OWN + st * 2 * C::RING_Q, do_addr = q_addr + C::RING_Q;
    const float* lse_t = lse_s + st * BTQ;
    const float* dl_t = dl_s + st * BTQ;

    // S^T = K Q^T, dP^T = V dO^T: 64 keys x BTQ queries each, fp32
    float s[BTQ / 2], dp[BTQ / 2];
    sm90::wgmma_fence();
    sm90::ss_product<DP, BO, BTQ>(s, k_addr, q_addr);
    sm90::wgmma_commit();
    sm90::ss_product<DP, BO, BTQ>(dp, v_addr, do_addr);
    sm90::wgmma_commit();
    sm90::wgmma_wait<kOverlap ? 1 : 0>();
    sm90::fence_regs(s);

    // P^T in s (a column is a query), then in bf16 as the A fragments of
    // k-step kk (queries 16 kk ..); dV += P^T dO (dO the MN-major B operand)
    const bool need_mask = i0 + BTQ > Sq || key_lo + 63 >= Skv || (causal && i0 < key_lo + 63) ||
                           (window > 0 && i0 + BTQ - 1 - key_lo >= window);
#pragma unroll
    for (int j = 0; j < BTQ / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * t + c;
        const float l2 = lse_t[col] * rt::kLog2e;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = s[4 * j + 2 * i + c];
          x = sm90::fast_exp2(fmaf(x, sl2, -l2));
          if (need_mask) x = visible(i0 + col, key[i], Sq, Skv, causal, window) ? x : 0.f;
        }
      }
    uint32_t pa[BTQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BTQ / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = sm90::pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    sm90::wgmma_fence();
    sm90::rs_product<DP, BTQ>(dv_acc, pa, do_addr);
    sm90::wgmma_commit();

    // dS^T = P^T (dP^T - Delta) as bf16 hi + lo; dK += dS^T Q
    sm90::wgmma_wait<kOverlap ? 1 : 0>();
    sm90::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < BTQ / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float dlt = dl_t[8 * j + 2 * t + c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * j + 2 * i + c;
          dp[e] = s[e] * (dp[e] - dlt);
        }
      }
    uint32_t dh[BTQ / 16][4], dlo[BTQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BTQ / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x0 = dp[8 * kk + 2 * e], x1 = dp[8 * kk + 2 * e + 1];
        dh[kk][e] = sm90::pack_bf16(x0, x1);
        const float2 fh = sm90::unpack_bf16(dh[kk][e]);
        dlo[kk][e] = sm90::pack_bf16(x0 - fh.x, x1 - fh.y);
      }
    sm90::wgmma_fence();
    sm90::rs_product<DP, BTQ>(dk_acc, dh, q_addr);
    sm90::rs_product<DP, BTQ>(dk_acc, dlo, q_addr);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int sb = 0; sb < C::NSUB; ++sb) {
      sm90::fence_regs(dv_acc[sb]);
      sm90::fence_regs(dk_acc[sb]);
    }
  }
  rt::cp_async_wait<0>();   // no copy outlives the block
  if (!has_keys) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Skv) continue;
    bf16* dkr = dk + kv_head + static_cast<size_t>(key[i]) * kv_row;
    bf16* dvr = dv + kv_head + static_cast<size_t>(key[i]) * kv_row;
#pragma unroll
    for (int sb = 0; sb < C::NSUB; ++sb)
#pragma unroll
      for (int j = 0; j < C::NV / 8; ++j) {
        const int col = sb * C::NV + 8 * j + 2 * t;
        const float k0 = dk_acc[sb][4 * j + 2 * i] * scale;
        const float k1 = dk_acc[sb][4 * j + 2 * i + 1] * scale;
        const float v0 = dv_acc[sb][4 * j + 2 * i], v1 = dv_acc[sb][4 * j + 2 * i + 1];
        if (VEC) {   // D % 8 == 0, aligned: the pair is whole and 4-byte aligned
          if (col < D) {
            *reinterpret_cast<__nv_bfloat162*>(dkr + col) = __floats2bfloat162_rn(k0, k1);
            *reinterpret_cast<__nv_bfloat162*>(dvr + col) = __floats2bfloat162_rn(v0, v1);
          }
        } else {
          if (col < D) {
            dkr[col] = __float2bfloat16(k0);
            dvr[col] = __float2bfloat16(v0);
          }
          if (col + 1 < D) {
            dkr[col + 1] = __float2bfloat16(k1);
            dvr[col + 1] = __float2bfloat16(v1);
          }
        }
      }
  }
}

template <int DP, bool VEC>
cudaError_t launch_tile(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                        const float* lse, const float* o32, float* delta, bf16* dq, bf16* dk,
                        bf16* dv, int B, int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                        int causal, int window, cudaStream_t stream) {
  using C = Cfg<DP>;
  static std::atomic<unsigned> set_q{0}, set_kv{0};
  cudaError_t err = rt::smem_limit_once(flash_bwd_dq_tc<DP, VEC>, C::DQ_SMEM, set_q);
  if (err != cudaSuccess) return err;
  err = rt::smem_limit_once(flash_bwd_dkdv_tc<DP, VEC>, C::DKDV_SMEM, set_kv);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tc<DP, VEC><<<dim3(Hq, (Sq + BO - 1) / BO, B), NT, C::DQ_SMEM, stream>>>(
      q, k, v, dout, lse, o32, delta, dq, Sq, Skv, Hq, Hkv, D, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_tc<DP, VEC><<<dim3(Hkv, (Skv + BO - 1) / BO, B), NT, C::DKDV_SMEM, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Skv, Hq, Hkv, D, scale, causal, window);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dp(bool vec, const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                      const float* lse, const float* o32, float* delta, bf16* dq, bf16* dk,
                      bf16* dv, int B, int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                      int causal, int window, cudaStream_t stream) {
  return vec ? launch_tile<DP, true>(q, k, v, dout, lse, o32, delta, dq, dk, dv, B, Sq, Skv, Hq,
                                     Hkv, D, scale, causal, window, stream)
             : launch_tile<DP, false>(q, k, v, dout, lse, o32, delta, dq, dk, dv, B, Sq, Skv, Hq,
                                      Hkv, D, scale, causal, window, stream);
}

int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
           const float* o32, float* delta, bf16* dq, bf16* dk, bf16* dv, int B, int Sq, int Skv,
           int Hq, int Hkv, int D, float scale, int causal, int window, cudaStream_t stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                         reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
                         reinterpret_cast<uintptr_t>(dv);
  const bool vec = D % 8 == 0 && ptrs % 16 == 0;
  if (D <= 16)
    return launch_dp<16>(vec, q, k, v, dout, lse, o32, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv, D,
                         scale, causal, window, stream);
  if (D <= 32)
    return launch_dp<32>(vec, q, k, v, dout, lse, o32, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv, D,
                         scale, causal, window, stream);
  if (D <= 64)
    return launch_dp<64>(vec, q, k, v, dout, lse, o32, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv, D,
                         scale, causal, window, stream);
  return launch_dp<128>(vec, q, k, v, dout, lse, o32, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv, D,
                        scale, causal, window, stream);
}

}  // namespace tc

bool shape_ok(int D, int Hq, int Hkv) {
  return D >= 1 && D <= kMaxHeadDim && Hkv >= 1 && Hq % Hkv == 0;
}

}  // namespace

// o32: the forward's fp32 output (B,Sq,Hq,D) (flash_attention.cu's LSE
// variant); delta: (B,Hq,Sq) fp32 scratch (Delta, from the dQ kernel to the
// dK/dV one)
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* o32,
                                        float* delta, void* dq, void* dk, void* dv, int B,
                                        int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                                        int causal, int window, void* stream) {
  using bf16 = __nv_bfloat16;
  if (!shape_ok(D, Hq, Hkv)) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Skv == 0) return cudaSuccess;
  return tc::launch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, o32, delta,
                    static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Sq,
                    Skv, Hq, Hkv, D, scale, causal, window, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* o32,
                                       float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                                       int Skv, int Hq, int Hkv, int D, float scale, int causal,
                                       int window, void* stream) {
  if (!shape_ok(D, Hq, Hkv)) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Skv == 0) return cudaSuccess;
  return f32::launch(static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<const float*>(dout), lse, o32,
                     delta, static_cast<float*>(dq), static_cast<float*>(dk),
                     static_cast<float*>(dv), B, Sq, Skv, Hq, Hkv, D, scale, causal, window,
                     static_cast<cudaStream_t>(stream));
}

RT_EXPORT_ERROR_STRING(flash_attention_bwd)
