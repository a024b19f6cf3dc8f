// Blocked causal / windowed GQA attention forward (prefill) for Hopper.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:flash_attention
// (_flash_kernel, pallas_call at :85).  Same function: fp32 online softmax,
// kv head = q head / group, causal mask offset by q_offset, sliding window
// kpos > qpos - window, keys at or past kv_len masked, finite -1e30 masks.
//
// Layout: q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D), o like q; contiguous, bf16 or
// fp32; D <= 320 (gemma3's 2560 / 8).
//
// On the TPU the kv axis was the innermost, sequential grid axis and the
// accumulators lived in VMEM scratch across grid steps.  Here blocks run in
// parallel and in no order, so one block owns a (query rows, one q head, one
// batch row) tile for its whole life and loops over K/V tiles itself,
// keeping acc/m/l in registers.  Causal and window masks also skip whole
// K/V tiles outside the band.
//
// Bound: at the serving shapes (S up to a few thousand, D 128) attention
// does ~4*S*S*D*H/2 flops on ~4*S*H*D bytes, far above the card's ridge,
// so the bound is operations.  Two kernels:
//
// * bf16 (flash_fwd_tc): both products on the tensor cores with wgmma.  A
//   block of 256 threads owns 128 query rows: two consumer warpgroups of 64
//   rows each share the K/V tiles.  Q and a ring of two stages of 64-key K
//   and V tiles sit in shared memory in the swizzled layout the wgmma
//   descriptors read (wgmma.cuh, which flash_attention_bwd.cu shares: rows
//   cut into 128-byte, or for D 16 / 32, 32- and 64-byte swizzle atoms),
//   filled with 16-byte cp.async so tile i+1 loads
//   while tile i is multiplied.  S = Q K^T reads both operands from shared
//   memory (K-major); the fp32 scores stay in registers, are scaled in fp32
//   (scale * log2 e, exp2), masked and folded into the running max and sum;
//   P is rounded to bf16 in registers and fed as the register A operand of
//   O += P V, V read from shared memory as the transposed (MN-major) B
//   operand.  Accumulators, max and sum stay fp32.  Head dims take a
//   compile-time tile of 16, 32, 64, 128 or 320 columns; any other D is
//   zero-padded in shared memory up to the next (zero columns add nothing to
//   Q K^T).  The 320-column tile (five 128-byte swizzle atoms a row) takes
//   32-key K/V tiles where the narrower ones take 64: with 64 keys its Q
//   (80 KB for 128 rows) and two stages of K and V (160 KB) would pass the
//   227 KB a block may use, and a thread of a consumer warpgroup would hold
//   160 fp32 O registers plus 32 of scores and 16 of P, past the 255 cap.
//   With 32 keys K/V take 80 KB (164,864 bytes in all) and the scores 16
//   registers, P 8: 184 for the three.  Both warpgroups and the 128 query
//   rows a block stay, so each K/V tile still serves 128 rows.  Where D is
//   not a whole number of 16-byte vectors or a pointer is not 16-byte
//   aligned, the tiles are staged with plain loads (and the output written
//   in 2-byte stores, not bf16 pairs) instead.  Blocks start
//   longest first: under a causal mask a head's last query block sees the
//   most keys, and launching every head's last block before any shorter
//   one balances the SMs (20-26 % at S 1000-2048 on the H100).
// * fp32 (flash_fwd): the exact CUDA-core kernel (TF32 tensor cores would
//   round the inputs to 10 bits).  256 threads as a 16x16 grid own 64 query
//   rows: thread (tx,ty) owns query rows ty+16i (i<4), score columns tx+16c
//   (c < BK/16) and output columns tx+16c (c < DMAX/16).  Q (pre-scaled) and
//   K are staged d-major in shared memory with a padded stride, so the
//   row/column reads of the inner product are conflict-free; P goes through
//   shared memory once per tile for the P.V product.  Two instantiations:
//   D <= 128 with 64-key tiles (115,968 bytes), and D <= 320 with 32-key
//   tiles (174,720 bytes; 64 keys would need 264,960).
//
// Training: both kernels take a compile-time flag LSE.  With it they also
// write each row's fp32 log-sum-exp of the scaled scores, lse (B,Hq,Sq) =
// m + log(l) (natural log), which flash_attention_bwd.cu recomputes the
// probabilities from.  The bf16 kernel with LSE also writes O32 (B,Sq,Hq,D)
// fp32: the output before its bf16 rounding,
// normalised by the sum of the bf16-rounded P that entered P V rather than
// by l.  Its rows are an exact softmax average (weights summing to one) of
// the rows of V, so the backward's Delta = rowsum(dO o O32) carries only
// the rounding of P's relative weights, not of their total (the backward's
// header gives the numbers).  Without LSE (the serving entry points) the
// code is the same as before the flag existed, and with it the bf16 output
// is the same bits: the flag only adds the stores and the second sum.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxHeadDim = 320;  // the wrapper's MAX_HEAD_DIM

namespace f32 {

constexpr int BQ = 64;          // query rows per block
constexpr int NT = 256;         // threads per block (16 x 16)
constexpr int RPT = BQ / 16;    // query rows per thread
constexpr int QS = BQ + 1;      // padded strides (odd: no bank conflicts)

// DM: the largest head dim the block's buffers hold; BK_: keys per tile
template <int DM, int BK_> struct Tile {
  static constexpr int DMAX = DM;
  static constexpr int BK = BK_;
  static constexpr int CPT = BK / 16;    // score columns per thread
  static constexpr int DPT = DMAX / 16;  // output columns per thread
  static constexpr int KS = BK + 1;      // padded stride (odd)
  static constexpr size_t kSmemBytes =
      sizeof(float) * (DMAX * QS + DMAX * KS + BK * DMAX + BK * QS);
};

template <typename T, int DM, int BK_, bool LSE>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv, int D,
          float scale, int causal, int window, int q_offset, int kv_len) {
  using L = Tile<DM, BK_>;
  constexpr int DMAX = L::DMAX, BK = L::BK, CPT = L::CPT, DPT = L::DPT, KS = L::KS;
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
    if constexpr (LSE) {
      if (tx == 0)
        lse[(static_cast<size_t>(b) * Hq + h) * Sq + r] = m[i] + logf(fmaxf(l[i], 1e-30f));
    }
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = tx + 16 * c;
      if (d < D) ob[r * q_row + d] = rt::from_f<T>(acc[i][c] * inv);
    }
  }
}

template <typename T, int DM, int BK_, bool LSE>
cudaError_t launch_tile(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int Sq, int Skv, int Hq, int Hkv, int D, float scale, int causal,
                        int window, int q_offset, int kv_len, void* stream) {
  constexpr size_t smem = Tile<DM, BK_>::kSmemBytes;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err =
      rt::smem_limit_once(flash_fwd<T, DM, BK_, LSE>, static_cast<int>(smem), smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd<T, DM, BK_, LSE><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Skv, Hq, Hkv, D, scale, causal, window, q_offset, kv_len);
  return cudaGetLastError();
}

// LSE: the training variant, head dims up to 128 (the backward's range)
template <typename T, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
           int Skv, int Hq, int Hkv, int D, float scale, int causal, int window, int q_offset,
           int kv_len, void* stream) {
  if (D < 1 || D > (LSE ? 128 : kMaxHeadDim) || Hkv < 1 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  if constexpr (LSE) {
    return launch_tile<T, 128, 64, true>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D, scale, causal,
                                         window, q_offset, kv_len, stream);
  } else {
    return D <= 128 ? launch_tile<T, 128, 64, false>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D,
                                                     scale, causal, window, q_offset, kv_len,
                                                     stream)
                    : launch_tile<T, 320, 32, false>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D,
                                                     scale, causal, window, q_offset, kv_len,
                                                     stream);
  }
}

}  // namespace f32

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int NWG = 2;           // consumer warpgroups per block, 64 query rows each
constexpr int BQ = 64 * NWG;     // query rows per block
constexpr int NT = 128 * NWG;    // threads per block
constexpr int NSTAGE = 2;        // K/V ring: tile i+1 loads while tile i is used

// Per padded head dim DP (16, 32, 64, 128 or 320): the swizzled tile layout
// of wgmma.cuh; BK keys a K/V tile: 64, or 32 at DP 320 (the header says
// why).
template <int DP> struct Cfg : sm90::Layout<DP> {
  static constexpr int BK = DP > 128 ? 32 : 64;
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;
  static constexpr int SMEM = Q_BYTES + NSTAGE * 2 * KV_BYTES + 1024;  // + alignment slack
  static_assert(SMEM <= 232448, "a block may use at most 227 KB of shared memory");
};

using sm90::fast_exp2;
using sm90::fence_async_shared;
using sm90::fence_regs;
using sm90::pack_bf16;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait_all;

template <int DP, int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(unsigned char* tile, const bf16* src, size_t row_stride,
                                          int r0, int n_rows, int D, int tid) {
  sm90::load_tile<DP, ROWS, VEC, NT>(tile, src, row_stride, r0, n_rows, D, tid);
}

// Issue S = Q K^T for one warpgroup (64 rows x BK keys, fp32) as one wgmma
// group, not waited for.  q_addr: the warpgroup's first Q row; k_addr: the
// K tile.
template <int DP>
__device__ __forceinline__ void issue_scores(float (&sc)[Cfg<DP>::BK / 2], uint32_t q_addr,
                                             uint32_t k_addr) {
  wgmma_fence();
  sm90::ss_product<DP, BQ, Cfg<DP>::BK>(sc, q_addr, k_addr);
  wgmma_commit();
}

// One block: query rows [q0, q0 + BQ) of q head blockIdx.x, batch row
// blockIdx.z; warpgroup wg owns rows q0 + 64 wg + [0, 64).  Accumulator
// layout (per warpgroup, as mma.sync's per warp): warp w, lane (g = lane/4,
// t = lane%4) holds rows 16w + g + 8i and columns 8j + 2t + c in register
// 4j + 2i + c.
template <int DP, bool VEC, bool LSE>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             bf16* __restrict__ o, float* __restrict__ lse, float* __restrict__ o32, int Sq,
             int Skv, int Hq, int Hkv, int D, float scale, int causal, int window, int q_offset,
             int kv_len) {
  using C = Cfg<DP>;
  constexpr int BK = C::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle acts on shared-memory address bits: align the tiles to 1024
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t shift = (1024 - (raw & 1023)) & 1023;
  unsigned char* smem = smem_raw + shift;
  const uint32_t q_addr = raw + shift;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
  // blocks start in launch order, x fastest: every head's last (longest,
  // under a causal mask) query block first, then the next longest
  const int h = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * BQ, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_row = static_cast<size_t>(Hq) * D;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;
  const bf16* qb = q + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * D;
  const bf16* kb = k + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(hk) * D;
  const bf16* vb = v + static_cast<size_t>(b) * Skv * kv_row + static_cast<size_t>(hk) * D;
  bf16* ob = o + static_cast<size_t>(b) * Sq * q_row + static_cast<size_t>(h) * D;

  // the band of keys any row of this block can see, in whole tiles
  const int n_valid = min(Skv, kv_len);
  int kv_end = n_valid;
  if (causal) kv_end = min(kv_end, q_offset + min(q0 + BQ, Sq));
  const int kv_begin = window > 0 ? max(0, q_offset + q0 - window + 1) / BK * BK : 0;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK : 0;

  // K/V tile `it` goes to stage it % NSTAGE, NSTAGE - 1 tiles ahead of use;
  // one cp.async group per tile (empty past the end, so the count of
  // groups in flight stays NSTAGE - 1)
  auto load_kv = [&](int it) {
    if (it < n_tiles) {
      unsigned char* ks = smem + C::Q_BYTES + (it % NSTAGE) * 2 * C::KV_BYTES;
      load_tile<DP, BK, VEC>(ks, kb, kv_row, kv_begin + it * BK, n_valid, D, tid);
      load_tile<DP, BK, VEC>(ks + C::KV_BYTES, vb, kv_row, kv_begin + it * BK, n_valid, D, tid);
    }
    if constexpr (VEC) rt::cp_async_commit();
  };
  load_tile<DP, BQ, VEC>(smem, qb, q_row, q0, Sq, D, tid);
#pragma unroll
  for (int it = 0; it < NSTAGE - 1; ++it) load_kv(it);

  // this warpgroup's rows: positions lo..hi, and this thread's two rows
  const int wr0 = q0 + 64 * wg;
  const bool has_rows = wr0 < Sq;
  const int lo = q_offset + wr0, hi = q_offset + min(wr0 + 63, Sq - 1);
  const int g = lane / 4, t = lane % 4;
  const int qpos[2] = {lo + 16 * warp + g, lo + 16 * warp + g + 8};
  const float sl2 = scale * rt::kLog2e;

  float acc[C::NSUB][C::NV / 2];
#pragma unroll
  for (int s = 0; s < C::NSUB; ++s)
#pragma unroll
    for (int i = 0; i < C::NV / 2; ++i) acc[s][i] = 0.f;
  float m[2] = {rt::kNegInf, rt::kNegInf}, l[2] = {0.f, 0.f};
  float lr[2] = {0.f, 0.f};   // LSE: the sum of the bf16-rounded P, O32's normaliser

  const uint32_t qw_addr = q_addr + 64 * wg * C::RB;   // this warpgroup's Q rows
  for (int it = 0; it < n_tiles; ++it) {
    if constexpr (VEC) rt::cp_async_wait<NSTAGE - 2>();
    fence_async_shared();
    __syncthreads();   // tile `it` (and Q) landed; tile it - 1's stage is free
    load_kv(it + NSTAGE - 1);
    const int n0 = kv_begin + it * BK;
    // skip a tile none of this warpgroup's rows can see
    if (!has_rows || (causal && n0 > hi) || (window > 0 && n0 + BK - 1 <= lo - window)) continue;
    const uint32_t k_addr = q_addr + C::Q_BYTES + (it % NSTAGE) * 2 * C::KV_BYTES;
    const uint32_t v_addr = k_addr + C::KV_BYTES;

    float s[BK / 2];   // S = Q K^T: 64 rows x BK keys, fp32
    issue_scores<DP>(s, qw_addr, k_addr);
    wgmma_wait_all();
    fence_regs(s);

    // scale in fp32 (log2 domain), mask, online softmax
    const bool need_mask = n0 + BK > n_valid || (causal && n0 + BK - 1 > lo) ||
                           (window > 0 && n0 <= hi - window);
    float mx[2] = {rt::kNegInf, rt::kNegInf};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[4 * j + 2 * i + c];
          x *= sl2;
          if (need_mask) {
            const int kpos = n0 + 8 * j + 2 * t + c;
            const bool ok = kpos < n_valid && (!causal || kpos <= qpos[i]) &&
                            (window <= 0 || kpos > qpos[i] - window);
            x = ok ? x : rt::kNegInf;
          }
          mx[i] = fmaxf(mx[i], x);
        }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // the four threads of a quad share a row
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = fast_exp2(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[4 * j + 2 * i + c];
          x = fast_exp2(x - m[i]);
          rsum[i] += x;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rsum[i];
    if constexpr (LSE) {
#pragma unroll
      for (int i = 0; i < 2; ++i) lr[i] *= alpha[i];
    }
#pragma unroll
    for (int sb = 0; sb < C::NSUB; ++sb)
#pragma unroll
      for (int j = 0; j < C::NV / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[sb][4 * j + 2 * i] *= alpha[i];
          acc[sb][4 * j + 2 * i + 1] *= alpha[i];
        }
    // P (bf16) as the A fragments of k-step kk: keys 16 kk .. 16 kk + 15
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const float* p = s + 8 * kk;
      pa[kk][0] = pack_bf16(p[0], p[1]);
      pa[kk][1] = pack_bf16(p[2], p[3]);
      pa[kk][2] = pack_bf16(p[4], p[5]);
      pa[kk][3] = pack_bf16(p[6], p[7]);
      if constexpr (LSE) {   // registers 0, 2 hold row g; 1, 3 row g + 8
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = sm90::unpack_bf16(pa[kk][e]);
          lr[e & 1] += f.x + f.y;
        }
      }
    }

    // O += P V (V the MN-major B operand)
    wgmma_fence();
    sm90::rs_product<DP, BK>(acc, pa, v_addr);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int sb = 0; sb < C::NSUB; ++sb) fence_regs(acc[sb]);
  }
  if constexpr (VEC) rt::cp_async_wait<0>();   // no copy outlives the block
  if (!has_rows) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if constexpr (LSE) {
      lr[i] += __shfl_xor_sync(0xffffffffu, lr[i], 1);
      lr[i] += __shfl_xor_sync(0xffffffffu, lr[i], 2);
    }
    const int r = wr0 + 16 * warp + g + 8 * i;
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if constexpr (LSE) {   // m is in the log2 domain
      if (t == 0)
        lse[(static_cast<size_t>(b) * Hq + h) * Sq + r] =
            (m[i] + log2f(fmaxf(l[i], 1e-30f))) * 0.6931471805599453f;
    }
#pragma unroll
    for (int sb = 0; sb < C::NSUB; ++sb)
#pragma unroll
      for (int j = 0; j < C::NV / 8; ++j) {
        const int col = sb * C::NV + 8 * j + 2 * t;
        const float x0 = acc[sb][4 * j + 2 * i] * inv, x1 = acc[sb][4 * j + 2 * i + 1] * inv;
        bf16* dst = ob + r * q_row + col;
        if (VEC) {   // D % 8 == 0, aligned: the pair is whole and 4-byte aligned
          if (col < D) *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (col < D) dst[0] = __float2bfloat16(x0);
          if (col + 1 < D) dst[1] = __float2bfloat16(x1);
        }
      }
    if constexpr (LSE) {   // O32: the same sums over the rounded P's own total
      const float inv_r = 1.f / fmaxf(lr[i], 1e-30f);
      float* o32r = o32 + (static_cast<size_t>(b) * Sq + r) * q_row + static_cast<size_t>(h) * D;
#pragma unroll
      for (int sb = 0; sb < C::NSUB; ++sb)
#pragma unroll
        for (int j = 0; j < C::NV / 8; ++j) {
          const int col = sb * C::NV + 8 * j + 2 * t;
          const float x0 = acc[sb][4 * j + 2 * i] * inv_r;
          const float x1 = acc[sb][4 * j + 2 * i + 1] * inv_r;
          if (VEC) {   // D % 8 == 0: the pair is whole and 8-byte aligned
            if (col < D) *reinterpret_cast<float2*>(o32r + col) = make_float2(x0, x1);
          } else {
            if (col < D) o32r[col] = x0;
            if (col + 1 < D) o32r[col + 1] = x1;
          }
        }
    }
  }
}

template <int DP, bool VEC, bool LSE>
cudaError_t launch_tile(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                        float* o32, int B, int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                        int causal, int window, int q_offset, int kv_len, cudaStream_t stream) {
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = rt::smem_limit_once(flash_fwd_tc<DP, VEC, LSE>, Cfg<DP>::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, (Sq + BQ - 1) / BQ, B);
  flash_fwd_tc<DP, VEC, LSE><<<grid, NT, Cfg<DP>::SMEM, stream>>>(
      q, k, v, o, lse, o32, Sq, Skv, Hq, Hkv, D, scale, causal, window, q_offset, kv_len);
  return cudaGetLastError();
}

template <int DP, bool LSE>
cudaError_t launch_dp(bool vec, const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                      float* o32, int B, int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                      int causal, int window, int q_offset, int kv_len, cudaStream_t stream) {
  return vec ? launch_tile<DP, true, LSE>(q, k, v, o, lse, o32, B, Sq, Skv, Hq, Hkv, D, scale,
                                          causal, window, q_offset, kv_len, stream)
             : launch_tile<DP, false, LSE>(q, k, v, o, lse, o32, B, Sq, Skv, Hq, Hkv, D, scale,
                                           causal, window, q_offset, kv_len, stream);
}

// LSE: the training variant, head dims up to 128 (the backward's range)
template <bool LSE>
int launch(const void* q_, const void* k_, const void* v_, void* o_, float* lse, float* o32,
           int B, int Sq, int Skv, int Hq, int Hkv, int D, float scale, int causal, int window,
           int q_offset, int kv_len, void* stream_) {
  if (D < 1 || D > (LSE ? 128 : kMaxHeadDim) || Hkv < 1 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  const auto q = static_cast<const bf16*>(q_);
  const auto k = static_cast<const bf16*>(k_);
  const auto v = static_cast<const bf16*>(v_);
  const auto o = static_cast<bf16*>(o_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q_) | reinterpret_cast<uintptr_t>(k_) |
                         reinterpret_cast<uintptr_t>(v_) | reinterpret_cast<uintptr_t>(o_);
  const bool vec = D % 8 == 0 && ptrs % 16 == 0;
  if (D <= 16)
    return launch_dp<16, LSE>(vec, q, k, v, o, lse, o32, B, Sq, Skv, Hq, Hkv, D, scale, causal,
                              window, q_offset, kv_len, stream);
  if (D <= 32)
    return launch_dp<32, LSE>(vec, q, k, v, o, lse, o32, B, Sq, Skv, Hq, Hkv, D, scale, causal,
                              window, q_offset, kv_len, stream);
  if (D <= 64)
    return launch_dp<64, LSE>(vec, q, k, v, o, lse, o32, B, Sq, Skv, Hq, Hkv, D, scale, causal,
                              window, q_offset, kv_len, stream);
  if constexpr (LSE) {
    return launch_dp<128, true>(vec, q, k, v, o, lse, o32, B, Sq, Skv, Hq, Hkv, D, scale, causal,
                                window, q_offset, kv_len, stream);
  } else {
    if (D <= 128)
      return launch_dp<128, false>(vec, q, k, v, o, lse, o32, B, Sq, Skv, Hq, Hkv, D, scale, causal,
                                   window, q_offset, kv_len, stream);
    return launch_dp<320, false>(vec, q, k, v, o, lse, o32, B, Sq, Skv, Hq, Hkv, D, scale, causal,
                                 window, q_offset, kv_len, stream);
  }
}

}  // namespace tc
}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                    int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                                    int causal, int window, int q_offset, int kv_len,
                                    void* stream) {
  return tc::launch<false>(q, k, v, o, nullptr, nullptr, B, Sq, Skv, Hq, Hkv, D, scale, causal,
                           window, q_offset, kv_len, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B,
                                   int Sq, int Skv, int Hq, int Hkv, int D, float scale,
                                   int causal, int window, int q_offset, int kv_len,
                                   void* stream) {
  return f32::launch<float, false>(q, k, v, o, nullptr, B, Sq, Skv, Hq, Hkv, D, scale, causal,
                                   window, q_offset, kv_len, stream);
}

// The training forward: also the rows' log-sum-exp (B,Hq,Sq) fp32 and the
// fp32 output before its bf16 rounding (B,Sq,Hq,D), normalised by the sum of
// the rounded P (the header says why); q_offset 0, every key valid, D <= 128.
extern "C" int flash_attention_lse_bf16(const void* q, const void* k, const void* v, void* o,
                                        float* lse, float* o32, int B, int Sq, int Skv, int Hq,
                                        int Hkv, int D, float scale, int causal, int window,
                                        void* stream) {
  return tc::launch<true>(q, k, v, o, lse, o32, B, Sq, Skv, Hq, Hkv, D, scale, causal, window, 0,
                          Skv, stream);
}

extern "C" int flash_attention_lse_f32(const void* q, const void* k, const void* v, void* o,
                                       float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                       float scale, int causal, int window, void* stream) {
  return f32::launch<float, true>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D, scale, causal, window,
                                  0, Skv, stream);
}

RT_EXPORT_ERROR_STRING(flash_attention)
