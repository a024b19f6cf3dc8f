// Single-token GQA decode attention over a padded KV cache, for Hopper.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py:decode_attention
// (_decode_kernel, pallas_call at :86).  Same function: one query token per
// batch row attends to cache rows [0, cache_len[b]) with an fp32 softmax;
// the whole GQA group of query heads shares each K/V tile.
//
// Layout: q (B,Hq,D), k/v caches (B,S,Hkv,D), cache_len (B,) int32, o like
// q; bf16 or fp32; D <= 320, group = Hq/Hkv <= 16.  q, o and lengths are
// contiguous; a cache row (one position of one batch row) holds Hs >= Hkv
// heads of D contiguous elements, of which the kernel reads the Hkv from
// its pointer on, and the batch rows are S such rows apart: Hs = Hkv for a
// contiguous cache, more for a range of a larger cache's heads (a
// tensor-parallel rank's kv heads, read in place).  A row needs
// cache_len >= 1 (decode writes its own token before it attends); lengths
// above S are clamped to S, and a row of length 0 gets zeros.
//
// Bound: bytes.  The kernel must read every valid cache row once (2 x len x
// D x 2 bytes per kv head in bf16) and does ~1 flop per byte, far below the
// card's ridge.  So the design fills the card and streams the cache:
//
// * Split-K over the cache ("flash-decoding").  The grid is (n_split, Hkv,
//   B) with n_split = ceil(S / kc), kc = 512 keys: a block owns one split of
//   one row and one kv head, and a block whose split starts at or past its
//   row's length returns at once.  Row lengths stay on the card (no
//   device-to-host read per layer).  With one split (S <= kc, the serving
//   caches) the block writes the output itself: one launch.  Otherwise it
//   writes the split's softmax state (max m, sum l, unnormalised acc[D]) of
//   each query of its group, and decode_fwd_combine merges a row's splits
//   below ceil(len / kc) by log-sum-exp.
// * Two passes over the split, each spread over the block's eight warps.
//   Pass 1 streams the K tiles (16 keys a warp tile, tiles w, w + 8, ... to
//   warp w) and keeps every score of the split in shared memory (G x kc
//   floats); the warps then take the softmax row by row: the max,
//   the sum and the probabilities.  Pass 2 streams the V tiles for P.V.
//   Each cache row is still read once, and the warps never wait for each
//   other inside a pass.  Knowing the row's max and sum before P.V, a
//   one-split block rounds the normalised probabilities to the input dtype
//   first, as the plain twin and the JAX package's ref oracle do
//   (repro/kernels/ref.py:86), so the kernel path and the plain path round
//   alike; across splits the probabilities stay fp32 (no block can
//   normalise them), as in the Pallas kernel.
// * Streaming tiles.  Each warp double-buffers its tiles in shared memory
//   with cp.async, 16 bytes a lane and neighbouring lanes on neighbouring
//   addresses, so its next tile is in flight while it uses this one; the
//   first V tile is in flight during the softmax.  Tiles stay in the input
//   dtype and are widened in registers; rows are padded by 32 bytes so the
//   two lanes of a key and the keys of a load phase fall in different
//   banks.  Where D is not a whole number of 16-byte vectors, or a cache
//   pointer is not 16-byte aligned, the scalar-load instantiation of the
//   same kernel stages the tiles with plain loads instead.
// * Products on the CUDA cores in fp32: one query token per row leaves the
//   tensor cores nothing to reuse.  Scores are kept in the log2 domain
//   (scale * log2 e folded into q) and exponentiated with exp2.  Two lanes
//   share a key's dot product; for P.V each lane owns NCOL output columns of
//   every query of the group.
// * Two widths, each its own instantiation: D <= 128 takes NCOL 4 (the
//   shapes granite, h2o and minitron run, sized as before), D <= 320
//   (gemma3) NCOL 10.  At D 320 eight warps' double-buffered 16-key tiles
//   take 168 KB in bf16 (225,408 bytes with the scores of a 512-key split
//   for a group of 16) but 328 KB in fp32, so the fp32 instantiation walks
//   the split with four warps (164 KB of tiles, 221,312 bytes in all).  The
//   merge kernel keeps 128 threads and loops over the columns.
#include "common.cuh"

namespace {

constexpr int WK = 16;          // keys per warp tile: two lanes per key
constexpr int DMAX = 320;       // largest head dim
constexpr int GMAX = 16;        // largest GQA group
constexpr int KC_MAX = 512;     // most keys a split holds (its scores sit in shared memory)
constexpr int COMBINE_NT = 128; // threads of the merge kernel

template <typename T> struct Geom {
  static constexpr int VW = 16 / sizeof(T);     // elements per 16-byte vector
  static constexpr int PAD = 32 / sizeof(T);    // tile row padding, elements
};

// An instantiation's width: NCOL output columns a lane (head dims up to
// 32 NCOL), NW warps each walking its own tiles of the split
template <typename T, int NCOL> struct Width {
  static constexpr int DMAX = 32 * NCOL;
  static constexpr int NW = NCOL > 4 && sizeof(T) == 4 ? 4 : 8;
  static constexpr int NT = 32 * NW;
};

// tiles [NW warps][2 stages][WK][D + PAD] (K in pass 1, V in pass 2, the
// warps' P.V sums at the end), then, fp32: q [G][D], the split's scores
// and then probabilities [G][kc], the rows' max and sum [2][G]
template <typename T, int NW>
__host__ __device__ constexpr size_t tile_bytes(int G, int D) {
  const size_t tiles = static_cast<size_t>(NW) * 2 * WK * (D + Geom<T>::PAD) * sizeof(T);
  const size_t sums = sizeof(float) * NW * G * D;
  return tiles > sums ? tiles : sums;
}
template <typename T, int NW>
constexpr size_t smem_bytes(int G, int D, int kc) {
  return tile_bytes<T, NW>(G, D) + sizeof(float) * (static_cast<size_t>(G) * (D + kc + 2));
}

__device__ __forceinline__ void widen(const __nv_bfloat16* src, float* dst) {  // 8 values
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void widen(const float* src, float* dst) {  // 4 values
  const float4 f = *reinterpret_cast<const float4*>(src);
  dst[0] = f.x;
  dst[1] = f.y;
  dst[2] = f.z;
  dst[3] = f.w;
}
__device__ __forceinline__ float2 widen2(const __nv_bfloat16* src) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
}
__device__ __forceinline__ float2 widen2(const float* src) {
  return *reinterpret_cast<const float2*>(src);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage rows [n0, n0 + WK) of one kv head's K or V rows in a warp's tile;
// rows at or past s1 are zero.  VEC: 16-byte cp.async per chunk, lane e of
// the warp taking chunks e, e + 32, ... (row, chunk) stepped without a
// divide; else plain loads.
template <typename T, bool VEC>
__device__ __forceinline__ void load_tile(T* tile, const T* src, size_t row_stride, int n0, int s1,
                                          int RS, int D, int lane) {
  if constexpr (VEC) {
    constexpr int VW = Geom<T>::VW;
    const int cpr = D / VW;
    const int r_step = 32 / cpr, c_step = 32 % cpr;
    int r = lane / cpr, c = lane % cpr;
    while (r < WK) {
      const int key = n0 + r;
      const size_t off = static_cast<size_t>(min(key, s1 - 1)) * row_stride + c * VW;
      rt::cp_async16(tile + r * RS + c * VW, src + off, key < s1 ? 16 : 0);
      c += c_step;
      r += r_step;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
  } else {
    for (int r = 0; r < WK; ++r) {
      const bool ok = n0 + r < s1;
      const size_t row = static_cast<size_t>(ok ? n0 + r : n0) * row_stride;
      for (int d = lane; d < D; d += 32) tile[r * RS + d] = ok ? src[row + d] : rt::from_f<T>(0.f);
    }
  }
}

// One block: split blockIdx.x of batch row blockIdx.z, kv head blockIdx.y.
// VEC: tiles staged with 16-byte cp.async (D a whole number of vectors,
// aligned caches); otherwise with plain loads.  GC >= G: the group's
// registers.  Output column of a lane's slot x < NCOL: VEC, 2 lane + 64
// (x / 2) + x % 2 (NCOL / 2 pairs); else lane + 32 x.
template <typename T, bool VEC, int GC, int NCOL>
__global__ void __launch_bounds__(Width<T, NCOL>::NT)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const int* __restrict__ cache_len, T* __restrict__ o, float* __restrict__ part_acc,
           float* __restrict__ part_ml, int S, int Hq, int Hkv, int Hs, int D, int kc,
           float qscale) {
  constexpr int VW = Geom<T>::VW;
  constexpr int NW = Width<T, NCOL>::NW, NT = Width<T, NCOL>::NT;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int G = Hq / Hkv;
  const int len = min(max(cache_len[b], 0), S);
  const int s0 = split * kc;
  const size_t head0 = static_cast<size_t>(b) * Hq + static_cast<size_t>(hk) * G;
  if (s0 >= len) {                              // nothing to attend to in this split
    if (n_split == 1)
      for (int e = tid; e < G * D; e += NT) o[head0 * D + e] = rt::from_f<T>(0.f);
    return;
  }
  const int s1 = min(s0 + kc, len);             // this block's keys: [s0, s1)
  const int n_tiles = (s1 - s0 + WK - 1) / WK;
  const int RS = D + Geom<T>::PAD;              // tile row stride, elements

  T* tiles = reinterpret_cast<T*>(smem) + static_cast<size_t>(warp) * 2 * WK * RS;
  float* q_s = reinterpret_cast<float*>(smem + tile_bytes<T, NW>(G, D));  // [G][D], pre-scaled
  float* p_s = q_s + G * D;                     // [G][kc] scores, then probabilities
  float* ml_s = p_s + G * kc;                   // [max, sum][G], log2 domain

  const size_t kv_row = static_cast<size_t>(Hs) * D;
  const size_t kv0 = static_cast<size_t>(b) * S * kv_row + static_cast<size_t>(hk) * D;
  // this warp's i-th tile (keys s0 + WK (warp + NW i) ...) into stage i % 2;
  // with VEC one cp.async group a call, empty past the last tile
  auto load = [&](const T* src, int i) {
    const int t = warp + NW * i;
    if (t < n_tiles)
      load_tile<T, VEC>(tiles + (i % 2) * WK * RS, src + kv0, kv_row, s0 + t * WK, s1, RS, D,
                        lane);
    if constexpr (VEC) rt::cp_async_commit();
  };

  load(k, 0);
  const T* qb = q + head0 * D;
  for (int e = tid; e < G * D; e += NT) q_s[e] = rt::to_f(qb[e]) * qscale;
  __syncthreads();                              // q_s is shared by the warps

  // pass 1: scores of key kj of each tile, two lanes over every other chunk
  const int kj = lane / 2, h = lane % 2;
  const int cpr = D / VW;                       // 16-byte chunks per row
  for (int i = 0; warp + NW * i < n_tiles; ++i) {
    load(k, i + 1);                             // this warp's next K tile, in flight
    if constexpr (VEC) rt::cp_async_wait<1>();
    __syncwarp();                               // tile i landed, every lane's share
    const T* ks = tiles + (i % 2) * WK * RS;
    float s[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) s[g] = 0.f;
    if constexpr (VEC) {
      for (int c = h; c < cpr; c += 2) {
        float kf[VW];
        widen(ks + kj * RS + c * VW, kf);
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          if (g < G) {
            const float4* qv = reinterpret_cast<const float4*>(q_s + g * D + c * VW);
#pragma unroll
            for (int u = 0; u < VW / 4; ++u) {
              const float4 x = qv[u];
              s[g] = fmaf(x.x, kf[4 * u], s[g]);
              s[g] = fmaf(x.y, kf[4 * u + 1], s[g]);
              s[g] = fmaf(x.z, kf[4 * u + 2], s[g]);
              s[g] = fmaf(x.w, kf[4 * u + 3], s[g]);
            }
          }
        }
      }
    } else {
      for (int d = h; d < D; d += 2) {
        const float kf = rt::to_f(ks[kj * RS + d]);
#pragma unroll
        for (int g = 0; g < GC; ++g)
          if (g < G) s[g] = fmaf(q_s[g * D + d], kf, s[g]);
      }
    }
    const int j = (warp + NW * i) * WK + kj;    // key index within the split
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g < G) {
        const float sc = s[g] + __shfl_xor_sync(0xffffffffu, s[g], 1);
        if (h == 0) p_s[g * kc + j] = sc;
      }
    }
    __syncwarp();                               // this stage is free again
  }
  if constexpr (VEC) rt::cp_async_wait<0>();   // the trailing empty group
  __syncwarp();
  load(v, 0);                                   // the first V tile loads during the softmax
  __syncthreads();                              // every score of the split is in p_s

  // softmax, warp w taking rows w, w + NW, ...: max, sum, probabilities
  // (keys past the split's end, up to its last tile, get 0)
  const int nk = s1 - s0;
  for (int g = warp; g < G; g += NW) {
    float* row = p_s + g * kc;
    float mx = rt::kNegInf;
    for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = exp2f(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n_tiles * WK; j += 32) {
      if (j >= nk)
        row[j] = 0.f;
      else if (n_split == 1)                    // the twin's rounding of softmax(s)
        row[j] = rt::to_f(rt::from_f<T>(row[j] / sum));
    }
    if (lane == 0) {
      ml_s[g] = mx;
      ml_s[G + g] = sum;
    }
  }
  __syncthreads();

  // pass 2: acc[g][cols] = sum over the warp's keys of p[g][j] v[j][cols]
  float acc[GC][NCOL];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int x = 0; x < NCOL; ++x) acc[g][x] = 0.f;
  for (int i = 0; warp + NW * i < n_tiles; ++i) {
    load(v, i + 1);                             // this warp's next V tile, in flight
    if constexpr (VEC) rt::cp_async_wait<1>();
    __syncwarp();
    const T* vs = tiles + (i % 2) * WK * RS;
    const float* p = p_s + (warp + NW * i) * WK;
#pragma unroll 4
    for (int j = 0; j < WK; ++j) {
      float vx[NCOL];
      if constexpr (VEC) {
#pragma unroll
        for (int x2 = 0; x2 < NCOL / 2; ++x2) {
          const int col = 2 * lane + 64 * x2;
          const float2 f = col < D ? widen2(vs + j * RS + col) : make_float2(0.f, 0.f);
          vx[2 * x2] = f.x;
          vx[2 * x2 + 1] = f.y;
        }
      } else {
#pragma unroll
        for (int x = 0; x < NCOL; ++x) {
          const int col = lane + 32 * x;
          vx[x] = col < D ? rt::to_f(vs[j * RS + col]) : 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g < G) {
          const float pg = p[g * kc + j];
#pragma unroll
          for (int x = 0; x < NCOL; ++x) acc[g][x] = fmaf(pg, vx[x], acc[g][x]);
        }
      }
    }
    __syncwarp();                               // this stage is free again
  }
  if constexpr (VEC) rt::cp_async_wait<0>();   // the trailing empty group

  // add the warps' sums (in the tiles' space, now free), then write the
  // output, or the split's state
  __syncthreads();
  float* a_w = reinterpret_cast<float*>(smem);  // [NW][G][D]
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g < G) {
#pragma unroll
      for (int x = 0; x < NCOL; ++x) {
        const int col = VEC ? 2 * lane + 64 * (x / 2) + x % 2 : lane + 32 * x;
        if (col < D) a_w[(warp * G + g) * D + col] = acc[g][x];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += NT) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a += a_w[w * G * D + e];
    const int g = e / D;
    if (n_split == 1) {
      o[head0 * D + e] = rt::from_f<T>(a);      // the probabilities were normalised
    } else {
      part_acc[((head0 + g) * n_split + split) * D + e - g * D] = a;
      if (e - g * D == 0) {
        float* ml = part_ml + ((head0 + g) * n_split + split) * 2;
        ml[0] = ml_s[g];
        ml[1] = ml_s[G + g];
      }
    }
  }
}

// Merge the partial states of one (batch row, q head) by log-sum-exp: only
// the splits below ceil(len / kc) hold keys.
template <typename T>
__global__ void __launch_bounds__(COMBINE_NT)
decode_fwd_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                   const int* __restrict__ cache_len, T* __restrict__ o, int S, int Hq, int D,
                   int kc, int n_split) {
  const int hq = blockIdx.x, b = blockIdx.y;
  const int len = min(max(cache_len[b], 0), S);
  const int n = (len + kc - 1) / kc;
  const size_t head = static_cast<size_t>(b) * Hq + hq;
  const float* ml = part_ml + head * n_split * 2;
  float m = rt::kNegInf;
  for (int i = 0; i < n; ++i) m = fmaxf(m, ml[2 * i]);
  float l = 0.f;
  for (int i = 0; i < n; ++i) l += ml[2 * i + 1] * exp2f(ml[2 * i] - m);
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < n; ++i)
      a = fmaf(part_acc[(head * n_split + i) * D + d], exp2f(ml[2 * i] - m), a);
    o[head * D + d] = rt::from_f<T>(a * inv);
  }
}

template <typename T, bool VEC, int GC, int NCOL>
cudaError_t launch_split(const T* q, const T* k, const T* v, const int* cache_len, T* o,
                         float* part_acc, float* part_ml, int B, int S, int Hq, int Hkv, int Hs,
                         int D, int kc, int n_split, float scale, cudaStream_t stream) {
  using W = Width<T, NCOL>;
  constexpr size_t smem_max = smem_bytes<T, W::NW>(GMAX, W::DMAX, KC_MAX);
  static_assert(smem_max <= 232448, "a block may use at most 227 KB of shared memory");
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = rt::smem_limit_once(decode_fwd<T, VEC, GC, NCOL>,
                                        static_cast<int>(smem_max), smem_set);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes<T, W::NW>(Hq / Hkv, D, kc);
  decode_fwd<T, VEC, GC, NCOL><<<dim3(n_split, Hkv, B), W::NT, smem, stream>>>(
      q, k, v, cache_len, o, part_acc, part_ml, S, Hq, Hkv, Hs, D, kc, scale * rt::kLog2e);
  return cudaGetLastError();
}

template <typename T, bool VEC, int NCOL>
cudaError_t launch_group(const T* q, const T* k, const T* v, const int* cache_len, T* o,
                         float* part_acc, float* part_ml, int B, int S, int Hq, int Hkv, int Hs,
                         int D, int kc, int n_split, float scale, cudaStream_t stream) {
  return Hq / Hkv <= 4
             ? launch_split<T, VEC, 4, NCOL>(q, k, v, cache_len, o, part_acc, part_ml, B, S, Hq,
                                             Hkv, Hs, D, kc, n_split, scale, stream)
             : launch_split<T, VEC, GMAX, NCOL>(q, k, v, cache_len, o, part_acc, part_ml, B, S,
                                                Hq, Hkv, Hs, D, kc, n_split, scale, stream);
}

template <typename T, bool VEC>
cudaError_t launch_width(const T* q, const T* k, const T* v, const int* cache_len, T* o,
                         float* part_acc, float* part_ml, int B, int S, int Hq, int Hkv, int Hs,
                         int D, int kc, int n_split, float scale, cudaStream_t stream) {
  return D <= 128 ? launch_group<T, VEC, 4>(q, k, v, cache_len, o, part_acc, part_ml, B, S, Hq,
                                            Hkv, Hs, D, kc, n_split, scale, stream)
                  : launch_group<T, VEC, 10>(q, k, v, cache_len, o, part_acc, part_ml, B, S, Hq,
                                             Hkv, Hs, D, kc, n_split, scale, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* cache_len, void* o,
           void* part_acc, void* part_ml, int B, int S, int Hq, int Hkv, int Hs, int D, int kc,
           float scale, void* stream_) {
  if (D < 1 || D > DMAX || Hkv < 1 || Hs < Hkv || Hq % Hkv != 0 || Hq / Hkv > GMAX || S < 0 ||
      kc < WK || kc > KC_MAX || kc % WK != 0)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int n_split = S > kc ? (S + kc - 1) / kc : 1;
  if (n_split > 1 && (part_acc == nullptr || part_ml == nullptr)) return cudaErrorInvalidValue;
  const auto stream = static_cast<cudaStream_t>(stream_);
  const auto qt = static_cast<const T*>(q);
  const auto kt = static_cast<const T*>(k);
  const auto vt = static_cast<const T*>(v);
  const auto lens = static_cast<const int*>(cache_len);
  const auto ot = static_cast<T*>(o);
  const auto pa = static_cast<float*>(part_acc);
  const auto pm = static_cast<float*>(part_ml);
  const bool vec = (static_cast<size_t>(D) * sizeof(T)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  cudaError_t err = vec ? launch_width<T, true>(qt, kt, vt, lens, ot, pa, pm, B, S, Hq, Hkv, Hs,
                                                D, kc, n_split, scale, stream)
                        : launch_width<T, false>(qt, kt, vt, lens, ot, pa, pm, B, S, Hq, Hkv, Hs,
                                                 D, kc, n_split, scale, stream);
  if (err != cudaSuccess || n_split == 1) return err;
  decode_fwd_combine<T><<<dim3(Hq, B), COMBINE_NT, 0, stream>>>(pa, pm, lens, ot, S, Hq, D, kc,
                                                                n_split);
  return cudaGetLastError();
}

}  // namespace

// q, caches, lengths and output as above (Hs: the heads a cache row
// holds, the row stride in units of D); part_acc (B,Hq,n_split,D) and
// part_ml (B,Hq,n_split,2) fp32 scratch with n_split = ceil(S / kc), unused
// (may be null) when S <= kc.  kc: a multiple of 16, at most KC_MAX.
extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* cache_len, void* o, void* part_acc,
                                     void* part_ml, int B, int S, int Hq, int Hkv, int Hs, int D,
                                     int kc, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, cache_len, o, part_acc, part_ml, B, S, Hq, Hkv, Hs, D,
                               kc, scale, stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* cache_len, void* o, void* part_acc,
                                    void* part_ml, int B, int S, int Hq, int Hkv, int Hs, int D,
                                    int kc, float scale, void* stream) {
  return launch<float>(q, k, v, cache_len, o, part_acc, part_ml, B, S, Hq, Hkv, Hs, D, kc, scale,
                       stream);
}

RT_EXPORT_ERROR_STRING(decode_attention)
