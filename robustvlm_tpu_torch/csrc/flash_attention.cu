// Causal (or not) flash attention on Hopper, forward and backward, with
// optional ALiBi slopes and key lengths that need not be a multiple of any
// tile.
//
// Replaces robustvlm_tpu/ops/pallas/flash_attention.py: _flash_fwd (kernel
// body _fwd_kernel), and the two pallas_calls of _flash_bwd (_bwd_dq_kernel,
// _bwd_dkv_kernel). Layout (B*H, N, D), contiguous; q (bh, nq, D), k and v
// (bh, nk, D); float32 or bfloat16 operands; float32 softmax and sums; head
// dims 64 (CLIP text tower) and 128 (LLaMA-7B).
//
// The function is the Pallas kernels', not their tiling: the TPU keeps a
// whole K/V row in VMEM and walks 128-key blocks; here each block owns a
// tile of query rows (of keys in dK/dV) and streams the other side through
// shared memory in tiles: 64 rows by 64 in bfloat16, the shapes of F32Tile
// in float32.
//
// Semantics, as the Pallas kernels and the public function compute them:
// - forward: q scaled in its own dtype before Q K^T; ALiBi subtracts
//   slope * (row - col) after the scale; then the mask (col < nk, and for
//   causal col <= row + q_off) sets scores to -1e30 before the row max;
//   P (rounded to v's dtype) times V; l = 0 guarded; lse = m + log l.
// - backward: S = Q K^T in float32, then times scale (q is NOT pre-scaled
//   here, unlike the forward); P = exp(S - lse), 0 where masked; delta =
//   rowsum(dO * O) in float32; dS = P (dP - delta) scale; dS rounded to k's
//   dtype for dQ and q's for dK, P to dO's for dV.
// - q_off = nk - nq for causal calls: the diagonal of a query block that
//   ends a longer key sequence (the JAX public function sends that case to
//   its reference, which offsets the diagonal the same way; ALiBi keeps the
//   raw row index there too).
// - Masked entries take P = 0 explicitly: a row whose running max is still
//   -1e30 never counts a masked column as exp(0) = 1. A row with no key
//   at all (causal with nq > nk) gives O = 0 and lse = -1e30.
// - Causal trip counts: the forward and dQ stop at the last key tile that
//   reaches the block's diagonal; dK/dV start at the first query tile that
//   reaches the key block. That halves the work of a causal LLaMA layer.
// - Deterministic backward without atomics: dQ in one kernel over query
//   tiles (it also writes delta), dK/dV in another over key tiles, launched
//   after it on the same stream.
//
// Two implementations:
// - float32 (no TF32, so no tensor cores): register-tiled FMA kernels on the
//   CUDA cores (fma_tile.cuh). Bound: operations, 4*nq*nk*D (forward) and
//   10*nq*nk*D (backward) per head, halved when causal, at the card's
//   float32 FMA rate; the two-kernel backward recomputes S and dP in each
//   kernel, 14*nq*nk*D in all. Once every FMA takes an operand from shared
//   memory, the shared-memory pipe is the nearer limit: a warp's 16-byte
//   load costs 2 cycles of it at best. What the design does about it: every
//   product of a tile is a small matrix product in registers (a thread
//   holds a micro-tile of S or dP and one of the accumulator: 8 to 13 FMAs
//   for each 16-byte load, and a lane layout that keeps every load at 2
//   cycles, fma_tile.cuh), with no shuffle per dot product: row max, row
//   sum and delta are reduced once a tile over the 8 lanes of a row. P and
//   dS pass between a tile's two products through a padded shared tile,
//   within one warp. The streamed tiles come in by 16-byte cp.async while
//   the tile before them is computed (two buffers; in the forward at
//   D = 128 one buffer each for K and V, which take turns, so that two
//   blocks fit an SM); ragged tails are zero-filled. One online-softmax
//   update per tile; tiles wholly below the diagonal skip the mask; the
//   longest causal blocks are launched first. Shared rows are padded, not
//   swizzled (D + 4 floats, tile + 8 for P and dS): fma_tile.cuh says why
//   no warp load has a bank conflict.
// - bfloat16: tensor cores through mma.sync m16n8k16 (mma_bf16.cuh), four
//   warps of 16 rows. Scores, P and dS stay in registers. The backward
//   kernels keep their block's own operands (Q and dO for dQ, K and V for
//   dK/dV) in shared memory and read A fragments from there one k-step at a
//   time: at D = 128 the dK and dV accumulators alone take 128 registers a
//   thread. Bound: bytes at these sequence lengths (q, k, v, o read or
//   written once); chip_smoke.py computes it as bound_ms. Loads are
//   synchronous (no cp.async/TMA pipeline) and the products are not wgmma:
//   later work.

#include <math.h>

#include "fma_tile.cuh"
#include "mma_bf16.cuh"

namespace {

// ============================================= float32: register-tiled FMA
// The masks, shared by every kernel: key col visible from query row.
__device__ __forceinline__ bool visible(int row, int col, int nq, int nk, bool causal,
                                        int q_off) {
  return row < nq && col < nk && (!causal || col <= row + q_off);
}

__device__ __forceinline__ float alibi(float s, float slope, int row, int col) {
  return __fsub_rn(s, __fmul_rn(slope, static_cast<float>(row - col)));
}

// Keys [0, hi) can be visible from query rows [r0, r0 + rows).
__device__ __forceinline__ int key_end(int r0, int rows, int nk, bool causal, int q_off) {
  return causal ? max(0, min(nk, r0 + rows + q_off)) : nk;
}

// The first query row (rounded down to a tile) that sees key k0.
__device__ __forceinline__ int query_start(int k0, int tile, bool causal, int q_off) {
  return causal ? (max(0, k0 - q_off) / tile) * tile : 0;
}

// Block shape per head dim and kernel: kRows rows of the block's own side
// (queries; keys in dK/dV), kTile rows of the streamed side per
// shared-memory tile, kThreads threads, kBufs buffers for the streamed tiles
// (2: tile t + 1 is copied while tile t is computed; 1: the copy waits for
// the tile's last product, except in the forward, where K and V take turns
// in a buffer each). Chosen on the card by
// scripts/sweep_flash_fp32_torch.py, which rewrites these lines.
enum { kFwd = 0, kDq = 1, kDkv = 2 };
template <int D, int Kind>
struct F32Tile;
template <>
struct F32Tile<64, kFwd> { static constexpr int kRows = 32, kTile = 32, kThreads = 64, kBufs = 2; };
template <>
struct F32Tile<64, kDq> { static constexpr int kRows = 32, kTile = 32, kThreads = 64, kBufs = 2; };
template <>
struct F32Tile<64, kDkv> { static constexpr int kRows = 64, kTile = 32, kThreads = 256, kBufs = 2; };
template <>
struct F32Tile<128, kFwd> { static constexpr int kRows = 64, kTile = 48, kThreads = 128, kBufs = 1; };
template <>
struct F32Tile<128, kDq> { static constexpr int kRows = 64, kTile = 64, kThreads = 256, kBufs = 2; };
template <>
struct F32Tile<128, kDkv> { static constexpr int kRows = 32, kTile = 32, kThreads = 128, kBufs = 2; };

// What follows from a shape (thread layout of fma_tile.cuh) and the block's
// shared memory: the own tiles staged once (Q; Q and dO; K and V), kBufs
// stages of two streamed tiles (and, in dK/dV, their lse and delta rows),
// and the P / dS tile (P^T and dS^T in dK/dV) between a tile's products.
template <int D, int Kind>
struct F32 : F32Tile<D, Kind> {
  using S = F32Tile<D, Kind>;
  static constexpr int kG = S::kThreads / 8;  // row groups
  static constexpr int kR = S::kRows / kG;    // rows per thread
  static constexpr int kSN = S::kTile / 8;    // score columns per thread
  static constexpr int kNC = D / 32;          // 4-column chunks of an accumulator row per thread
  static constexpr int kLd = D + kPadF;
  static constexpr int kLdP = S::kTile + kPadP;
  static constexpr int kStage = 2 * S::kTile * kLd + (Kind == kDkv ? 2 * S::kTile : 0);
  static constexpr int kSmem = 4 * ((Kind == kFwd ? 1 : 2) * S::kRows * kLd + S::kBufs * kStage +
                                    (Kind == kDkv ? 2 : 1) * S::kRows * kLdP);
  // blocks an SM that the registers are kept free for: what the SM's 228 KB
  // (1 KB reserved a block) hold, up to 256 threads (255 registers each)
  static constexpr int kFit = 228 * 1024 / (kSmem + 1024), kCap = 256 / S::kThreads;
  static constexpr int kBlocks = kFit < kCap ? kFit : (kCap < 1 ? 1 : kCap);
  static_assert(S::kThreads % 32 == 0 && S::kRows % kG == 0 && S::kTile % 8 == 0 && D % 32 == 0,
                "the thread layout needs whole micro-tiles");
  static_assert(S::kBufs == 1 || S::kBufs == 2, "one or two stages");
  static_assert(kSmem <= 227 * 1024, "a block may take 227 KB of shared memory");
};

// Forward: a block owns kRows query rows and walks the key tiles up to its
// diagonal. Per tile: S = (Q scale) K^T in micro-tiles, one online-softmax
// update (row max over the 8 lanes of a row, alpha rescales the accumulator
// once), P through shared memory, O += P V.
template <int D>
__global__ void __launch_bounds__(F32<D, kFwd>::kThreads, F32<D, kFwd>::kBlocks)
flash_fwd_tile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                      const float* __restrict__ slopes, int nq, int nk, int causal, int q_off,
                      float scale) {
  using P = F32<D, kFwd>;
  constexpr int BM = P::kRows, BN = P::kTile, T = P::kThreads, G = P::kG, R = P::kR;
  constexpr int SN = P::kSN, NC = P::kNC, LD = P::kLd, LDP = P::kLdP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* bufs = qs + BM * LD;
  float* ps = bufs + P::kBufs * P::kStage;
  const int gy = row_group(), lx = col_group();
  const int bh = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BM;  // the longest blocks start first
  const size_t qb = (size_t)bh * nq * D, kb = (size_t)bh * nk * D;
  const float slope = slopes ? slopes[bh] : 0.f;
  const int hi = key_end(r0, BM, nk, causal, q_off);
  const int n_tiles = (hi + BN - 1) / BN;

  // With two buffers, K and V of tile t + 1 are copied while tile t is
  // computed. With one, K and V have a buffer each and take turns: V of
  // tile t is copied during S = Q K^T, K of tile t + 1 during O += P V.
  auto stage_k = [&](int t) {
    const int kv0 = t * BN;
    stage_tile_async<D, BN, T>(bufs + (t % P::kBufs) * P::kStage, k + kb + (size_t)kv0 * D,
                               min(BN, nk - kv0));
  };
  auto stage_v = [&](int t) {
    const int kv0 = t * BN;
    stage_tile_async<D, BN, T>(bufs + (t % P::kBufs) * P::kStage + BN * LD,
                               v + kb + (size_t)kv0 * D, min(BN, nk - kv0));
  };

  if (n_tiles > 0) {
    stage_tile_async<D, BM, T>(qs, q + qb + (size_t)r0 * D, min(BM, nq - r0));
    cp_async_commit();
    stage_k(0);
    if (P::kBufs == 2) stage_v(0);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's part of Q is here: scale it in float32
    scale_own_chunks<D, BM, T>(qs, scale);
  }

  float acc[R][4 * NC];
  float m[R], l[R];  // l: this thread's part of the row sum, reduced at the end
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // K of tile t is here; everyone is done with tile t - 1
    if (P::kBufs == 1) {
      stage_v(t);
      cp_async_commit();
    } else if (t + 1 < n_tiles) {
      stage_k(t + 1);
      stage_v(t + 1);
      cp_async_commit();
    }
    const float* ks = bufs + (t % P::kBufs) * P::kStage;
    const float* vs = ks + BN * LD;
    const int kv0 = t * BN;

    float s[R][SN];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < SN; ++j) s[i][j] = 0.f;
    }
    tile_abt<R, SN, G, D, LD, LD>(s, qs + gy * LD, ks + lx * LD);

    // a tile wholly below the diagonal and inside nk needs no mask
    const bool full = kv0 + BN <= nk && (!causal || kv0 + BN - 1 <= r0 + q_off);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = r0 + gy + i * G;
      uint32_t ok = full ? 0xffffffffu : 0u;
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        const int col = kv0 + lx + 8 * j;
        float sj = s[i][j];
        if (slopes) sj = alibi(sj, slope, row, col);
        if (!full) {
          const bool vis = visible(row, col, nq, nk, causal, q_off);
          ok |= (vis ? 1u : 0u) << j;
          sj = vis ? sj : kNegBig;  // before the max
        }
        s[i][j] = sj;
        mx = fmaxf(mx, sj);
      }
      const float m_new = fmaxf(m[i], oct_max(mx));
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        const float p = (ok >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        l[i] += p;
        ps[(gy + i * G) * LDP + lx + 8 * j] = p;
      }
    }
    // A row of P is written and read by the 8 lanes of one warp, so P alone
    // needs no block barrier: with two buffers the warps of a block drift
    // apart here, one in its softmax while another multiplies.
    if (P::kBufs == 1) {
      cp_async_wait<0>();  // V of tile t
      __syncthreads();     // and everyone is done with K of tile t
      if (t + 1 < n_tiles) {
        stage_k(t + 1);
        cp_async_commit();
      }
    } else {
      __syncwarp();
    }
    tile_ab<R, NC, G, BN, LDP, LD>(acc, ps + gy * LDP, vs + 4 * lx);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = r0 + gy + i * G;
    const float lt = oct_sum(l[i]);
    const float l_safe = lt == 0.f ? 1.f : lt;
    if (row < nq) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        *reinterpret_cast<float4*>(o + qb + (size_t)row * D + 4 * lx + 32 * c) =
            make_float4(acc[i][4 * c] / l_safe, acc[i][4 * c + 1] / l_safe,
                        acc[i][4 * c + 2] / l_safe, acc[i][4 * c + 3] / l_safe);
      }
      if (lx == 0) lse[(size_t)bh * nq + row] = m[i] + logf(l_safe);
    }
  }
}

// dQ over query tiles; also writes delta = rowsum(dO * O) for the dK/dV
// kernel. Q and dO of the block are staged once; per key tile S = Q K^T and
// dP = dO V^T in micro-tiles, dS through shared memory, dQ += dS K.
template <int D>
__global__ void __launch_bounds__(F32<D, kDq>::kThreads, F32<D, kDq>::kBlocks)
flash_bwd_dq_tile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ o,
                         const float* __restrict__ lse, const float* __restrict__ dout,
                         const float* __restrict__ slopes, float* __restrict__ dq,
                         float* __restrict__ delta, int nq, int nk, int causal, int q_off,
                         float scale) {
  using P = F32<D, kDq>;
  constexpr int BM = P::kRows, BN = P::kTile, T = P::kThreads, G = P::kG, R = P::kR;
  constexpr int SN = P::kSN, NC = P::kNC, LD = P::kLd, LDP = P::kLdP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + BM * LD;
  float* bufs = dos + BM * LD;
  float* dss = bufs + P::kBufs * P::kStage;
  const int gy = row_group(), lx = col_group();
  const int bh = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BM;  // the longest blocks start first
  const size_t qb = (size_t)bh * nq * D, kb = (size_t)bh * nk * D;
  const float slope = slopes ? slopes[bh] : 0.f;
  const int hi = key_end(r0, BM, nk, causal, q_off);
  const int n_tiles = (hi + BN - 1) / BN;

  auto stage = [&](int t) {
    float* ks = bufs + (t % P::kBufs) * P::kStage;
    const int kv0 = t * BN, valid = min(BN, nk - kv0);
    stage_tile_async<D, BN, T>(ks, k + kb + (size_t)kv0 * D, valid);
    stage_tile_async<D, BN, T>(ks + BN * LD, v + kb + (size_t)kv0 * D, valid);
    cp_async_commit();
  };

  if (n_tiles > 0) {
    stage_tile_async<D, BM, T>(qs, q + qb + (size_t)r0 * D, min(BM, nq - r0));
    stage_tile_async<D, BM, T>(dos, dout + qb + (size_t)r0 * D, min(BM, nq - r0));
    stage(0);
  }

  // delta and lse of this thread's rows, from device memory while the
  // copies fly: each of a row's 8 lanes sums its own columns
  float dl[R], lse_r[R], acc[R][4 * NC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = r0 + gy + i * G;
    const bool live = row < nq;
    float part = 0.f;
    if (live) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const size_t at = qb + (size_t)row * D + 4 * lx + 32 * c;
        const float4 a = *reinterpret_cast<const float4*>(dout + at);
        const float4 b = *reinterpret_cast<const float4*>(o + at);
        part = fmaf(a.x, b.x, part);
        part = fmaf(a.y, b.y, part);
        part = fmaf(a.z, b.z, part);
        part = fmaf(a.w, b.w, part);
      }
    }
    dl[i] = oct_sum(part);
    lse_r[i] = live ? lse[(size_t)bh * nq + row] : 0.f;
    if (live && lx == 0) delta[(size_t)bh * nq + row] = dl[i];
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is here; everyone is done with tile t - 1
    if (P::kBufs == 2 && t + 1 < n_tiles) stage(t + 1);
    const float* ks = bufs + (t % P::kBufs) * P::kStage;
    const float* vs = ks + BN * LD;
    const int kv0 = t * BN;

    float s[R][SN], dp[R][SN];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < SN; ++j) s[i][j] = dp[i][j] = 0.f;
    }
    tile_abt<R, SN, G, D, LD, LD>(s, qs + gy * LD, ks + lx * LD);     // S = Q K^T
    tile_abt<R, SN, G, D, LD, LD>(dp, dos + gy * LD, vs + lx * LD);  // dP = dO V^T

    const bool full = kv0 + BN <= nk && (!causal || kv0 + BN - 1 <= r0 + q_off);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = r0 + gy + i * G;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        const int col = kv0 + lx + 8 * j;
        float sc = __fmul_rn(s[i][j], scale);
        if (slopes) sc = alibi(sc, slope, row, col);
        const float p =
            (full || visible(row, col, nq, nk, causal, q_off)) ? expf(sc - lse_r[i]) : 0.f;
        dss[(gy + i * G) * LDP + lx + 8 * j] = __fmul_rn(__fmul_rn(p, dp[i][j] - dl[i]), scale);
      }
    }
    __syncwarp();  // a row of dS stays within one warp
    tile_ab<R, NC, G, BN, LDP, LD>(acc, dss + gy * LDP, ks + 4 * lx);  // dQ += dS K
    if (P::kBufs == 1 && t + 1 < n_tiles) {
      __syncthreads();
      stage(t + 1);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = r0 + gy + i * G;
    if (row >= nq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      *reinterpret_cast<float4*>(dq + qb + (size_t)row * D + 4 * lx + 32 * c) =
          make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2], acc[i][4 * c + 3]);
    }
  }
}

// dK and dV over key tiles: K and V of the block's kRows keys are staged
// once; per query tile (with its lse and delta rows) S^T = K Q^T and dP^T =
// V dO^T in micro-tiles whose rows are keys, P^T and dS^T through shared
// memory, dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(F32<D, kDkv>::kThreads, F32<D, kDkv>::kBlocks)
flash_bwd_dkv_tile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ lse,
                          const float* __restrict__ delta, const float* __restrict__ dout,
                          const float* __restrict__ slopes, float* __restrict__ dk,
                          float* __restrict__ dv, int nq, int nk, int causal, int q_off,
                          float scale) {
  using P = F32<D, kDkv>;
  constexpr int BK = P::kRows, BQ = P::kTile, T = P::kThreads, G = P::kG, R = P::kR;
  constexpr int SN = P::kSN, NC = P::kNC, LD = P::kLd, LDP = P::kLdP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + BK * LD;
  float* bufs = vs + BK * LD;
  float* pts = bufs + P::kBufs * P::kStage;
  float* dsts = pts + BK * LDP;
  const int gy = row_group(), lx = col_group();
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // the first key tiles see the most queries
  const size_t qb = (size_t)bh * nq * D, kb = (size_t)bh * nk * D;
  const float slope = slopes ? slopes[bh] : 0.f;
  const int q_begin = query_start(k0, BQ, causal, q_off);
  const int n_tiles = q_begin < nq ? (nq - q_begin + BQ - 1) / BQ : 0;

  auto stage = [&](int t) {
    float* qsb = bufs + (t % P::kBufs) * P::kStage;
    const int q0 = q_begin + t * BQ, valid = min(BQ, nq - q0);
    stage_tile_async<D, BQ, T>(qsb, q + qb + (size_t)q0 * D, valid);
    stage_tile_async<D, BQ, T>(qsb + BQ * LD, dout + qb + (size_t)q0 * D, valid);
    stage_row_async<T>(qsb + 2 * BQ * LD, lse + (size_t)bh * nq + q0, BQ, valid);
    stage_row_async<T>(qsb + 2 * BQ * LD + BQ, delta + (size_t)bh * nq + q0, BQ, valid);
    cp_async_commit();
  };

  if (n_tiles > 0) {
    stage_tile_async<D, BK, T>(ks, k + kb + (size_t)k0 * D, min(BK, nk - k0));
    stage_tile_async<D, BK, T>(vs, v + kb + (size_t)k0 * D, min(BK, nk - k0));
    stage(0);
  }

  float dka[R][4 * NC], dva[R][4 * NC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) dka[i][c] = dva[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is here; everyone is done with tile t - 1
    if (P::kBufs == 2 && t + 1 < n_tiles) stage(t + 1);
    const float* qsb = bufs + (t % P::kBufs) * P::kStage;
    const float* dosb = qsb + BQ * LD;
    const float* lses = dosb + BQ * LD;
    const float* dls = lses + BQ;
    const int q0 = q_begin + t * BQ;

    float st[R][SN], dpt[R][SN];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < SN; ++j) st[i][j] = dpt[i][j] = 0.f;
    }
    tile_abt<R, SN, G, D, LD, LD>(st, ks + gy * LD, qsb + lx * LD);     // S^T = K Q^T
    tile_abt<R, SN, G, D, LD, LD>(dpt, vs + gy * LD, dosb + lx * LD);  // dP^T = V dO^T

    const bool full =
        q0 + BQ <= nq && k0 + BK <= nk && (!causal || k0 + BK - 1 <= q0 + q_off);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int key = k0 + gy + i * G;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        const int qi = lx + 8 * j, row = q0 + qi;
        float sc = __fmul_rn(st[i][j], scale);
        if (slopes) sc = alibi(sc, slope, row, key);
        const float p =
            (full || visible(row, key, nq, nk, causal, q_off)) ? expf(sc - lses[qi]) : 0.f;
        pts[(gy + i * G) * LDP + qi] = p;
        dsts[(gy + i * G) * LDP + qi] = __fmul_rn(__fmul_rn(p, dpt[i][j] - dls[qi]), scale);
      }
    }
    __syncwarp();  // a row (a key) of P^T and dS^T stays within one warp
    tile_ab<R, NC, G, BQ, LDP, LD>(dva, pts + gy * LDP, dosb + 4 * lx);  // dV += P^T dO
    tile_ab<R, NC, G, BQ, LDP, LD>(dka, dsts + gy * LDP, qsb + 4 * lx);  // dK += dS^T Q
    if (P::kBufs == 1 && t + 1 < n_tiles) {
      __syncthreads();
      stage(t + 1);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + gy + i * G;
    if (key >= nk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const size_t at = kb + (size_t)key * D + 4 * lx + 32 * c;
      *reinterpret_cast<float4*>(dk + at) =
          make_float4(dka[i][4 * c], dka[i][4 * c + 1], dka[i][4 * c + 2], dka[i][4 * c + 3]);
      *reinterpret_cast<float4*>(dv + at) =
          make_float4(dva[i][4 * c], dva[i][4 * c + 1], dva[i][4 * c + 2], dva[i][4 * c + 3]);
    }
  }
}

// ============================================ bfloat16: tensor-core kernels
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     const float* __restrict__ slopes, int nq, int nk, int causal, int q_off,
                     float scale) {
  __shared__ __align__(16) bf16 ks[kKv * (D + kPad)];
  __shared__ __align__(16) bf16 vs[kKv * (D + kPad)];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int r0 = blockIdx.y * kMmaRows;
  const int row0 = r0 + warp * 16;
  const size_t qb = (size_t)bh * nq * D, kb = (size_t)bh * nk * D;
  const float slope = slopes ? slopes[bh] : 0.f;

  // q scaled in bf16 before the product: the exact product rounded once
  const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
  uint32_t qa[D / 16][4];
  load_a<D>(qa, q + qb, row0, nq, g, t);
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[s][i] = pack_bf16(bf16_lo(qa[s][i]) * scale_t, bf16_hi(qa[s][i]) * scale_t);
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};  // rows g, g+8
  const int hi = key_end(r0, kMmaRows, nk, causal, q_off);

  for (int kv0 = 0; kv0 < hi; kv0 += kKv) {
    __syncthreads();
    stage_bf16<D>(ks, k + kb + (size_t)kv0 * D, min(kKv, nk - kv0));
    stage_bf16<D>(vs, v + kb + (size_t)kv0 * D, min(kKv, nk - kv0));
    __syncthreads();

    float s[8][4];
    mma_abt<D>(s, qa, ks, g, t);
    uint32_t ok = 0u;  // bit 4j + c: score s[j][c] is visible
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = row0 + g + (c >> 1) * 8;
        const int col = kv0 + j * 8 + 2 * t + (c & 1);
        float sc = s[j][c];
        if (slopes) sc = alibi(sc, slope, row, col);
        const bool vis = visible(row, col, nq, nk, causal, q_off);
        ok |= (vis ? 1u : 0u) << (4 * j + c);
        s[j][c] = vis ? sc : kNegBig;  // before the max
        mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = (ok >> (4 * j + c)) & 1u ? expf(s[j][c] - m[c >> 1]) : 0.f;
      }
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      pack_a(pa, j, p[0], p[1], p[2], p[3]);
    }
    mma_ab<D>(acc, pa, vs, lane);
  }

  float ls[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lh = quad_sum(l[h]);
    ls[h] = lh == 0.f ? 1.f : lh;
  }
  store_rows<D>(o + qb, acc, row0, nq, g, t, 1.f / ls[0], 1.f / ls[1]);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + h * 8;
      if (row < nq) lse[(size_t)bh * nq + row] = m[h] + logf(ls[h]);
    }
  }
}

// Shared memory of the backward kernels: four padded 64-row tiles and two
// float rows (above 48 KB at D = 128, so dynamic).
template <int D>
constexpr int bwd_smem_bytes() {
  return 4 * kKv * (D + kPad) * (int)sizeof(bf16) + 2 * kKv * (int)sizeof(float);
}

// dQ over query tiles; also writes delta = rowsum(dO * O) for the dK/dV
// kernel. Q and dO of the block stay in shared memory.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const float* __restrict__ lse, const bf16* __restrict__ dout,
                        const float* __restrict__ slopes, bf16* __restrict__ dq,
                        float* __restrict__ delta, int nq, int nk, int causal, int q_off,
                        float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kT = kKv * (D + kPad);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kT;
  bf16* ks = dos + kT;
  bf16* vs = ks + kT;
  float* dls = reinterpret_cast<float*>(vs + kT);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int r0 = blockIdx.y * kMmaRows;
  const int row0 = r0 + warp * 16;
  const size_t qb = (size_t)bh * nq * D, kb = (size_t)bh * nk * D;
  const float slope = slopes ? slopes[bh] : 0.f;
  const int valid = min(kMmaRows, nq - r0);

  stage_bf16<D>(qs, q + qb + (size_t)r0 * D, valid);
  stage_bf16<D>(dos, dout + qb + (size_t)r0 * D, valid);
  __syncthreads();
  {  // delta: two threads a row, D/2 columns each, float32
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    const bf16* dor = dos + r * (D + kPad) + half * (D / 2);
    const bf16* orow = o + qb + (size_t)(r0 + r) * D + half * (D / 2);
    float part = 0.f;
    if (r < valid) {
#pragma unroll 8
      for (int c = 0; c < D / 2; ++c) {
        part = fmaf(__bfloat162float(dor[c]), __bfloat162float(orow[c]), part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    dls[r] = part;
    if (half == 0 && r < valid) delta[(size_t)bh * nq + r0 + r] = part;
  }
  __syncthreads();
  float dl[2], lse_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + h * 8;
    dl[h] = dls[warp * 16 + g + h * 8];
    lse_r[h] = row < nq ? lse[(size_t)bh * nq + row] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const bf16* q_rows = qs + warp * 16 * (D + kPad);
  const bf16* do_rows = dos + warp * 16 * (D + kPad);
  const int hi = key_end(r0, kMmaRows, nk, causal, q_off);

  for (int kv0 = 0; kv0 < hi; kv0 += kKv) {
    __syncthreads();
    stage_bf16<D>(ks, k + kb + (size_t)kv0 * D, min(kKv, nk - kv0));
    stage_bf16<D>(vs, v + kb + (size_t)kv0 * D, min(kKv, nk - kv0));
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_abt_smem<D>(s, q_rows, ks, g, t);    // S = Q K^T
    mma_abt_smem<D>(dp, do_rows, vs, g, t);  // dP = dO V^T
    uint32_t dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = row0 + g + (c >> 1) * 8;
        const int col = kv0 + j * 8 + 2 * t + (c & 1);
        float sc = __fmul_rn(s[j][c], scale);
        if (slopes) sc = alibi(sc, slope, row, col);
        const float p =
            visible(row, col, nq, nk, causal, q_off) ? expf(sc - lse_r[c >> 1]) : 0.f;
        ds[c] = __fmul_rn(__fmul_rn(p, dp[j][c] - dl[c >> 1]), scale);
      }
      pack_a(dsa, j, ds[0], ds[1], ds[2], ds[3]);
    }
    mma_ab<D>(acc, dsa, ks, lane);  // dQ += dS K
  }
  store_rows<D>(dq + qb, acc, row0, nq, g, t, 1.f, 1.f);
}

// dK and dV over key tiles: S^T = K Q^T and dP^T = V dO^T, so this warp's
// 16 keys are the rows of every product. K and V of the block stay in
// shared memory.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ lse,
                         const float* __restrict__ delta, const bf16* __restrict__ dout,
                         const float* __restrict__ slopes, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int nq, int nk, int causal, int q_off,
                         float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kT = kKv * (D + kPad);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kT;
  bf16* qs = vs + kT;
  bf16* dos = qs + kT;
  float* lses = reinterpret_cast<float*>(dos + kT);
  float* dls = lses + kKv;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kMmaRows;
  const int key0 = k0 + warp * 16;  // this warp's first key
  const size_t qb = (size_t)bh * nq * D, kb = (size_t)bh * nk * D;
  const float slope = slopes ? slopes[bh] : 0.f;

  stage_bf16<D>(ks, k + kb + (size_t)k0 * D, min(kMmaRows, nk - k0));
  stage_bf16<D>(vs, v + kb + (size_t)k0 * D, min(kMmaRows, nk - k0));
  const bf16* k_rows = ks + warp * 16 * (D + kPad);
  const bf16* v_rows = vs + warp * 16 * (D + kPad);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[nt][c] = dva[nt][c] = 0.f;
  }

  for (int q0 = query_start(k0, kKv, causal, q_off); q0 < nq; q0 += kKv) {
    const int valid = min(kKv, nq - q0);
    __syncthreads();
    stage_bf16<D>(qs, q + qb + (size_t)q0 * D, valid);
    stage_bf16<D>(dos, dout + qb + (size_t)q0 * D, valid);
    for (int i = threadIdx.x; i < kKv; i += kMmaThreads) {
      lses[i] = i < valid ? lse[(size_t)bh * nq + q0 + i] : 0.f;
      dls[i] = i < valid ? delta[(size_t)bh * nq + q0 + i] : 0.f;
    }
    __syncthreads();

    float st[8][4];
    mma_abt_smem<D>(st, k_rows, qs, g, t);  // S^T = K Q^T
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = key0 + g + (c >> 1) * 8;
        const int qi = j * 8 + 2 * t + (c & 1);
        float sc = __fmul_rn(st[j][c], scale);
        if (slopes) sc = alibi(sc, slope, q0 + qi, key);
        st[j][c] = visible(q0 + qi, key, nq, nk, causal, q_off) ? expf(sc - lses[qi]) : 0.f;
      }
      pack_a(pa, j, st[j][0], st[j][1], st[j][2], st[j][3]);
    }
    mma_ab<D>(dva, pa, dos, lane);  // dV += P^T dO

    float dpt[8][4];
    mma_abt_smem<D>(dpt, v_rows, dos, g, t);  // dP^T = V dO^T
    uint32_t dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = j * 8 + 2 * t + (c & 1);
        ds[c] = __fmul_rn(__fmul_rn(st[j][c], dpt[j][c] - dls[qi]), scale);
      }
      pack_a(dsa, j, ds[0], ds[1], ds[2], ds[3]);
    }
    mma_ab<D>(dka, dsa, qs, lane);  // dK += dS^T Q
  }
  store_rows<D>(dk + kb, dka, key0, nk, g, t, 1.f, 1.f);
  store_rows<D>(dv + kb, dva, key0, nk, g, t, 1.f, 1.f);
}

// ================================================================= launches
// Above 48 KB of dynamic shared memory a kernel must opt in; cheap, and
// idempotent.
template <class Kernel>
bool allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) ==
         cudaSuccess;
}

template <int D>
void launch_fwd(int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
                const float* slopes, int bh, int nq, int nk, int causal, int q_off,
                float scale, cudaStream_t s) {
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    using T = float;
    using P = F32<D, kFwd>;
    if (!allow_smem(flash_fwd_tile_kernel<D>, P::kSmem)) return;
    flash_fwd_tile_kernel<D>
        <<<dim3(bh, (nq + P::kRows - 1) / P::kRows), P::kThreads, P::kSmem, s>>>(
            static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
            static_cast<T*>(o), l, slopes, nq, nk, causal, q_off, scale);
  } else {
    using T = bf16;
    flash_fwd_mma_kernel<D><<<dim3(bh, (nq + kMmaRows - 1) / kMmaRows), kMmaThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), l, slopes, nq, nk, causal, q_off, scale);
  }
}

template <int D>
void launch_bwd(int dtype, const void* q, const void* k, const void* v, const void* o,
                const void* lse, const void* dout, const float* slopes, void* dq, void* dk,
                void* dv, void* delta, int bh, int nq, int nk, int causal, int q_off,
                float scale, cudaStream_t s) {
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0) {
    using T = float;
    using PQ = F32<D, kDq>;
    using PK = F32<D, kDkv>;
    if (!allow_smem(flash_bwd_dq_tile_kernel<D>, PQ::kSmem) ||
        !allow_smem(flash_bwd_dkv_tile_kernel<D>, PK::kSmem)) {
      return;
    }
    flash_bwd_dq_tile_kernel<D>
        <<<dim3(bh, (nq + PQ::kRows - 1) / PQ::kRows), PQ::kThreads, PQ::kSmem, s>>>(
            static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
            static_cast<const T*>(o), l, static_cast<const T*>(dout), slopes,
            static_cast<T*>(dq), dl, nq, nk, causal, q_off, scale);
    if (cudaPeekAtLastError() != cudaSuccess) return;
    flash_bwd_dkv_tile_kernel<D>
        <<<dim3(bh, (nk + PK::kRows - 1) / PK::kRows), PK::kThreads, PK::kSmem, s>>>(
            static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), l, dl,
            static_cast<const T*>(dout), slopes, static_cast<T*>(dk), static_cast<T*>(dv), nq,
            nk, causal, q_off, scale);
  } else {
    using T = bf16;
    constexpr int kSmem = bwd_smem_bytes<D>();
    if (!allow_smem(flash_bwd_dq_mma_kernel<D>, kSmem) ||
        !allow_smem(flash_bwd_dkv_mma_kernel<D>, kSmem)) {
      return;
    }
    flash_bwd_dq_mma_kernel<D><<<dim3(bh, (nq + kMmaRows - 1) / kMmaRows), kMmaThreads, kSmem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), l, static_cast<const T*>(dout), slopes,
        static_cast<T*>(dq), dl, nq, nk, causal, q_off, scale);
    if (cudaPeekAtLastError() != cudaSuccess) return;
    flash_bwd_dkv_mma_kernel<D><<<dim3(bh, (nk + kMmaRows - 1) / kMmaRows), kMmaThreads, kSmem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), l, dl,
        static_cast<const T*>(dout), slopes, static_cast<T*>(dk), static_cast<T*>(dv), nq,
        nk, causal, q_off, scale);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Head dims 64 and 128. All arrays are
// contiguous device arrays, 16-byte aligned: q, o (bh, nq, d); k, v (bh, nk,
// d); lse (bh, nq) float32; slopes (bh,) float32 or null (no ALiBi).
// causal: 0 or 1, with the diagonal at col = row + q_off. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported dtype or head dim).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, const void* slopes, int bh, int nq, int nk, int d,
                              int dtype, int causal, int q_off, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sl = static_cast<const float*>(slopes);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64: launch_fwd<64>(dtype, q, k, v, o, lse, sl, bh, nq, nk, causal, q_off, scale, s); break;
    case 128: launch_fwd<128>(dtype, q, k, v, o, lse, sl, bh, nq, nk, causal, q_off, scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// delta is (bh, nq) float32 scratch; dq as q, dk and dv as k.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* lse, const void* dout, const void* slopes, void* dq,
                              void* dk, void* dv, void* delta, int bh, int nq, int nk, int d,
                              int dtype, int causal, int q_off, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sl = static_cast<const float*>(slopes);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64:
      launch_bwd<64>(dtype, q, k, v, o, lse, dout, sl, dq, dk, dv, delta, bh, nq, nk, causal,
                     q_off, scale, s);
      break;
    case 128:
      launch_bwd<128>(dtype, q, k, v, o, lse, dout, sl, dq, dk, dv, delta, bh, nq, nk, causal,
                      q_off, scale, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
