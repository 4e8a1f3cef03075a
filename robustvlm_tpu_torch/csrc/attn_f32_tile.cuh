// The float32 attention forward on the CUDA cores, shared by flash_attention.cu
// (causal or not, ALiBi, any nq and nk) and vit_attention.cu (non-causal,
// nq = nk, no slopes): the same function (flash_attention.cu's header says
// which), each launch with its own block shape. Also the masks that every
// float32 and bfloat16 attention kernel of those two files applies.
//
// The design (fma_tile.cuh has the products): a block owns kRows query rows
// and walks the key tiles up to its diagonal. Per tile: S = (Q scale) K^T
// in register micro-tiles, one online-softmax update (row max over the 8
// lanes of a row, alpha rescales the accumulator once), P through shared
// memory, O += P V. K and V come in by 16-byte cp.async while the tile
// before them is computed; tiles wholly inside the mask skip it; the
// longest causal blocks are launched first.
//
// Head dims that are not a multiple of 32 (ViT-H's 80) are staged into
// shared rows of DP = D rounded up to 32 floats, zero-filled past D: the
// zero columns add nothing to Q K^T, give zero columns of O, and are not
// stored. Rows of D floats in device memory stay 16-byte aligned for any D
// that is a multiple of 4.

#pragma once

#include <math.h>

#include "fma_tile.cuh"
#include "mma_bf16.cuh"

namespace {

// The masks: key col visible from query row.
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

// What follows from a block shape S (kRows rows of the block's own side:
// queries, keys in dK/dV; kTile rows of the streamed side per shared-memory
// tile; kThreads threads; kBufs buffers for the streamed tiles) and a head
// dim D: the thread layout of fma_tile.cuh and the block's shared memory:
// the own tiles staged once (Q; Q and dO; K and V), kBufs stages of two
// streamed tiles (and, in dK/dV, their lse and delta rows), and the P / dS
// tile (P^T and dS^T in dK/dV) between a tile's products.
enum { kFwd = 0, kDq = 1, kDkv = 2 };
template <int D, class S, int Kind>
struct F32 : S {
  static constexpr int kDp = (D + 31) / 32 * 32;  // shared row width: whole 32-column chunks
  static constexpr int kG = S::kThreads / 8;      // row groups
  static constexpr int kR = S::kRows / kG;        // rows per thread
  static constexpr int kSN = S::kTile / 8;        // score columns per thread
  static constexpr int kNC = kDp / 32;            // 4-column chunks of an accumulator row per thread
  static constexpr int kLd = kDp + kPadF;
  static constexpr int kLdP = S::kTile + kPadP;
  static constexpr int kStage = 2 * S::kTile * kLd + (Kind == kDkv ? 2 * S::kTile : 0);
  static constexpr int kSmem = 4 * ((Kind == kFwd ? 1 : 2) * S::kRows * kLd + S::kBufs * kStage +
                                    (Kind == kDkv ? 2 : 1) * S::kRows * kLdP);
  // blocks an SM that the registers are kept free for: what the SM's 228 KB
  // (1 KB reserved a block) hold, up to 256 threads (255 registers each)
  static constexpr int kFit = 228 * 1024 / (kSmem + 1024), kCap = 256 / S::kThreads;
  static constexpr int kBlocks = kFit < kCap ? kFit : (kCap < 1 ? 1 : kCap);
  static_assert(S::kThreads % 32 == 0 && S::kRows % kG == 0 && S::kTile % 8 == 0 && D % 4 == 0,
                "the thread layout needs whole micro-tiles");
  static_assert(S::kBufs == 1 || S::kBufs == 2, "one or two stages");
  static_assert(kSmem <= 227 * 1024, "a block may take 227 KB of shared memory");
};

// Forward: grid (bh, row blocks); causal is 0 or 1 with the diagonal at
// col = row + q_off; slopes (bh,) or null.
template <int D, class S>
__global__ void __launch_bounds__(S::kThreads, F32<D, S, kFwd>::kBlocks)
flash_fwd_tile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                      const float* __restrict__ slopes, int nq, int nk, int causal, int q_off,
                      float scale) {
  using P = F32<D, S, kFwd>;
  constexpr int BM = P::kRows, BN = P::kTile, T = P::kThreads, G = P::kG, R = P::kR;
  constexpr int DP = P::kDp, SN = P::kSN, NC = P::kNC, LD = P::kLd, LDP = P::kLdP;
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
    stage_tile_async<D, BN, T, DP>(bufs + (t % P::kBufs) * P::kStage, k + kb + (size_t)kv0 * D,
                                   min(BN, nk - kv0));
  };
  auto stage_v = [&](int t) {
    const int kv0 = t * BN;
    stage_tile_async<D, BN, T, DP>(bufs + (t % P::kBufs) * P::kStage + BN * LD,
                                   v + kb + (size_t)kv0 * D, min(BN, nk - kv0));
  };

  if (n_tiles > 0) {
    stage_tile_async<D, BM, T, DP>(qs, q + qb + (size_t)r0 * D, min(BM, nq - r0));
    cp_async_commit();
    stage_k(0);
    if (P::kBufs == 2) stage_v(0);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's part of Q is here: scale it in float32
    scale_own_chunks<DP, BM, T>(qs, scale);
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
    tile_abt<R, SN, G, DP, LD, LD>(s, qs + gy * LD, ks + lx * LD);

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
        if (DP != D && 4 * lx + 32 * c >= D) continue;  // a zero-filled column of the padding
        *reinterpret_cast<float4*>(o + qb + (size_t)row * D + 4 * lx + 32 * c) =
            make_float4(acc[i][4 * c] / l_safe, acc[i][4 * c + 1] / l_safe,
                        acc[i][4 * c + 2] / l_safe, acc[i][4 * c + 3] / l_safe);
      }
      if (lx == 0) lse[(size_t)bh * nq + row] = m[i] + logf(l_safe);
    }
  }
}

// Launch the forward with block shape S on stream s; cudaGetLastError()
// says whether the block's shared memory was granted and the launch taken.
template <int D, class S>
void launch_fwd_tile(const float* q, const float* k, const float* v, float* o, float* lse,
                     const float* slopes, int bh, int nq, int nk, int causal, int q_off,
                     float scale, cudaStream_t s) {
  using P = F32<D, S, kFwd>;
  if (cudaFuncSetAttribute(flash_fwd_tile_kernel<D, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           P::kSmem) != cudaSuccess) {
    return;
  }
  flash_fwd_tile_kernel<D, S><<<dim3(bh, (nq + P::kRows - 1) / P::kRows), P::kThreads, P::kSmem, s>>>(
      q, k, v, o, lse, slopes, nq, nk, causal, q_off, scale);
}

}  // namespace
