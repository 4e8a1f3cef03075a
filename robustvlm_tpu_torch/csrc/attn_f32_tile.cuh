// The float32 attention kernels on the CUDA cores, shared by attention.cu's
// flash launches (causal or not, ALiBi, any nq and nk) and ViT launches
// (non-causal, nq = nk, no slopes): the forward, and the backward's dQ and
// dK/dV kernels. Both compute the same function (attention.cu's header says
// which), each table set with its own block shapes. Also the masks that
// every float32 and bfloat16 attention kernel applies.
//
// The design (fma_tile.cuh has the products): a block owns kRows rows of
// its own side (queries; keys in dK/dV) and walks the tiles of the other
// side that its mask can reach. Forward, per key tile: S = (Q scale) K^T in
// register micro-tiles, one online-softmax update (row max over the 8
// lanes of a row, alpha rescales the accumulator once), P through shared
// memory, O += P V. dQ, per key tile: S = Q K^T and dP = dO V^T, dS through
// shared memory, dQ += dS K; it also writes delta = rowsum(dO * O). dK/dV,
// per query tile (with its lse and delta rows): S^T = K Q^T and dP^T = V
// dO^T, P^T and dS^T through shared memory, dV += P^T dO and dK += dS^T Q.
// The streamed tiles come in by 16-byte cp.async while the tile before
// them is computed; tiles wholly inside the mask skip it; the longest
// causal blocks are launched first.
//
// Head dims that are not a multiple of 32 (ViT-H's 80) are staged into
// shared rows of DP = D rounded up to 32 floats, zero-filled past D: the
// products over the head dim (S, dP and their transposes) stop at D; the
// zero columns give zero columns of O, dQ, dK and dV, which are not stored,
// and delta sums the D real columns only. Rows of D floats in device memory
// stay 16-byte aligned for any D that is a multiple of 4.

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


// dQ over query tiles; also writes delta = rowsum(dO * O) for the dK/dV
// kernel. Q and dO of the block are staged once; per key tile S = Q K^T and
// dP = dO V^T in micro-tiles, dS through shared memory, dQ += dS K. Grid
// (bh, row blocks), arguments as the forward's.
template <int D, class S>
__global__ void __launch_bounds__(S::kThreads, F32<D, S, kDq>::kBlocks)
flash_bwd_dq_tile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ o,
                         const float* __restrict__ lse, const float* __restrict__ dout,
                         const float* __restrict__ slopes, float* __restrict__ dq,
                         float* __restrict__ delta, int nq, int nk, int causal, int q_off,
                         float scale) {
  using P = F32<D, S, kDq>;
  constexpr int BM = P::kRows, BN = P::kTile, T = P::kThreads, G = P::kG, R = P::kR;
  constexpr int DP = P::kDp, SN = P::kSN, NC = P::kNC, LD = P::kLd, LDP = P::kLdP;
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
    stage_tile_async<D, BN, T, DP>(ks, k + kb + (size_t)kv0 * D, valid);
    stage_tile_async<D, BN, T, DP>(ks + BN * LD, v + kb + (size_t)kv0 * D, valid);
    cp_async_commit();
  };

  if (n_tiles > 0) {
    stage_tile_async<D, BM, T, DP>(qs, q + qb + (size_t)r0 * D, min(BM, nq - r0));
    stage_tile_async<D, BM, T, DP>(dos, dout + qb + (size_t)r0 * D, min(BM, nq - r0));
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
        if (DP != D && 4 * lx + 32 * c >= D) continue;  // past the row
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
      if (DP != D && 4 * lx + 32 * c >= D) continue;  // a zero-filled column of the padding
      *reinterpret_cast<float4*>(dq + qb + (size_t)row * D + 4 * lx + 32 * c) =
          make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2], acc[i][4 * c + 3]);
    }
  }
}

// dK and dV over key tiles: K and V of the block's kRows keys are staged
// once; per query tile (with its lse and delta rows) S^T = K Q^T and dP^T =
// V dO^T in micro-tiles whose rows are keys, P^T and dS^T through shared
// memory, dV += P^T dO and dK += dS^T Q. Grid (bh, key blocks).
template <int D, class S>
__global__ void __launch_bounds__(S::kThreads, F32<D, S, kDkv>::kBlocks)
flash_bwd_dkv_tile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ lse,
                          const float* __restrict__ delta, const float* __restrict__ dout,
                          const float* __restrict__ slopes, float* __restrict__ dk,
                          float* __restrict__ dv, int nq, int nk, int causal, int q_off,
                          float scale) {
  using P = F32<D, S, kDkv>;
  constexpr int BK = P::kRows, BQ = P::kTile, T = P::kThreads, G = P::kG, R = P::kR;
  constexpr int DP = P::kDp, SN = P::kSN, NC = P::kNC, LD = P::kLd, LDP = P::kLdP;
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
    stage_tile_async<D, BQ, T, DP>(qsb, q + qb + (size_t)q0 * D, valid);
    stage_tile_async<D, BQ, T, DP>(qsb + BQ * LD, dout + qb + (size_t)q0 * D, valid);
    stage_row_async<T>(qsb + 2 * BQ * LD, lse + (size_t)bh * nq + q0, BQ, valid);
    stage_row_async<T>(qsb + 2 * BQ * LD + BQ, delta + (size_t)bh * nq + q0, BQ, valid);
    cp_async_commit();
  };

  if (n_tiles > 0) {
    stage_tile_async<D, BK, T, DP>(ks, k + kb + (size_t)k0 * D, min(BK, nk - k0));
    stage_tile_async<D, BK, T, DP>(vs, v + kb + (size_t)k0 * D, min(BK, nk - k0));
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
      if (DP != D && 4 * lx + 32 * c >= D) continue;  // a zero-filled column of the padding
      const size_t at = kb + (size_t)key * D + 4 * lx + 32 * c;
      *reinterpret_cast<float4*>(dk + at) =
          make_float4(dka[i][4 * c], dka[i][4 * c + 1], dka[i][4 * c + 2], dka[i][4 * c + 3]);
      *reinterpret_cast<float4*>(dv + at) =
          make_float4(dva[i][4 * c], dva[i][4 * c + 1], dva[i][4 * c + 2], dva[i][4 * c + 3]);
    }
  }
}

// Launch the backward, dQ then dK/dV on stream s (the dK/dV kernel reads
// the delta that the dQ kernel writes), with block shapes SQ and SK.
template <int D, class SQ, class SK>
void launch_bwd_tile(const float* q, const float* k, const float* v, const float* o,
                     const float* lse, const float* dout, const float* slopes, float* dq, float* dk,
                     float* dv, float* delta, int bh, int nq, int nk, int causal, int q_off,
                     float scale, cudaStream_t s) {
  using PQ = F32<D, SQ, kDq>;
  using PK = F32<D, SK, kDkv>;
  if (cudaFuncSetAttribute(flash_bwd_dq_tile_kernel<D, SQ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, PQ::kSmem) != cudaSuccess ||
      cudaFuncSetAttribute(flash_bwd_dkv_tile_kernel<D, SK>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, PK::kSmem) != cudaSuccess) {
    return;
  }
  flash_bwd_dq_tile_kernel<D, SQ><<<dim3(bh, (nq + PQ::kRows - 1) / PQ::kRows), PQ::kThreads,
                                    PQ::kSmem, s>>>(q, k, v, o, lse, dout, slopes, dq, delta, nq,
                                                    nk, causal, q_off, scale);
  if (cudaPeekAtLastError() != cudaSuccess) return;
  flash_bwd_dkv_tile_kernel<D, SK><<<dim3(bh, (nk + PK::kRows - 1) / PK::kRows), PK::kThreads,
                                     PK::kSmem, s>>>(q, k, v, lse, delta, dout, slopes, dk, dv, nq,
                                                     nk, causal, q_off, scale);
}

}  // namespace
