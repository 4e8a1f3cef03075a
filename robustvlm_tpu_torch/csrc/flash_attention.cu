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
// shared memory in tiles, of the shapes of Bf16Fwd, F32Tile and mma_bf16.cuh.
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
//   CUDA cores (fma_tile.cuh; the forward in attn_f32_tile.cuh, which the
//   float32 ViT forward launches too). Bound: operations, 4*nq*nk*D
//   (forward) and 10*nq*nk*D (backward) per head, halved when causal, at
//   the card's float32 FMA rate; the two-kernel backward recomputes S and
//   dP in each kernel, 14*nq*nk*D in all. Once every FMA takes an operand
//   from shared memory, the shared-memory pipe is the nearer limit: a
//   warp's 16-byte load costs 2 cycles of it at best. What the design does
//   about it: every product of a tile is a small matrix product in
//   registers (a thread holds a micro-tile of S or dP and one of the
//   accumulator: 8 to 13 FMAs for each 16-byte load, and a lane layout that
//   keeps every load at 2 cycles, fma_tile.cuh), with no shuffle per dot
//   product: row max, row sum and delta are reduced once a tile over the 8
//   lanes of a row. P and dS pass between a tile's two products through a
//   padded shared tile, within one warp. The streamed tiles come in by
//   16-byte cp.async while the tile before them is computed (two buffers;
//   in the forward at D = 128 one buffer each for K and V, which take
//   turns, so that two blocks fit an SM); ragged tails are zero-filled. One
//   online-softmax update per tile; tiles wholly below the diagonal skip
//   the mask; the longest causal blocks are launched first. Shared rows are
//   padded, not swizzled (D + 4 floats, tile + 8 for P and dS): fma_tile.cuh
//   says why no warp load has a bank conflict.
// - bfloat16 forward: wgmma and TMA (wgmma_bf16.cuh). Bound: bytes at these
//   sequence lengths (q, k, v, o read or written once; chip_smoke.py
//   computes it as bound_ms). A block is one warpgroup of 128 threads that
//   owns 64 query rows, the longest causal blocks first. One thread issues
//   every copy: Q once, then K and V tiles of kN keys into a ring of
//   kStages stages, each completing on its mbarrier, so the next tiles
//   land while this one is computed; 3-D tensor maps over (D, n, bh) let
//   the hardware zero-fill rows past n, and 128-byte boxes with the
//   128-byte swizzle feed wgmma without bank conflicts (D = 128 is two
//   boxes a tile). Per tile: S = (Q scale) K^T with Q and K from shared
//   memory (q scaled in bf16 in place once); one online-softmax update on
//   the accumulator in registers (two rows a thread, quad shuffles; the
//   mask only on tiles that cross the diagonal or the key end, masked
//   scores -inf so that P = 0 exactly; exp2 with log2(e) folded in); P
//   rounded to bf16 and re-packed in registers as the A operand of O += P V
//   (V read MN-major with the transpose bit); a stage is refilled only
//   after every warp's products on it are done. The tensor maps are
//   encoded on the host for each call (cuTensorMapEncodeTiled through the
//   runtime, no -lcuda). No warp specialisation: the softmax does not
//   overlap the products of the same block.
// - bfloat16 backward: tensor cores through mma.sync m16n8k16 (mma_bf16.cuh),
//   four warps of 16 rows. Scores, P and dS stay in registers. The kernels
//   keep their block's own operands (Q and dO for dQ, K and V for dK/dV) in
//   shared memory and read A fragments from there one k-step at a time: at
//   D = 128 the dK and dV accumulators alone take 128 registers a thread.
//   Bound: bytes. Loads are synchronous (no cp.async/TMA pipeline) and the
//   products are not wgmma: later work.

#include <math.h>

#include "attn_f32_tile.cuh"
#include "fma_tile.cuh"
#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

// ============================================= float32: register-tiled FMA
// The forward kernel, the masks and the shape arithmetic F32<D, S, Kind>:
// attn_f32_tile.cuh (shared with vit_attention.cu).
//
// Block shape per head dim and kernel: kRows rows of the block's own side
// (queries; keys in dK/dV), kTile rows of the streamed side per
// shared-memory tile, kThreads threads, kBufs buffers for the streamed tiles
// (2: tile t + 1 is copied while tile t is computed; 1: the copy waits for
// the tile's last product, except in the forward, where K and V take turns
// in a buffer each). Chosen on the card by
// scripts/sweep_flash_fp32_torch.py, which rewrites these lines.
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

template <int D, int Kind>
using F32F = F32<D, F32Tile<D, Kind>, Kind>;

// dQ over query tiles; also writes delta = rowsum(dO * O) for the dK/dV
// kernel. Q and dO of the block are staged once; per key tile S = Q K^T and
// dP = dO V^T in micro-tiles, dS through shared memory, dQ += dS K.
template <int D>
__global__ void __launch_bounds__(F32F<D, kDq>::kThreads, F32F<D, kDq>::kBlocks)
flash_bwd_dq_tile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ o,
                         const float* __restrict__ lse, const float* __restrict__ dout,
                         const float* __restrict__ slopes, float* __restrict__ dq,
                         float* __restrict__ delta, int nq, int nk, int causal, int q_off,
                         float scale) {
  using P = F32F<D, kDq>;
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
__global__ void __launch_bounds__(F32F<D, kDkv>::kThreads, F32F<D, kDkv>::kBlocks)
flash_bwd_dkv_tile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ lse,
                          const float* __restrict__ delta, const float* __restrict__ dout,
                          const float* __restrict__ slopes, float* __restrict__ dk,
                          float* __restrict__ dv, int nq, int nk, int causal, int q_off,
                          float scale) {
  using P = F32F<D, kDkv>;
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
// Forward: wgmma + TMA (wgmma_bf16.cuh). One warpgroup (4 warps, 128
// threads) owns 64 query rows; K and V tiles of kN keys stream through a
// ring of kStages stages. Tile shape per head dim, chosen on the card by
// scripts/sweep_flash_bf16_torch.py, which rewrites these lines.
template <int D>
struct Bf16Fwd;
template <>
struct Bf16Fwd<64> { static constexpr int kN = 64, kStages = 2; };
template <>
struct Bf16Fwd<128> { static constexpr int kN = 64, kStages = 2; };

template <int D>
struct WgFwd : Bf16Fwd<D> {
  using S = Bf16Fwd<D>;
  static constexpr int kRows = 64;                  // query rows of a block
  static constexpr int kThreads = 128;              // one warpgroup
  static constexpr int kBoxes = D / 64;             // 64-column (128-byte) boxes of a row
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = S::kN * D * 2;  // K or V of a tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  // 1 KB of slack to put the tiles on a 1024-byte boundary, then Q, the
  // stages and their mbarriers (one a stage, one for Q)
  static constexpr int kSmem = 1024 + kQBytes + S::kStages * kStageBytes + 8 * (S::kStages + 1);
  static_assert(D % 64 == 0 && (S::kN == 64 || S::kN == 128), "tiles of whole boxes, N 64 or 128");
  static_assert(S::kStages >= 1 && kSmem <= 227 * 1024, "a block may take 227 KB of shared memory");
};

template <int D>
__global__ void __launch_bounds__(WgFwd<D>::kThreads)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                       float* __restrict__ lse, const float* __restrict__ slopes, int nq, int nk,
                       int causal, int q_off, float scale) {
  using P = WgFwd<D>;
  constexpr int BN = P::kN, NS = P::kStages;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* stages = qs + P::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + NS * P::kStageBytes);  // a stage's K, V
  uint64_t* qbar = full + NS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * P::kRows;  // the longest blocks start first
  const int row0 = r0 + warp * 16;
  const float slope = slopes ? slopes[bh] : 0.f;
  const int n_tiles = (key_end(r0, P::kRows, nk, causal, q_off) + BN - 1) / BN;

  float acc[D / 2];  // O: d[4 j + c] = (row g or g + 8, column 8 j + 2 t + (c & 1))
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};  // rows g, g + 8

  if (n_tiles > 0) {  // else no key is visible: O = 0, lse = -1e30
    // Thread 0 issues every copy: tile t goes to stage t % NS, its barrier's
    // (t / NS)-th phase completes when both tiles have landed.
    auto load_tile = [&](int tile) {
      unsigned char* ks = stages + (tile % NS) * P::kStageBytes;
      uint64_t* bar = &full[tile % NS];
      mbar_arrive_expect_tx(bar, P::kStageBytes);
#pragma unroll
      for (int b = 0; b < P::kBoxes; ++b) {
        tma_load_3d(ks + b * BN * 128, &kmap, bar, 64 * b, tile * BN, bh);
        tma_load_3d(ks + P::kTileBytes + b * BN * 128, &vmap, bar, 64 * b, tile * BN, bh);
      }
    };
    if (threadIdx.x == 0) {
      for (int s = 0; s < NS; ++s) mbar_init(&full[s], 1);
      mbar_init(qbar, 1);
      mbar_init_fence();
      mbar_arrive_expect_tx(qbar, P::kQBytes);
#pragma unroll
      for (int b = 0; b < P::kBoxes; ++b) tma_load_3d(qs + b * 64 * 128, &qmap, qbar, 64 * b, r0, bh);
      for (int s = 0; s < NS && s < n_tiles; ++s) load_tile(s);
    }
    __syncthreads();  // the barriers are initialised

    // q scaled in bf16 before the product (the exact product rounded once),
    // in place, 16 bytes a thread at a time; then handed to the async proxy
    // that wgmma reads shared memory through
    const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
    mbar_wait(qbar, 0);
    for (int c = threadIdx.x; c < P::kQBytes / 16; c += P::kThreads) {
      uint4* p = reinterpret_cast<uint4*>(qs + 16 * c);
      uint4 x = *p;
      x.x = pack_bf16(bf16_lo(x.x) * scale_t, bf16_hi(x.x) * scale_t);
      x.y = pack_bf16(bf16_lo(x.y) * scale_t, bf16_hi(x.y) * scale_t);
      x.z = pack_bf16(bf16_lo(x.z) * scale_t, bf16_hi(x.z) * scale_t);
      x.w = pack_bf16(bf16_lo(x.w) * scale_t, bf16_hi(x.w) * scale_t);
      *p = x;
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t qaddr = smem_u32(qs);

    for (int tile = 0; tile < n_tiles; ++tile) {
      const int kv0 = tile * BN;
      const uint32_t ks = smem_u32(stages + (tile % NS) * P::kStageBytes);
      const uint32_t vs = ks + P::kTileBytes;
      mbar_wait(&full[tile % NS], (tile / NS) & 1);

      // S = (Q scale) K^T, both from shared memory, both K-major: D / 16
      // k-steps, 4 per 128-byte box
      float s[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<BN>(s, wgmma_desc(qaddr + (kk / 4) * P::kRows * 128 + (kk % 4) * 32, 16, 1024),
                     wgmma_desc(ks + (kk / 4) * BN * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // One online-softmax update. Masked scores become -inf: they never
      // raise the max (which starts at -1e30) and give P = 0 exactly.
      const bool whole = kv0 + BN <= nk && (!causal || kv0 + BN - 1 <= r0 + q_off);
      float mx[2] = {kNegBig, kNegBig};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = row0 + g + (c >> 1) * 8, col = kv0 + 8 * j + 2 * t + (c & 1);
          float x = s[4 * j + c];
          if (slopes) x = alibi(x, slope, row, col);
          if (!whole && !visible(row, col, nq, nk, causal, q_off)) x = -INFINITY;
          s[4 * j + c] = x;
          mx[c >> 1] = fmaxf(mx[c >> 1], x);
        }
      }
      float alpha[2], ml[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        alpha[h] = exp2f((m[h] - m_new) * kLog2e);
        m[h] = m_new;
        ml[h] = m_new * kLog2e;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      uint32_t pa[BN / 16][4];  // P rounded to bf16: the A fragments of O += P V
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float p[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) p[c] = exp2f(fmaf(s[4 * j + c], kLog2e, -ml[c >> 1]));
        l[0] += p[0] + p[1];
        l[1] += p[2] + p[3];
        pa[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }

      // O += P V: P from registers, V MN-major (the transpose bit), BN / 16
      // k-steps of 16 keys
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wgmma_rs<D, 1>(acc, pa[kk], wgmma_desc(vs + kk * 16 * 128, BN * 128, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);

      __syncthreads();  // every warp's products of this stage are done: refill it
      if (threadIdx.x == 0 && tile + NS < n_tiles) load_tile(tile + NS);
    }
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lh = quad_sum(l[h]);
    const float ls = lh == 0.f ? 1.f : lh;
    inv[h] = 1.f / ls;
    const int row = row0 + g + h * 8;
    if (row < nq && t == 0) lse[(size_t)bh * nq + row] = m[h] + logf(ls);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + h * 8;
    if (row >= nq) continue;
    bf16* dst = o + ((size_t)bh * nq + row) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(acc[4 * j + 2 * h] * inv[h], acc[4 * j + 2 * h + 1] * inv[h]);
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

// cudaGetLastError() after the launch; cudaErrorInvalidValue, with no
// launch tried, if a tensor map could not be encoded.
template <int D>
int launch_fwd(int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
               const float* slopes, int bh, int nq, int nk, int causal, int q_off, float scale,
               cudaStream_t s) {
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    using T = float;
    launch_fwd_tile<D, F32Tile<D, kFwd>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(o), l, slopes,
                                         bh, nq, nk, causal, q_off, scale, s);
    return static_cast<int>(cudaGetLastError());
  }
  // The tensor maps are encoded on the host for every call (under a us;
  // scripts/probe_wgmma_torch.py times it) and passed by value.
  using P = WgFwd<D>;
  CUtensorMap qm, km, vm;
  if (!make_map_3d(&qm, q, D, nq, bh, P::kRows) || !make_map_3d(&km, k, D, nk, bh, P::kN) ||
      !make_map_3d(&vm, v, D, nk, bh, P::kN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (allow_smem(flash_fwd_wgmma_kernel<D>, P::kSmem)) {
    flash_fwd_wgmma_kernel<D><<<dim3(bh, (nq + P::kRows - 1) / P::kRows), P::kThreads, P::kSmem, s>>>(
        qm, km, vm, static_cast<bf16*>(o), l, slopes, nq, nk, causal, q_off, scale);
  }
  return static_cast<int>(cudaGetLastError());
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
    using PQ = F32F<D, kDq>;
    using PK = F32F<D, kDkv>;
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
// unsupported dtype or head dim, or a bf16 tensor map that could not be
// encoded).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, const void* slopes, int bh, int nq, int nk, int d,
                              int dtype, int causal, int q_off, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sl = static_cast<const float*>(slopes);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64: return launch_fwd<64>(dtype, q, k, v, o, lse, sl, bh, nq, nk, causal, q_off, scale, s);
    case 128: return launch_fwd<128>(dtype, q, k, v, o, lse, sl, bh, nq, nk, causal, q_off, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
