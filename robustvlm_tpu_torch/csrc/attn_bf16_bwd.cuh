// The bfloat16 attention backward on Hopper's tensor cores (wgmma + TMA),
// for attention.cu's flash and ViT launches: dQ in one kernel over query
// blocks (it also writes delta), dK and dV in another over key blocks,
// launched after it on the same stream; deterministic, no atomics.
//
// The function (attention.cu's header): S = Q K^T in float32, then
// times scale (q is not pre-scaled in the backward); ALiBi after the scale;
// P = exp(S - lse), 0 exactly where masked (causal with the diagonal at
// col = row + q_off, keys past nk, queries past nq); delta = rowsum(dO * O)
// in float32; dS = P (dP - delta) scale, rounded to bf16 for dQ = dS K and
// dK = dS^T Q; P rounded to bf16 for dV = P^T dO.
//
// Numerics against the plain version: P is one exp2 with log2(e) folded in
// (as the forward's), and dS = P (dP scale - delta scale): a few float32
// ulps apart, far inside the bf16 limits.
//
// Bound: bytes at these sequence lengths (q, k, v, o, dO read and dq, dk,
// dv written once, with lse and delta; chip_smoke.py computes it). What the
// design does about it, one warpgroup (128 threads) a block of 64 rows:
// - dQ: Q and dO of the block come in by TMA once; K and V tiles of kN
//   keys stream through a ring of kStages stages on mbarriers, so the next
//   tiles land while this one is computed. Per tile, S = Q K^T and dP = dO
//   V^T are wgmma with both operands from swizzled shared memory (SS, both
//   K-major); P and dS are computed on the accumulators in registers (the
//   mask only on tiles that cross the diagonal or an end); dQ += dS K is
//   wgmma with dS re-packed from the accumulator as the A operand in
//   registers (RS) and K read MN-major with the transpose bit: the pattern
//   of the forward's O += P V. Causal blocks stop at the last key tile that
//   reaches their diagonal, the longest blocks first.
// - dK/dV: K and V of the block come in by TMA once; Q and dO tiles of kM
//   queries stream in (their lse and delta rows by cp.async beside them).
//   Per tile, S^T = K Q^T and dP^T = V dO^T are SS; dV += P^T dO and dK +=
//   dS^T Q are RS with dO and Q read MN-major. Causal blocks start at the
//   first query tile that reaches the key block.
// Every score product takes A from shared memory: wgmma_bf16.cuh says why.
// Tried on the card and not kept (PERF.md has the numbers): issuing a tile's
// gradient product back to back with the next tile's score products
// (ptxas injects a warpgroup wait; no gain, more registers) and two
// warpgroups a block sharing the streamed tiles (slower at both shapes).
//
// Operands are addressed through their strides, as in the forward
// (attn_bf16_fwd.cuh): Q, K, V and dO by 4-D tensor maps over (D, n, H, B),
// O and dO's rows for delta and the stores of dQ, dK and dV by their own
// strides, so dQ, dK and dV can land in the column blocks of one fused
// q|k|v gradient. lse and delta stay (B*H, n) float32.
//
// Head dims: tiles are whole 64-column boxes, DT = 64 or 128. A head dim of
// 80 (ViT-H/14) or 88 (ViT-g/14) is mapped as (D, n, H, B) and read as two
// boxes a row; TMA zero-fills columns D-127 of Q, K, V and dO alike, so the
// tile has the D = 128 layout: S and dP take ceil(D / 16) = 5 or 6 k-steps
// (at 88 the sixth reads zeros past column 88 in both operands); dQ, dK and
// dV run at N = 128 on zero columns, which are not stored. A row of 88
// bf16 is 176 bytes, a multiple of 16, as TMA's strides and the 16-byte
// loads of delta need.

#pragma once

#include "attn_f32_tile.cuh"  // the masks, the bf16 helpers, cp.async of lse / delta rows
#include "wgmma_bf16.cuh"

namespace {

// What follows from a tile shape S (kN keys a tile in dQ, kM queries a tile
// in dK/dV, kStages ring stages) and a head dim D.
template <int D, class S>
struct WgBwd : S {
  static constexpr int kRows = 64;                  // the block's own rows
  static constexpr int kThreads = 128;              // one warpgroup
  static constexpr int kDt = D <= 64 ? 64 : 128;    // tile head dim: whole 64-column boxes
  static constexpr int kBoxes = kDt / 64;
  static constexpr int kK = (D + 15) / 16;          // k-steps of the products over the head dim
  static constexpr int kOwnBytes = kRows * kDt * 2;  // Q or dO (K or V) of the block
  static constexpr int kDqStage = 2 * S::kN * kDt * 2;  // K and V of a key tile
  static constexpr int kDkvStage = 2 * S::kM * kDt * 2;  // Q and dO of a query tile
  // 1 KB of slack to put the tiles on a 1024-byte boundary, the own tiles,
  // the stages, float rows (delta of the block's rows; lse and delta of
  // each query tile), the mbarriers (one a stage, one for the own tiles)
  static constexpr int kSmemDq = 1024 + 2 * kOwnBytes + S::kStages * kDqStage + 4 * kRows +
                                 8 * (S::kStages + 1);
  static constexpr int kSmemDkv = 1024 + 2 * kOwnBytes + S::kStages * kDkvStage +
                                  4 * 2 * S::kM * S::kStages + 8 * (S::kStages + 1);
  static_assert(D % 8 == 0 && D <= 128, "head dims of whole 16-byte chunks, up to 128");
  static_assert(S::kN == 32 || S::kN == 64 || S::kN == 128, "key tiles of 32, 64 or 128");
  static_assert(S::kM == 32 || S::kM == 64 || S::kM == 128, "query tiles of 32, 64 or 128");
  static_assert(S::kStages >= 2, "the lse / delta rows of a tile are copied one tile ahead");
  static_assert(kSmemDq <= 227 * 1024 && kSmemDkv <= 227 * 1024,
                "a block may take 227 KB of shared memory");
};

// Store a warpgroup accumulator (64 rows of DT float32 columns, the block's
// rows r0 ..) as bf16 rows of an (n, D) head whose rows lie row_stride
// elements apart, rows < n and columns < D.
template <int D, int DT>
__device__ __forceinline__ void store_acc_bf16(bf16* __restrict__ dst, long long row_stride,
                                               const float (&acc)[DT / 2], int row0, int n, int g,
                                               int t) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row0 + g + e * 8;
    if (row >= n) continue;
    bf16* p = dst + row * row_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < DT / 8; ++j) {
      if (DT != D && 8 * j + 2 * t >= D) continue;  // a zero-filled column of the padding
      *reinterpret_cast<uint32_t*>(p + 8 * j) = pack_bf16(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
    }
  }
}

// P = exp(S scale [- slope (row - col)] - lse) as one exp2 with log2(e)
// folded in (lse_l2e = lse log2 e), 0 where the key is not visible.
__device__ __forceinline__ float prob(float s, float scale, float lse_l2e, bool has_slopes,
                                      float slope, int row, int col, bool vis) {
  if (!vis) return 0.f;
  if (has_slopes) return exp2f(fmaf(alibi(s * scale, slope, row, col), kLog2e, -lse_l2e));
  return exp2f(fmaf(s, scale * kLog2e, -lse_l2e));
}

// dQ over query blocks; also writes delta = rowsum(dO * O) for the dK/dV
// kernel. Grid (B * heads, query blocks). Tensor maps over (D, n, H, B): Q
// and dO with 64-row boxes, K and V with kN-row boxes; O, dO and dQ by
// their strides (o_st, do_st, dq_st).
template <int D, class S>
__global__ void __launch_bounds__(128)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap domap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ o,
                         Bhn o_st, const bf16* __restrict__ dout, Bhn do_st,
                         const float* __restrict__ lse, const float* __restrict__ slopes,
                         bf16* __restrict__ dq, Bhn dq_st, float* __restrict__ delta, int heads,
                         int nq, int nk, int causal, int q_off, float scale) {
  using P = WgBwd<D, S>;
  constexpr int BN = S::kN, NS = S::kStages, DT = P::kDt;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* dos = qs + P::kOwnBytes;
  unsigned char* stages = dos + P::kOwnBytes;
  float* dls = reinterpret_cast<float*>(stages + NS * P::kDqStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(dls + P::kRows);  // a stage's K, V
  uint64_t* own = full + NS;                                        // Q and dO
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / heads, h = bh - b * heads;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * P::kRows;  // the longest blocks start first
  const int row0 = r0 + warp * 16;
  const float slope = slopes ? slopes[bh] : 0.f;
  const int n_tiles = (key_end(r0, P::kRows, nk, causal, q_off) + BN - 1) / BN;

  // Thread 0 issues every copy: tile t goes to stage t % NS, its barrier's
  // (t / NS)-th phase completes when K and V have landed.
  auto load_tile = [&](int tile) {
    unsigned char* ks = stages + (tile % NS) * P::kDqStage;
    uint64_t* bar = &full[tile % NS];
    mbar_arrive_expect_tx(bar, P::kDqStage);
#pragma unroll
    for (int x = 0; x < P::kBoxes; ++x) {
      tma_load_4d(ks + x * BN * 128, &kmap, bar, 64 * x, tile * BN, h, b);
      tma_load_4d(ks + BN * DT * 2 + x * BN * 128, &vmap, bar, 64 * x, tile * BN, h, b);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(&full[s], 1);
    mbar_init(own, 1);
    mbar_init_fence();
    if (n_tiles > 0) {
      mbar_arrive_expect_tx(own, 2 * P::kOwnBytes);
#pragma unroll
      for (int x = 0; x < P::kBoxes; ++x) {
        tma_load_4d(qs + x * P::kRows * 128, &qmap, own, 64 * x, r0, h, b);
        tma_load_4d(dos + x * P::kRows * 128, &domap, own, 64 * x, r0, h, b);
      }
      for (int s = 0; s < NS && s < n_tiles; ++s) load_tile(s);
    }
  }

  // delta of every row (the dK/dV kernel reads it even for a row that sees
  // no key), from device memory while the copies fly: two threads a row,
  // 16 bytes (8 columns) at a time, the first ceil(D / 16) chunks of a row
  // to one and the rest to the other (D / 2 columns each when D / 8 is even;
  // 48 and 40 at D = 88)
  {
    constexpr int kChunks = D / 8, kHalf = (kChunks + 1) / 2;
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    const int row = r0 + r;
    float part = 0.f;
    if (row < nq) {
      const uint4* a =
          reinterpret_cast<const uint4*>(dout + b * do_st.b + h * do_st.h + row * do_st.n) + half * kHalf;
      const uint4* z =
          reinterpret_cast<const uint4*>(o + b * o_st.b + h * o_st.h + row * o_st.n) + half * kHalf;
#pragma unroll
      for (int c = 0; c < kHalf; ++c) {
        if (half * kHalf + c >= kChunks) break;
        const uint4 x = a[c], y = z[c];
        part = fmaf(bf16_lo(x.x), bf16_lo(y.x), part);
        part = fmaf(bf16_hi(x.x), bf16_hi(y.x), part);
        part = fmaf(bf16_lo(x.y), bf16_lo(y.y), part);
        part = fmaf(bf16_hi(x.y), bf16_hi(y.y), part);
        part = fmaf(bf16_lo(x.z), bf16_lo(y.z), part);
        part = fmaf(bf16_hi(x.z), bf16_hi(y.z), part);
        part = fmaf(bf16_lo(x.w), bf16_lo(y.w), part);
        part = fmaf(bf16_hi(x.w), bf16_hi(y.w), part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    dls[r] = part;
    if (half == 0 && row < nq) delta[(size_t)bh * nq + row] = part;
  }
  __syncthreads();  // the barriers are initialised, delta is in shared memory

  // rows g, g + 8 of this warp: delta times scale, lse times log2(e)
  float dls_r[2], lse_r[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row0 + g + e * 8;
    dls_r[e] = dls[warp * 16 + g + e * 8] * scale;
    lse_r[e] = row < nq ? lse[(size_t)bh * nq + row] * kLog2e : 0.f;
  }
  float acc[DT / 2];  // dQ: d[4 j + c] = (row g or g + 8, column 8 j + 2 t + (c & 1))
#pragma unroll
  for (int i = 0; i < DT / 2; ++i) acc[i] = 0.f;

  if (n_tiles > 0) {  // else no key is visible: dQ = 0
    mbar_wait(own, 0);
    const uint32_t qaddr = smem_u32(qs), doaddr = smem_u32(dos);
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int kv0 = tile * BN;
      const uint32_t ks = smem_u32(stages + (tile % NS) * P::kDqStage);
      const uint32_t vs = ks + BN * DT * 2;
      mbar_wait(&full[tile % NS], (tile / NS) & 1);

      // S = Q K^T and dP = dO V^T, both SS, both K-major
      float s[BN / 2], dp[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P::kK; ++kk) {
        wgmma_ss<BN>(s, kmajor_desc(qaddr, P::kRows, kk), kmajor_desc(ks, BN, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < P::kK; ++kk) {
        wgmma_ss<BN>(dp, kmajor_desc(doaddr, P::kRows, kk), kmajor_desc(vs, BN, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // dS = P (dP scale - delta scale), rounded to bf16: the A fragments of dS K
      const bool whole = kv0 + BN <= nk && (!causal || kv0 + BN - 1 <= r0 + q_off);
      uint32_t dsa[BN / 16][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = row0 + g + (c >> 1) * 8, col = kv0 + 8 * j + 2 * t + (c & 1);
          const float p = prob(s[4 * j + c], scale, lse_r[c >> 1], slopes != nullptr, slope, row,
                               col, whole || visible(row, col, nq, nk, causal, q_off));
          ds[c] = p * fmaf(dp[4 * j + c], scale, -dls_r[c >> 1]);
        }
        dsa[j / 2][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[j / 2][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dQ += dS K: dS from registers, K MN-major (the transpose bit)
      fence_regs(acc);
      fence_regs(dsa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<DT, 1>(acc, dsa[kk], mnmajor_desc(ks, BN, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);

      __syncthreads();  // every warp's products of this stage are done: refill it
      if (threadIdx.x == 0 && tile + NS < n_tiles) load_tile(tile + NS);
    }
  }
  store_acc_bf16<D, DT>(dq + b * dq_st.b + h * dq_st.h, dq_st.n, acc, row0, nq, g, t);
}

// dK and dV over key blocks: S^T = K Q^T and dP^T = V dO^T, so the block's
// 64 keys are the rows of every product. Grid (B * heads, key blocks).
// Tensor maps over (D, n, H, B): K and V with 64-row boxes, Q and dO with
// kM-row boxes; dK and dV stored by their strides (dk_st, dv_st).
template <int D, class S>
__global__ void __launch_bounds__(128)
attn_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap domap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const float* __restrict__ lse,
                          const float* __restrict__ delta, const float* __restrict__ slopes,
                          bf16* __restrict__ dk, Bhn dk_st, bf16* __restrict__ dv, Bhn dv_st,
                          int heads, int nq, int nk, int causal, int q_off, float scale) {
  using P = WgBwd<D, S>;
  constexpr int BM = S::kM, NS = S::kStages, DT = P::kDt;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* vs = ks + P::kOwnBytes;
  unsigned char* stages = vs + P::kOwnBytes;
  float* rows = reinterpret_cast<float*>(stages + NS * P::kDkvStage);  // lse, delta a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + 2 * BM * NS);    // a stage's Q, dO
  uint64_t* own = full + NS;                                            // K and V
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / heads, h = bh - b * heads;
  const int k0 = blockIdx.y * P::kRows;  // the first key blocks see the most queries
  const int key0 = k0 + warp * 16;
  const float slope = slopes ? slopes[bh] : 0.f;
  const int q_begin = query_start(k0, BM, causal, q_off);
  const int n_tiles = q_begin < nq ? (nq - q_begin + BM - 1) / BM : 0;

  auto load_tile = [&](int tile) {  // thread 0: Q and dO of a query tile by TMA
    unsigned char* qsb = stages + (tile % NS) * P::kDkvStage;
    uint64_t* bar = &full[tile % NS];
    const int q0 = q_begin + tile * BM;
    mbar_arrive_expect_tx(bar, P::kDkvStage);
#pragma unroll
    for (int x = 0; x < P::kBoxes; ++x) {
      tma_load_4d(qsb + x * BM * 128, &qmap, bar, 64 * x, q0, h, b);
      tma_load_4d(qsb + BM * DT * 2 + x * BM * 128, &domap, bar, 64 * x, q0, h, b);
    }
  };
  // every thread: its part of the tile's lse and delta rows by cp.async
  // (rows of floats are only 4-byte aligned), one commit group a tile
  auto load_rows = [&](int tile) {
    if (tile < n_tiles) {
      const int q0 = q_begin + tile * BM, valid = min(BM, nq - q0);
      float* r = rows + (tile % NS) * 2 * BM;
      stage_row_async<P::kThreads>(r, lse + (size_t)bh * nq + q0, BM, valid);
      stage_row_async<P::kThreads>(r + BM, delta + (size_t)bh * nq + q0, BM, valid);
    }
    cp_async_commit();
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(&full[s], 1);
    mbar_init(own, 1);
    mbar_init_fence();
    if (n_tiles > 0) {
      mbar_arrive_expect_tx(own, 2 * P::kOwnBytes);
#pragma unroll
      for (int x = 0; x < P::kBoxes; ++x) {
        tma_load_4d(ks + x * P::kRows * 128, &kmap, own, 64 * x, k0, h, b);
        tma_load_4d(vs + x * P::kRows * 128, &vmap, own, 64 * x, k0, h, b);
      }
      for (int s = 0; s < NS && s < n_tiles; ++s) load_tile(s);
    }
  }
  for (int s = 0; s < NS; ++s) load_rows(s);
  cp_async_wait<NS - 1>();  // this thread's rows of tile 0
  __syncthreads();          // the barriers are initialised, tile 0's rows visible to all

  float dka[DT / 2], dva[DT / 2];
#pragma unroll
  for (int i = 0; i < DT / 2; ++i) dka[i] = dva[i] = 0.f;

  if (n_tiles > 0) {  // else no query sees these keys: dK = dV = 0
    mbar_wait(own, 0);
    const uint32_t kaddr = smem_u32(ks), vaddr = smem_u32(vs);
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int q0 = q_begin + tile * BM;
      const uint32_t qsb = smem_u32(stages + (tile % NS) * P::kDkvStage);
      const uint32_t dosb = qsb + BM * DT * 2;
      const float* lses = rows + (tile % NS) * 2 * BM;
      const float* dls = lses + BM;
      mbar_wait(&full[tile % NS], (tile / NS) & 1);

      // S^T = K Q^T and dP^T = V dO^T, both SS, both K-major
      float st[BM / 2], dpt[BM / 2];
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) st[i] = dpt[i] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P::kK; ++kk) {
        wgmma_ss<BM>(st, kmajor_desc(kaddr, P::kRows, kk), kmajor_desc(qsb, BM, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < P::kK; ++kk) {
        wgmma_ss<BM>(dpt, kmajor_desc(vaddr, P::kRows, kk), kmajor_desc(dosb, BM, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T, rounded to bf16: the A fragments of P^T dO and dS^T Q
      const bool whole =
          q0 + BM <= nq && k0 + P::kRows <= nk && (!causal || k0 + P::kRows - 1 <= q0 + q_off);
      uint32_t pa[BM / 16][4], dsa[BM / 16][4];
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        // lse and delta of this thread's two query columns 8 j + 2 t, + 1
        const float2 l2 = *reinterpret_cast<const float2*>(lses + 8 * j + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t);
        float p[4], ds[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = key0 + g + (c >> 1) * 8, qi = 8 * j + 2 * t + (c & 1);
          p[c] = prob(st[4 * j + c], scale, ((c & 1) ? l2.y : l2.x) * kLog2e, slopes != nullptr,
                      slope, q0 + qi, key, whole || visible(q0 + qi, key, nq, nk, causal, q_off));
          ds[c] = p[c] * ((dpt[4 * j + c] - ((c & 1) ? d2.y : d2.x)) * scale);
        }
        pa[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        dsa[j / 2][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[j / 2][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T dO and dK += dS^T Q: A from registers, dO and Q MN-major
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(dsa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        wgmma_rs<DT, 1>(dva, pa[kk], mnmajor_desc(dosb, BM, kk), 1);
        wgmma_rs<DT, 1>(dka, dsa[kk], mnmajor_desc(qsb, BM, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);

      cp_async_wait<NS - 2>();  // this thread's rows of tile + 1
      __syncthreads();  // every warp is done with this stage, and tile + 1's rows are visible
      if (threadIdx.x == 0 && tile + NS < n_tiles) load_tile(tile + NS);
      load_rows(tile + NS);
    }
  }
  store_acc_bf16<D, DT>(dk + b * dk_st.b + h * dk_st.h, dk_st.n, dka, key0, nk, g, t);
  store_acc_bf16<D, DT>(dv + b * dv_st.b + h * dv_st.h, dv_st.n, dva, key0, nk, g, t);
}

// Launch the backward, dQ then dK/dV on stream s, with tile shape S, over
// (batch, heads, n, D) operands with element strides st[0..7] (q, k, v, o,
// dO, dQ, dK, dV). The tensor maps are encoded on the host for every call
// and passed by value. Returns cudaGetLastError() after the launches;
// cudaErrorInvalidValue, with no launch tried, if a tensor map could not be
// encoded.
template <int D, class S>
int launch_bwd_wgmma(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                     const float* lse, const bf16* dout, const float* slopes, bf16* dq, bf16* dk,
                     bf16* dv, float* delta, const Bhn* st, int batch, int heads, int nq, int nk,
                     int causal, int q_off, float scale, cudaStream_t s) {
  using P = WgBwd<D, S>;
  const int H = heads, B = batch;
  CUtensorMap q64, do64, k64, v64, kn, vn, qm, dom;
  bool ok = make_map_4d(&q64, q, D, nq, H, B, st[0], 64) &&
            make_map_4d(&do64, dout, D, nq, H, B, st[4], 64) &&
            make_map_4d(&k64, k, D, nk, H, B, st[1], 64) &&
            make_map_4d(&v64, v, D, nk, H, B, st[2], 64);
  if constexpr (S::kN == 64) {
    kn = k64;
    vn = v64;
  } else {
    ok = ok && make_map_4d(&kn, k, D, nk, H, B, st[1], S::kN) &&
         make_map_4d(&vn, v, D, nk, H, B, st[2], S::kN);
  }
  if constexpr (S::kM == 64) {
    qm = q64;
    dom = do64;
  } else {
    ok = ok && make_map_4d(&qm, q, D, nq, H, B, st[0], S::kM) &&
         make_map_4d(&dom, dout, D, nq, H, B, st[4], S::kM);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  static const bool smem_ok = allow_smem(attn_bwd_dq_wgmma_kernel<D, S>, P::kSmemDq) &&
                              allow_smem(attn_bwd_dkv_wgmma_kernel<D, S>, P::kSmemDkv);
  if (smem_ok) {
    attn_bwd_dq_wgmma_kernel<D, S>
        <<<dim3(B * H, (nq + P::kRows - 1) / P::kRows), P::kThreads, P::kSmemDq, s>>>(
            q64, do64, kn, vn, o, st[3], dout, st[4], lse, slopes, dq, st[5], delta, H, nq, nk,
            causal, q_off, scale);
    if (cudaPeekAtLastError() == cudaSuccess) {
      attn_bwd_dkv_wgmma_kernel<D, S>
          <<<dim3(B * H, (nk + P::kRows - 1) / P::kRows), P::kThreads, P::kSmemDkv, s>>>(
              qm, dom, k64, v64, lse, delta, slopes, dk, st[6], dv, st[7], H, nq, nk, causal,
              q_off, scale);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
