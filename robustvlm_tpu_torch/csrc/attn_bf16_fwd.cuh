// The bfloat16 attention forward on Hopper's tensor cores (wgmma + TMA), for
// attention.cu's flash launches (causal or not, ALiBi, key padding; head
// dims 64, 80 and 128) and ViT launches (non-causal, nq = nk, no slopes;
// head dims 64, 80 and 88). Each table set has its own tile shapes.
//
// The function (attention.cu's header): q scaled in bf16 before
// S = Q K^T (the exact product rounded once); ALiBi subtracts slope * (row -
// col) after the scale; masked scores (col >= nk, and col > row + q_off when
// causal) never raise the row max and give P = 0 exactly; float32 softmax
// and sums; P rounded to bf16 before O += P V; lse = m + log l, with l = 0
// guarded (a row with no visible key gives O = 0 and lse = -1e30). The ViT
// forward's plain version is this function with causal off and no slopes,
// bit for bit (tests/test_torch_vit_attention.py holds the two plain
// versions equal in both dtypes).
//
// Bound: bytes at these sequence lengths (q, k, v, o read or written once;
// chip_smoke.py computes it as bound_ms). What the design does about it:
// - A block is one warpgroup of 128 threads owning 64 query rows; the
//   longest causal blocks start first. One thread issues every copy: Q once,
//   then K and V tiles of kN keys into a ring of kStages stages, each
//   completing on its mbarrier, so the next tiles land while this one is
//   computed. 4-D tensor maps over (D, n, H, B), each with its operand's
//   own strides, let the hardware zero-fill rows past n and, at head dims
//   80 and 88, columns D-127 (whatever the strides put there: the next
//   head's columns in a token-major array); 128-byte boxes
//   with the 128-byte swizzle feed wgmma without bank conflicts. A tile is
//   kDt = 64 or 128 columns wide: one box, or two (D = 80, 88 and 128).
// - Per tile: S = (Q scale) K^T with Q and K from shared
//   memory, ceil(D / 16) k-steps (5 at D = 80, 6 at D = 88, whose last
//   one reads the zero fill of both operands past column 88); one
//   online-softmax update on the
//   accumulator in registers (two rows a thread, quad shuffles; the mask
//   only on tiles that cross the diagonal or the key end; exp2 with log2(e)
//   folded in); P rounded to bf16 and re-packed in registers as the A
//   operand of O += P V, which runs at N = D (wgmma's n = 80 and n = 88
//   are shapes of their own: columns D-127 are never computed or stored), V
//   read MN-major with the transpose bit. A stage is refilled only after every warp of
//   the block is done with it.
// - No branch around a wgmma, and no warp specialisation: the softmax does
//   not overlap the block's own products, only those of the other blocks on
//   the SM.
// - Operands are addressed through their strides (Bhn, wgmma_bf16.cuh): q,
//   k and v may be head views into a fused q|k|v projection, and O is
//   stored as its strides say (token-major, (B, n, H, D), for the callers),
//   so no caller copies heads apart or back together. A 128-byte box row is
//   128 contiguous bytes whatever the row stride. lse stays (B*H, n).
// The tensor maps are encoded on the host for each call
// (cuTensorMapEncodeTiled through the runtime, no -lcuda).

#pragma once

#include <math.h>

#include "attn_f32_tile.cuh"  // the masks, the bf16 helpers
#include "wgmma_bf16.cuh"

namespace {

// What follows from a tile shape S (kN keys a tile, kStages ring stages)
// and a head dim D.
template <int D, class S>
struct WgFwd : S {
  static constexpr int kRows = 64;  // query rows of a block: one warpgroup
  static constexpr int kThreads = 128;
  static constexpr int kDt = D <= 64 ? 64 : 128;  // tile head dim: whole 64-column boxes
  static constexpr int kBoxes = kDt / 64;
  static constexpr int kQBytes = kRows * kDt * 2;
  static constexpr int kTileBytes = S::kN * kDt * 2;  // K or V of a tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  // 1 KB of slack to put the tiles on a 1024-byte boundary, then Q, the
  // stages and their mbarriers (one a stage, one for Q)
  static constexpr int kSmem = 1024 + kQBytes + S::kStages * kStageBytes + 8 * (S::kStages + 1);
  static constexpr int kK = (D + 15) / 16;  // k-steps of S = Q K^T over the head dim
  static_assert(D % 8 == 0 && D <= 128 && (D % 64 == 0 || D == 80 || D == 88),
                "head dims whose P V has a wgmma: 64, 80, 88, 128");
  static_assert(S::kN == 32 || S::kN == 64 || S::kN == 128, "key tiles of 32, 64 or 128");
  static_assert(S::kStages >= 1 && kSmem <= 227 * 1024, "a block may take 227 KB of shared memory");
};

// Grid (B * heads, query blocks). Tensor maps over (D, n, H, B): Q with
// 64-row boxes, K and V with kN-row boxes. O (strides o_st) and lse (B*H, nq).
template <int D, class S>
__global__ void __launch_bounds__(WgFwd<D, S>::kThreads)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, Bhn o_st,
                      float* __restrict__ lse, const float* __restrict__ slopes, int heads,
                      int nq, int nk, int causal, int q_off, float scale) {
  using P = WgFwd<D, S>;
  constexpr int BN = S::kN, NS = S::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* stages = qs + P::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + NS * P::kStageBytes);  // a stage's K, V
  uint64_t* qbar = full + NS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / heads, h = bh - b * heads;
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
      for (int x = 0; x < P::kBoxes; ++x) {
        tma_load_4d(ks + x * BN * 128, &kmap, bar, 64 * x, tile * BN, h, b);
        tma_load_4d(ks + P::kTileBytes + x * BN * 128, &vmap, bar, 64 * x, tile * BN, h, b);
      }
    };
    if (threadIdx.x == 0) {
      for (int s = 0; s < NS; ++s) mbar_init(&full[s], 1);
      mbar_init(qbar, 1);
      mbar_init_fence();
      mbar_arrive_expect_tx(qbar, P::kQBytes);
#pragma unroll
      for (int x = 0; x < P::kBoxes; ++x) tma_load_4d(qs + x * 64 * 128, &qmap, qbar, 64 * x, r0, h, b);
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

      // S = (Q scale) K^T, both from shared memory, both K-major: ceil(D /
      // 16) k-steps, 4 per 128-byte box (at D = 88 the sixth one spans
      // columns 88-95, zero in both Q and K)
      float s[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P::kK; ++kk) {
        wgmma_ss<BN>(s, kmajor_desc(qaddr, 64, kk), kmajor_desc(ks, BN, kk), kk > 0);
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
      for (int e = 0; e < 2; ++e) {
        const float m_new = fmaxf(m[e], quad_max(mx[e]));
        alpha[e] = exp2f((m[e] - m_new) * kLog2e);
        m[e] = m_new;
        ml[e] = m_new * kLog2e;
        l[e] *= alpha[e];
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
      // k-steps of 16 keys, N = D
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wgmma_rs<D, 1>(acc, pa[kk], mnmajor_desc(vs, BN, kk), 1);
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
  for (int e = 0; e < 2; ++e) {
    const float le = quad_sum(l[e]);
    const float ls = le == 0.f ? 1.f : le;
    inv[e] = 1.f / ls;
    const int row = row0 + g + e * 8;
    if (row < nq && t == 0) lse[(size_t)bh * nq + row] = m[e] + logf(ls);
  }
  bf16* ob = o + b * o_st.b + h * o_st.h;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row0 + g + e * 8;
    if (row >= nq) continue;
    bf16* dst = ob + row * o_st.n + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(acc[4 * j + 2 * e] * inv[e], acc[4 * j + 2 * e + 1] * inv[e]);
    }
  }
}

// Launch the forward on stream s with tile shape S over (batch, heads, n,
// D) operands with element strides st[0..3] (q, k, v, o). The tensor maps
// are encoded on the host for every call (under a us;
// scripts/probe_wgmma_torch.py times it) and passed by value; the
// shared-memory opt-in is set once an instantiation. Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue, with no
// launch tried, if a tensor map could not be encoded.
template <int D, class S>
int launch_fwd_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                     const float* slopes, const Bhn* st, int batch, int heads, int nq, int nk,
                     int causal, int q_off, float scale, cudaStream_t s) {
  using P = WgFwd<D, S>;
  CUtensorMap qm, km, vm;
  if (!make_map_4d(&qm, q, D, nq, heads, batch, st[0], P::kRows) ||
      !make_map_4d(&km, k, D, nk, heads, batch, st[1], S::kN) ||
      !make_map_4d(&vm, v, D, nk, heads, batch, st[2], S::kN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const bool smem_ok = allow_smem(attn_fwd_wgmma_kernel<D, S>, P::kSmem);
  if (smem_ok) {
    attn_fwd_wgmma_kernel<D, S>
        <<<dim3(batch * heads, (nq + P::kRows - 1) / P::kRows), P::kThreads, P::kSmem, s>>>(
            qm, km, vm, o, st[3], lse, slopes, heads, nq, nk, causal, q_off, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
