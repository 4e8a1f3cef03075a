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
// shared memory in tiles, of the shapes of Bf16Fwd, Bf16Bwd and F32Tile.
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
//   CUDA cores (fma_tile.cuh; the kernels in attn_f32_tile.cuh, which the
//   float32 ViT attention launches too). Bound: operations, 4*nq*nk*D
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
// - bfloat16 backward: wgmma and TMA, in attn_bf16_bwd.cuh (which the bf16
//   ViT backward launches too; its header has the design). Bound: bytes.
//   dQ streams K and V tiles past a block's Q and dO, dK/dV streams Q and
//   dO tiles past a block's K and V, each through a TMA ring; S and dP (S^T
//   and dP^T) take both operands from shared memory, dS and P are re-packed
//   in registers as the A operand of dQ += dS K, dV += P^T dO, dK += dS^T Q.

#include <math.h>

#include "attn_bf16_bwd.cuh"
#include "attn_f32_tile.cuh"
#include "wgmma_bf16.cuh"

namespace {

// ============================================= float32: register-tiled FMA
// The kernels (forward, dQ, dK/dV), the masks and the shape arithmetic
// F32<D, S, Kind>: attn_f32_tile.cuh (shared with vit_attention.cu).
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

// Backward: wgmma + TMA (attn_bf16_bwd.cuh, shared with vit_attention.cu).
// Tile shape per head dim: kN keys a tile in dQ, kM queries a tile in
// dK/dV, kStages ring stages. Chosen on the card by
// scripts/sweep_attention_bf16_bwd_torch.py, which rewrites these lines.
template <int D>
struct Bf16Bwd;
template <>
struct Bf16Bwd<64> { static constexpr int kN = 32, kM = 64, kStages = 2; };
template <>
struct Bf16Bwd<128> { static constexpr int kN = 64, kM = 64, kStages = 2; };

template <int D>
__global__ void __launch_bounds__(WgFwd<D>::kThreads)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                       float* __restrict__ lse, const float* __restrict__ slopes, int nq, int nk,
                       int causal, int q_off, float scale) {
  using P = WgFwd<D>;
  constexpr int BN = P::kN, NS = P::kStages;
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
        wgmma_ss<BN>(s, kmajor_desc(qaddr, P::kRows, kk), kmajor_desc(ks, BN, kk), kk > 0);
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

// ================================================================= launches
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

// cudaGetLastError() after the launches; cudaErrorInvalidValue, with no
// launch tried, if a bf16 tensor map could not be encoded.
template <int D>
int launch_bwd(int dtype, const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, const float* slopes, void* dq, void* dk,
               void* dv, void* delta, int bh, int nq, int nk, int causal, int q_off, float scale,
               cudaStream_t s) {
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0) {
    using T = float;
    launch_bwd_tile<D, F32Tile<D, kDq>, F32Tile<D, kDkv>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), l, static_cast<const T*>(dout), slopes, static_cast<T*>(dq),
        static_cast<T*>(dk), static_cast<T*>(dv), dl, bh, nq, nk, causal, q_off, scale, s);
    return static_cast<int>(cudaGetLastError());
  }
  using T = bf16;
  return launch_bwd_wgmma<D, Bf16Bwd<D>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), l, static_cast<const T*>(dout), slopes, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), dl, bh, nq, nk, causal, q_off, scale, s);
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
      return launch_bwd<64>(dtype, q, k, v, o, lse, dout, sl, dq, dk, dv, delta, bh, nq, nk,
                            causal, q_off, scale, s);
    case 128:
      return launch_bwd<128>(dtype, q, k, v, o, lse, dout, sl, dq, dk, dv, delta, bh, nq, nk,
                             causal, q_off, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
