// Attention on Hopper, forward and backward: the flash attention (causal or
// not, optional ALiBi slopes, key lengths that need not be a multiple of any
// tile) and the exact non-causal ViT self-attention, through one C interface.
//
// Replaces robustvlm_tpu/ops/pallas/flash_attention.py: _flash_fwd (kernel
// body _fwd_kernel) and the two pallas_calls of _flash_bwd (_bwd_dq_kernel,
// _bwd_dkv_kernel); and robustvlm_tpu/ops/pallas/vit_attention.py:
// _vit_attn_fwd (_fwd_kernel) and _vit_attn_bwd (_bwd_kernel). The ViT
// function is the flash function with causal off, no slopes and nq = nk (the
// two agree bit for bit in their plain versions), so every kernel serves
// both. What a launch takes from the JAX function it is the counterpart of
// is its table set (`tables` below), each tuned on the card at its own
// traffic: 0 = flash, head dims 64 (CLIP text tower), 80 (OPT-2.7B in
// BLIP-2) and 128 (LLaMA-7B); 1 = ViT, head dims 64, 80 and 88 (CLIP ViT
// towers, ViT-H/14, EVA ViT-g/14). Layout (B, H, N, D), q (B, H, nq, D), k
// and v (B, H, nk, D): in bfloat16 each operand with its own strides (its
// head dim contiguous), in float32 contiguous; float32 softmax and sums.
//
// The function is the Pallas kernels', not their tiling: the TPU keeps a
// whole K/V row in VMEM and walks 128-key blocks, and its ViT kernel holds
// the whole (N, N) float32 score tile of several heads in VMEM; at N = 257
// or 577 that is far beyond the 227 KB a block may use here. So each block
// owns a tile of query rows (of keys in dK/dV) and streams the other side
// through shared memory in tiles, with a float32 running max and sum per
// row, of the shapes of the tables below. It keeps the same residuals (O
// and lse = m + log l).
//
// Semantics, as the Pallas kernels and the public functions compute them:
// - forward: q scaled in its own dtype before Q K^T (vit_attention.py:66);
//   ALiBi subtracts slope * (row - col) after the scale; then the mask (col
//   < nk, and for causal col <= row + q_off) sets scores to -1e30 before the
//   row max, so the zero scores of padding never anchor the max (a row whose
//   true scores all sit below exp's underflow point then stays finite); P
//   (rounded to v's dtype) times V; l = 0 guarded; lse = m + log l.
// - backward: S = Q K^T in float32, then times scale (q is NOT pre-scaled
//   here, unlike the forward; vit_attention.py:98-100); P = exp(S - lse), 0
//   where masked; delta = rowsum(dO * O) in float32; dS = P (dP - delta)
//   scale; dS rounded to k's dtype for dQ and q's for dK, P to dO's for dV.
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
// - float32 (the CLI's default dtype; no TF32, so no tensor cores):
//   register-tiled FMA kernels on the CUDA cores (fma_tile.cuh; the kernels
//   in attn_f32_tile.cuh). Bound: operations, 4*nq*nk*D (forward) and
//   10*nq*nk*D (backward) per head, halved when causal, at the card's
//   float32 FMA rate; the two-kernel backward recomputes S and dP in each
//   kernel, 14*nq*nk*D in all. Once every FMA takes an operand from shared
//   memory, the shared-memory pipe is the nearer limit: a warp's 16-byte
//   load costs 2 cycles of it at best. What the design does about it: every
//   product of a tile is a small matrix product in registers (a thread holds
//   a micro-tile of S or dP and one of the accumulator: 8 to 13 FMAs for
//   each 16-byte load, and a lane layout that keeps every load at 2 cycles,
//   fma_tile.cuh), with no shuffle per dot product: row max, row sum and
//   delta are reduced once a tile over the 8 lanes of a row. P and dS pass
//   between a tile's two products through a padded shared tile, within one
//   warp. The streamed tiles (K and V; Q and dO with their lse and delta
//   rows in dK/dV) come in by 16-byte cp.async while the tile before them
//   is computed (two buffers; in the forward at D = 128 one buffer each for
//   K and V, which take turns, so that two blocks fit an SM); ragged tails
//   are zero-filled. One online-softmax update per tile; tiles wholly below
//   the diagonal skip the mask; the longest causal blocks are launched
//   first. Shared rows are padded, not swizzled (D + 4 floats, tile + 8 for
//   P and dS): fma_tile.cuh says why no warp load has a bank conflict. Head
//   dims 80 and 88 are staged into 96-float shared rows, zero-filled past D.
// - bfloat16 forward: wgmma and TMA, in attn_bf16_fwd.cuh (its header has
//   the design). Bound: bytes at these sequence lengths (q, k, v, o read or
//   written once: about 16.8 MB at B*H = 128, N = 257, D = 64; chip_smoke.py
//   computes it as bound_ms). A block is one warpgroup that owns 64 query
//   rows, the longest causal blocks first; K and V tiles stream through a
//   TMA ring past its Q; S = (Q scale) K^T takes both operands from shared
//   memory, P is re-packed in registers as the A operand of O += P V, which
//   runs at N = D (80 and 88 are wgmma shapes of their own); the mask only
//   on tiles that cross the diagonal or the key end (non-causal: only the
//   last key tile, the ragged one).
// - bfloat16 backward: wgmma and TMA, in attn_bf16_bwd.cuh (its header has
//   the design). Bound: bytes. dQ streams K and V tiles past a block's Q and
//   dO, dK/dV streams Q and dO tiles past a block's K and V, each through a
//   TMA ring; S and dP (S^T and dP^T) take both operands from shared memory,
//   dS and P are re-packed in registers as the A operand of dQ += dS K,
//   dV += P^T dO, dK += dS^T Q.
// In bfloat16, head dims 80 and 88 are mapped as D columns and read as two
// 64-column boxes, zero-filled past D (S and dP take 6 k-steps at 88, the
// last over zeros of both operands). At N = 257 the ragged tail decides the
// ViT's tile shapes (VitBf16Fwd, VitBf16Bwd below).

#include <math.h>

#include <type_traits>

#include "attn_bf16_bwd.cuh"
#include "attn_bf16_fwd.cuh"
#include "attn_f32_tile.cuh"

namespace {

// ============================================= float32: register-tiled FMA
// The kernels (forward, dQ, dK/dV), the masks and the shape arithmetic
// F32<D, S, Kind>: attn_f32_tile.cuh.
//
// Block shape per head dim and kernel: kRows rows of the block's own side
// (queries; keys in dK/dV), kTile rows of the streamed side per
// shared-memory tile, kThreads threads, kBufs buffers for the streamed tiles
// (2: tile t + 1 is copied while tile t is computed; 1: the copy waits for
// the tile's last product, except in the forward, where K and V take turns
// in a buffer each).
//
// Flash: chosen on the card by scripts/sweep_flash_fp32_torch.py, which
// rewrites these lines.
template <int D, int Kind>
struct F32Tile;
template <>
struct F32Tile<64, kFwd> { static constexpr int kRows = 32, kTile = 32, kThreads = 64, kBufs = 2; };
template <>
struct F32Tile<64, kDq> { static constexpr int kRows = 32, kTile = 32, kThreads = 64, kBufs = 2; };
template <>
struct F32Tile<64, kDkv> { static constexpr int kRows = 64, kTile = 32, kThreads = 256, kBufs = 2; };
// D = 80 takes the ViT's D = 80 shapes (VitF32Tile below), staged into
// 96-float shared rows, zero past D.
template <>
struct F32Tile<80, kFwd> { static constexpr int kRows = 48, kTile = 48, kThreads = 128, kBufs = 2; };
template <>
struct F32Tile<80, kDq> { static constexpr int kRows = 48, kTile = 24, kThreads = 128, kBufs = 2; };
template <>
struct F32Tile<80, kDkv> { static constexpr int kRows = 48, kTile = 24, kThreads = 128, kBufs = 2; };
template <>
struct F32Tile<128, kFwd> { static constexpr int kRows = 64, kTile = 48, kThreads = 128, kBufs = 1; };
template <>
struct F32Tile<128, kDq> { static constexpr int kRows = 64, kTile = 64, kThreads = 256, kBufs = 2; };
template <>
struct F32Tile<128, kDkv> { static constexpr int kRows = 32, kTile = 32, kThreads = 128, kBufs = 2; };

// ViT: non-causal, chosen on the card at the ViT-L/14 shape (and ViT-g/14's
// for head dim 88) by scripts/sweep_flash_fp32_torch.py --vit, which
// rewrites these lines.
template <int D, int Kind>
struct VitF32Tile;
template <>
struct VitF32Tile<64, kFwd> { static constexpr int kRows = 48, kTile = 48, kThreads = 128, kBufs = 2; };
template <>
struct VitF32Tile<64, kDq> { static constexpr int kRows = 48, kTile = 24, kThreads = 128, kBufs = 2; };
template <>
struct VitF32Tile<64, kDkv> { static constexpr int kRows = 48, kTile = 24, kThreads = 128, kBufs = 2; };
template <>
struct VitF32Tile<80, kFwd> { static constexpr int kRows = 48, kTile = 48, kThreads = 128, kBufs = 2; };
template <>
struct VitF32Tile<80, kDq> { static constexpr int kRows = 48, kTile = 24, kThreads = 128, kBufs = 2; };
template <>
struct VitF32Tile<80, kDkv> { static constexpr int kRows = 48, kTile = 24, kThreads = 128, kBufs = 2; };
template <>
struct VitF32Tile<88, kFwd> { static constexpr int kRows = 48, kTile = 48, kThreads = 128, kBufs = 2; };
template <>
struct VitF32Tile<88, kDq> { static constexpr int kRows = 48, kTile = 24, kThreads = 128, kBufs = 2; };
template <>
struct VitF32Tile<88, kDkv> { static constexpr int kRows = 48, kTile = 24, kThreads = 128, kBufs = 2; };

// ============================================ bfloat16: tensor-core kernels
// Forward: wgmma + TMA (attn_bf16_fwd.cuh). Tile shape per head dim: kN
// keys a tile, kStages ring stages (a block is one warpgroup of 64 query
// rows); head dims 80 and 88 run in 128-wide tiles, zero past D. Chosen on
// the card by scripts/sweep_flash_bf16_torch.py (with --vit: at each head
// dim's ViT shape, ViT-L/14's; ViT-g/14's for 88, where a third stage takes
// 7% off), which rewrites these lines.
template <int D>
struct Bf16Fwd;
template <>
struct Bf16Fwd<64> { static constexpr int kN = 64, kStages = 2; };
template <>
struct Bf16Fwd<80> { static constexpr int kN = 32, kStages = 2; };  // the ViT's D = 80
template <>
struct Bf16Fwd<128> { static constexpr int kN = 64, kStages = 2; };

template <int D>
struct VitBf16Fwd;
template <>
struct VitBf16Fwd<64> { static constexpr int kN = 64, kStages = 2; };
template <>
struct VitBf16Fwd<80> { static constexpr int kN = 32, kStages = 2; };
template <>
struct VitBf16Fwd<88> { static constexpr int kN = 32, kStages = 3; };

// Backward: wgmma + TMA (attn_bf16_bwd.cuh). Tile shape per head dim: kN
// keys a tile in dQ, kM queries a tile in dK/dV, kStages ring stages.
// Chosen on the card by scripts/sweep_attention_bf16_bwd_torch.py, which
// rewrites these lines.
template <int D>
struct Bf16Bwd;
template <>
struct Bf16Bwd<64> { static constexpr int kN = 32, kM = 64, kStages = 2; };
template <>
struct Bf16Bwd<80> { static constexpr int kN = 64, kM = 64, kStages = 2; };  // the ViT's D = 80
template <>
struct Bf16Bwd<128> { static constexpr int kN = 64, kM = 64, kStages = 2; };

template <int D>
struct VitBf16Bwd;
template <>
struct VitBf16Bwd<64> { static constexpr int kN = 32, kM = 64, kStages = 2; };
template <>
struct VitBf16Bwd<80> { static constexpr int kN = 64, kM = 64, kStages = 2; };
template <>
struct VitBf16Bwd<88> { static constexpr int kN = 64, kM = 64, kStages = 2; };

// The two table sets of the interface's `tables`.
struct FlashTables {
  template <int D, int Kind>
  using F32 = F32Tile<D, Kind>;
  template <int D>
  using Fwd = Bf16Fwd<D>;
  template <int D>
  using Bwd = Bf16Bwd<D>;
};
struct VitTables {
  template <int D, int Kind>
  using F32 = VitF32Tile<D, Kind>;
  template <int D>
  using Fwd = VitBf16Fwd<D>;
  template <int D>
  using Bwd = VitBf16Bwd<D>;
};

// f(Tables{}, std::integral_constant<int, D>{}) for a (table set, head dim)
// pair that is built; cudaErrorInvalidValue, with no launch tried, for any
// other.
template <class F>
int dispatch(int tables, int d, F f) {
  using std::integral_constant;
  if (tables == 0) {
    switch (d) {
      case 64: return f(FlashTables{}, integral_constant<int, 64>{});
      case 80: return f(FlashTables{}, integral_constant<int, 80>{});
      case 128: return f(FlashTables{}, integral_constant<int, 128>{});
    }
  } else if (tables == 1) {
    switch (d) {
      case 64: return f(VitTables{}, integral_constant<int, 64>{});
      case 80: return f(VitTables{}, integral_constant<int, 80>{});
      case 88: return f(VitTables{}, integral_constant<int, 88>{});
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ================================================================= launches
// Over (batch, heads, n, D) operands with element strides st (q, k, v, o):
// any strides in bf16, those of contiguous arrays in float32. Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue, with no launch
// tried, for float32 strides of another layout or a bf16 tensor map that
// could not be encoded.
template <int D, class Tables>
int launch_fwd(int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
               const float* slopes, const Bhn* st, int batch, int heads, int nq, int nk,
               int causal, int q_off, float scale, cudaStream_t s) {
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    if (!packed(st[0], heads, nq, D) || !packed(st[1], heads, nk, D) ||
        !packed(st[2], heads, nk, D) || !packed(st[3], heads, nq, D)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    using T = float;
    launch_fwd_tile<D, typename Tables::template F32<D, kFwd>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), l, slopes, batch * heads, nq, nk, causal, q_off, scale, s);
    return static_cast<int>(cudaGetLastError());
  }
  return launch_fwd_wgmma<D, typename Tables::template Fwd<D>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), l, slopes, st, batch, heads, nq, nk, causal, q_off, scale, s);
}

// As launch_fwd, st over q, k, v, o, dO, dQ, dK, dV.
template <int D, class Tables>
int launch_bwd(int dtype, const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, const float* slopes, void* dq, void* dk,
               void* dv, void* delta, const Bhn* st, int batch, int heads, int nq, int nk,
               int causal, int q_off, float scale, cudaStream_t s) {
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0) {
    for (int i = 0; i < 8; ++i) {  // q, o, dO, dQ have nq rows; k, v, dK, dV nk
      const bool keys = i == 1 || i == 2 || i == 6 || i == 7;
      if (!packed(st[i], heads, keys ? nk : nq, D)) return static_cast<int>(cudaErrorInvalidValue);
    }
    using T = float;
    launch_bwd_tile<D, typename Tables::template F32<D, kDq>, typename Tables::template F32<D, kDkv>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), l, static_cast<const T*>(dout), slopes, static_cast<T*>(dq),
        static_cast<T*>(dk), static_cast<T*>(dv), dl, batch * heads, nq, nk, causal, q_off, scale,
        s);
    return static_cast<int>(cudaGetLastError());
  }
  using T = bf16;
  return launch_bwd_wgmma<D, typename Tables::template Bwd<D>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), l, static_cast<const T*>(dout), slopes, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), dl, st, batch, heads, nq, nk, causal, q_off, scale,
      s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. tables: 0 = flash (head dims 64, 80 and
// 128), 1 = ViT (64, 80 and 88). q, o are (batch, heads, nq, d) and k, v
// (batch, heads, nk, d) device arrays, 16-byte aligned, with element strides
// (batch, head, row: multiples of 8; the head dim contiguous) in
// strides[0..11], q, k, v, o in turn; contiguous in float32. lse (batch *
// heads, nq) float32; slopes (batch * heads,) float32 or null (no ALiBi).
// causal: 0 or 1, with the diagonal at col = row + q_off. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported dtype, table set, head dim of that set or float32 layout, or
// a bf16 tensor map that could not be encoded).
extern "C" int attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                        const void* slopes, int batch, int heads, int nq, int nk, int d, int dtype,
                        int causal, int q_off, float scale, int tables, const long long* strides,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sl = static_cast<const float*>(slopes);
  const Bhn* st = reinterpret_cast<const Bhn*>(strides);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(tables, d, [&](auto set, auto dim) {
    return launch_fwd<decltype(dim)::value, decltype(set)>(dtype, q, k, v, o, lse, sl, st, batch,
                                                           heads, nq, nk, causal, q_off, scale, s);
  });
}

// delta is (batch * heads, nq) float32 scratch; dq as q, dk and dv as k.
// strides[0..23]: q, k, v, o, dout, dq, dk, dv.
extern "C" int attn_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* lse, const void* dout, const void* slopes, void* dq, void* dk,
                        void* dv, void* delta, int batch, int heads, int nq, int nk, int d,
                        int dtype, int causal, int q_off, float scale, int tables,
                        const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sl = static_cast<const float*>(slopes);
  const Bhn* st = reinterpret_cast<const Bhn*>(strides);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(tables, d, [&](auto set, auto dim) {
    return launch_bwd<decltype(dim)::value, decltype(set)>(dtype, q, k, v, o, lse, dout, sl, dq,
                                                           dk, dv, delta, st, batch, heads, nq, nk,
                                                           causal, q_off, scale, s);
  });
}
