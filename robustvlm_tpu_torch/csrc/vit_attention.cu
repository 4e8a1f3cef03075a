// Exact non-causal softmax attention for ViT shapes on Hopper, forward and
// backward.
//
// Replaces robustvlm_tpu/ops/pallas/vit_attention.py: _vit_attn_fwd (kernel
// body _fwd_kernel) and _vit_attn_bwd (_bwd_kernel). Layout (B, H, N, D):
// in bfloat16 each operand with its own strides (its head dim contiguous),
// in float32 contiguous; float32 softmax and sums.
//
// What it computes is the Pallas kernels' function, not their tiling. The
// TPU kernel holds the whole (N, N) float32 score tile of several heads in
// VMEM; at N = 257 or 577 that is far beyond the 227 KB a block may use
// here. So the forward is flash-style: one block per (head, query-row
// tile), looping over K/V tiles staged in shared memory, with a float32
// running max and sum per row. It keeps the same residuals
// (O and lse = m + log l). The backward recomputes P = exp(S - lse) and is
// deterministic without atomics: dQ in one kernel over query tiles, dK and
// dV in another over key tiles; delta = rowsum(dO * O) is written by the dQ
// kernel and read by the dK/dV kernel, launched after it on the same stream.
//
// Numerics, as in the TPU kernel:
// - q is scaled in its own dtype before Q K^T in the forward; the backward
//   scales the float32 product instead (vit_attention.py:66 and :98-100);
// - columns past the sequence are masked to -1e30 before the row max, so
//   the zero scores of padding never anchor the max (a row whose true
//   scores all sit below exp's underflow point then stays finite);
// - P (and dS) are rounded to the operand dtype before their products.
//
// Two implementations of that function:
// - float32 (the CLI's default dtype; no TF32, so no tensor cores), on the
//   CUDA cores: the register-tiled kernels of attn_f32_tile.cuh, the flash
//   kernels' own, launched non-causal with no slopes (the two functions
//   agree bit for bit in their plain versions). Bound: operations,
//   4*B*H*N^2*D forward and 10*B*H*N^2*D backward at the card's float32 FMA
//   rate (the two-kernel backward recomputes S and dP: 14*B*H*N^2*D). Every
//   product is a small matrix product in registers fed by 16-byte
//   shared-memory loads; the streamed tiles (K and V; Q and dO with their
//   lse and delta rows in dK/dV) come in by cp.async while the tile before
//   them is computed; one softmax update a tile in the forward, P and dS
//   through a padded shared tile within a warp. Head dims 80 and 88 are
//   staged into 96-float shared rows, zero-filled past D. Block shapes
//   (VitF32Tile below) from scripts/sweep_vit_attention_fp32_torch.py at the
//   ViT-L/14 shape (and ViT-g/14's for head dim 88).
// - bfloat16, on the tensor cores: the wgmma + TMA kernels that the flash
//   attention's bf16 path launches too, non-causal with no slopes. Bound:
//   bytes (q, k, v, o read or written once: about 16.8 MB forward at B*H =
//   128, N = 257, D = 64; chip_smoke.py computes it as bound_ms).
//   - forward: attn_bf16_fwd.cuh. A warpgroup owns 64 query rows; K and V
//     tiles stream through a TMA ring past its Q; S = (Q scale) K^T takes
//     both operands from shared memory; P is re-packed in registers as the
//     A operand of O += P V, which runs at N = D (80 and 88 are wgmma
//     shapes of their own); only the last key tile, the ragged one, is masked.
//   - backward: attn_bf16_bwd.cuh. K and V (Q and dO) tiles stream through
//     a TMA ring past a block's Q and dO (K and V); both score products
//     take their operands from shared memory; dS and P are re-packed in
//     registers as the A operand of the gradient products.
//   Head dims 80 and 88 are mapped as D columns and read as two 64-column
//   boxes, zero-filled past D (S and dP take 6 k-steps at 88, the last over
//   zeros of both operands). At N = 257 the ragged tail decides the tile shape
//   (VitBf16Fwd, VitBf16Bwd below).

#include <math.h>

#include "attn_bf16_bwd.cuh"
#include "attn_bf16_fwd.cuh"
#include "attn_f32_tile.cuh"

namespace {

// ================================================================= float32
// The register-tiled kernels of attn_f32_tile.cuh, non-causal, with their
// own block shape per head dim and kernel (kRows rows of the block's own
// side: queries, keys in dK/dV; kTile rows of the streamed side per
// shared-memory tile; kThreads threads; kBufs buffers; the same meaning as
// F32Tile in flash_attention.cu). Chosen on the card at the ViT-L/14 shape
// by scripts/sweep_vit_attention_fp32_torch.py, which rewrites these lines.
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
// The wgmma + TMA kernels of attn_bf16_fwd.cuh (forward) and
// attn_bf16_bwd.cuh (backward), non-causal, with their own tile shape per
// head dim; head dims 80 and 88 run in 128-wide tiles, zero past D. Forward: kN
// keys a tile, kStages ring stages (a block is one warpgroup of 64 query
// rows); chosen on the card at each head dim's shape (ViT-L/14's; ViT-g/14's
// for 88, where a third stage takes 7% off) by
// scripts/sweep_flash_bf16_torch.py --vit, which rewrites these lines.
template <int D>
struct VitBf16Fwd;
template <>
struct VitBf16Fwd<64> { static constexpr int kN = 64, kStages = 2; };
template <>
struct VitBf16Fwd<80> { static constexpr int kN = 32, kStages = 2; };
template <>
struct VitBf16Fwd<88> { static constexpr int kN = 32, kStages = 3; };

// Backward: kN keys a tile in dQ, kM queries a tile in dK/dV, kStages ring
// stages. Chosen on the card by scripts/sweep_attention_bf16_bwd_torch.py,
// which rewrites these lines.
template <int D>
struct VitBf16Bwd;
template <>
struct VitBf16Bwd<64> { static constexpr int kN = 32, kM = 64, kStages = 2; };
template <>
struct VitBf16Bwd<80> { static constexpr int kN = 64, kM = 64, kStages = 2; };
template <>
struct VitBf16Bwd<88> { static constexpr int kN = 64, kM = 64, kStages = 2; };

// ================================================================= launches
// Over (batch, heads, n, D) operands with element strides st (q, k, v, o):
// any strides in bf16, those of contiguous arrays in float32. Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue, with no launch
// tried, for float32 strides of another layout or a bf16 tensor map that
// could not be encoded.
template <int D>
int launch_fwd(int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
               const Bhn* st, int batch, int heads, int n, float scale, cudaStream_t s) {
  if (dtype == 0) {
    for (int i = 0; i < 4; ++i) {
      if (!packed(st[i], heads, n, D)) return static_cast<int>(cudaErrorInvalidValue);
    }
    launch_fwd_tile<D, VitF32Tile<D, kFwd>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                      static_cast<const float*>(v), static_cast<float*>(o),
                                      static_cast<float*>(lse), nullptr, batch * heads, n, n, 0, 0,
                                      scale, s);
    return static_cast<int>(cudaGetLastError());
  }
  return launch_fwd_wgmma<D, VitBf16Fwd<D>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                            static_cast<const bf16*>(v), static_cast<bf16*>(o),
                                            static_cast<float*>(lse), nullptr, st, batch, heads, n,
                                            n, 0, 0, scale, s);
}

// As launch_fwd, st over q, k, v, o, dO, dQ, dK, dV.
template <int D>
int launch_bwd(int dtype, const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, void* dq, void* dk, void* dv, void* delta,
               const Bhn* st, int batch, int heads, int n, float scale, cudaStream_t s) {
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0) {
    for (int i = 0; i < 8; ++i) {
      if (!packed(st[i], heads, n, D)) return static_cast<int>(cudaErrorInvalidValue);
    }
    using T = float;
    launch_bwd_tile<D, VitF32Tile<D, kDq>, VitF32Tile<D, kDkv>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), l, static_cast<const T*>(dout), nullptr, static_cast<T*>(dq),
        static_cast<T*>(dk), static_cast<T*>(dv), dl, batch * heads, n, n, 0, 0, scale, s);
    return static_cast<int>(cudaGetLastError());
  }
  using T = bf16;
  return launch_bwd_wgmma<D, VitBf16Bwd<D>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), l, static_cast<const T*>(dout), nullptr, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), dl, st, batch, heads, n, n, 0, 0, scale, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Head dims 64, 80 and 88. q, k, v, o are
// (batch, heads, n, d) device arrays, 16-byte aligned, with element strides
// (batch, head, row: multiples of 8; the head dim contiguous) in
// strides[0..11], q, k, v, o in turn; contiguous in float32. lse (batch *
// heads, n) float32. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported dtype, head dim or float32
// layout, or a bf16 tensor map that could not be encoded).
extern "C" int vit_attn_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, int batch, int heads, int n, int d, int dtype, float scale,
                            const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bhn* st = reinterpret_cast<const Bhn*>(strides);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64: return launch_fwd<64>(dtype, q, k, v, o, lse, st, batch, heads, n, scale, s);
    case 80: return launch_fwd<80>(dtype, q, k, v, o, lse, st, batch, heads, n, scale, s);
    case 88: return launch_fwd<88>(dtype, q, k, v, o, lse, st, batch, heads, n, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// delta is (batch * heads, n) float32 scratch; dq, dk, dv as q. strides[0..23]:
// q, k, v, o, dout, dq, dk, dv.
extern "C" int vit_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* lse, const void* dout, void* dq, void* dk,
                            void* dv, void* delta, int batch, int heads, int n, int d, int dtype,
                            float scale, const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bhn* st = reinterpret_cast<const Bhn*>(strides);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64:
      return launch_bwd<64>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta, st, batch, heads, n,
                            scale, s);
    case 80:
      return launch_bwd<80>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta, st, batch, heads, n,
                            scale, s);
    case 88:
      return launch_bwd<88>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta, st, batch, heads, n,
                            scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
