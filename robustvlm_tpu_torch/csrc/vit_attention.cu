// Exact non-causal softmax attention for ViT shapes on Hopper, forward and
// backward.
//
// Replaces robustvlm_tpu/ops/pallas/vit_attention.py: _vit_attn_fwd (kernel
// body _fwd_kernel) and _vit_attn_bwd (_bwd_kernel). Layout (B*H, N, D),
// contiguous; float32 or bfloat16 operands; float32 softmax and sums.
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
//   through a padded shared tile within a warp. Head dim 80 is staged into
//   96-float shared rows, zero-filled past 80. Block shapes (VitF32Tile
//   below) from scripts/sweep_vit_attention_fp32_torch.py at the ViT-L/14
//   shape.
// - bfloat16, on the tensor cores. Bound: bytes (q, k, v, o read or written
//   once: about 16.8 MB forward at B*H = 128, N = 257, D = 64; chip_smoke.py
//   computes it as bound_ms).
//   - forward: mma.sync m16n8k16 (bf16 operands, float32 accumulators),
//     four warps of 16 rows each. Scores and P stay in registers: a score
//     accumulator fragment is re-packed as the A operand of P V, so no N x N
//     tile touches shared or device memory; V is read with ldmatrix.trans.
//     Loads are synchronous and the products are not wgmma.
//   - backward: the wgmma + TMA kernels of attn_bf16_bwd.cuh, the flash
//     backward's own, launched non-causal with no slopes: K and V (Q and
//     dO) tiles stream through a TMA ring past a block's Q and dO (K and
//     V); both score products take their operands from shared memory; dS
//     and P are re-packed in registers as the A operand of the gradient
//     products. Head dim 80 is mapped as 80 columns and read as two
//     64-column boxes, zero-filled past 80.

#include <math.h>

#include "attn_bf16_bwd.cuh"
#include "attn_f32_tile.cuh"
#include "mma_bf16.cuh"

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

// ============================================ bfloat16: tensor-core kernels
// Forward: mma.sync (fragment layouts and the shared helpers: mma_bf16.cuh).
// Backward: the wgmma + TMA kernels of attn_bf16_bwd.cuh, non-causal, with
// their own tile shape per head dim (kN keys a tile in dQ, kM queries a tile
// in dK/dV, kStages ring stages; head dim 80 runs in 128-wide tiles, zero
// past 80). Chosen on the card by scripts/sweep_attention_bf16_bwd_torch.py,
// which rewrites these lines.
template <int D>
struct VitBf16Bwd;
template <>
struct VitBf16Bwd<64> { static constexpr int kN = 32, kM = 64, kStages = 2; };
template <>
struct VitBf16Bwd<80> { static constexpr int kN = 64, kM = 64, kStages = 2; };

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, int n, float scale) {
  __shared__ __align__(16) bf16 ks[kKv * (D + kPad)];
  __shared__ __align__(16) bf16 vs[kKv * (D + kPad)];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int row0 = blockIdx.y * kMmaRows + warp * 16;
  const size_t base = (size_t)bh * n * D;

  // q scaled in bf16 before the product: the exact product rounded once
  const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
  uint32_t qa[D / 16][4];
  load_a<D>(qa, q + base, row0, n, g, t);
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
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g+8

  for (int kv0 = 0; kv0 < n; kv0 += kKv) {
    const int valid = min(kKv, n - kv0);
    __syncthreads();
    stage_bf16<D>(ks, k + base + (size_t)kv0 * D, valid);
    stage_bf16<D>(vs, v + base + (size_t)kv0 * D, valid);
    __syncthreads();

    float s[8][4];
    mma_abt<D>(s, qa, ks, g, t);
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (j * 8 + 2 * t + (c & 1) >= valid) s[j][c] = kNegBig;  // before the max
        mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = expf(m[h] - m_new);  // 0 on the first tile (m = -inf)
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
      const float p0 = expf(s[j][0] - m[0]), p1 = expf(s[j][1] - m[0]);  // 0 when masked
      const float p2 = expf(s[j][2] - m[1]), p3 = expf(s[j][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pack_a(pa, j, p0, p1, p2, p3);
    }
    mma_ab<D>(acc, pa, vs, lane);
  }

  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  store_rows<D>(o + base, acc, row0, n, g, t, 1.f / l0, 1.f / l1);
  if (t == 0) {
    if (row0 + g < n) lse[(size_t)bh * n + row0 + g] = m[0] + logf(l0);
    if (row0 + g + 8 < n) lse[(size_t)bh * n + row0 + g + 8] = m[1] + logf(l1);
  }
}

// ================================================================= launches
template <int D>
void launch_fwd(int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
                int bh, int n, float scale, cudaStream_t s) {
  if (dtype == 0) {
    launch_fwd_tile<D, VitF32Tile<D, kFwd>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                      static_cast<const float*>(v), static_cast<float*>(o),
                                      static_cast<float*>(lse), nullptr, bh, n, n, 0, 0, scale, s);
  } else {
    fwd_mma_kernel<D><<<dim3(bh, (n + kMmaRows - 1) / kMmaRows), kMmaThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), static_cast<float*>(lse), n, scale);
  }
}

// cudaGetLastError() after the launches; cudaErrorInvalidValue, with no
// launch tried, if a bf16 tensor map could not be encoded.
template <int D>
int launch_bwd(int dtype, const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, void* dq, void* dk, void* dv, void* delta,
               int bh, int n, float scale, cudaStream_t s) {
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0) {
    using T = float;
    launch_bwd_tile<D, VitF32Tile<D, kDq>, VitF32Tile<D, kDkv>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), l, static_cast<const T*>(dout), nullptr, static_cast<T*>(dq),
        static_cast<T*>(dk), static_cast<T*>(dv), dl, bh, n, n, 0, 0, scale, s);
    return static_cast<int>(cudaGetLastError());
  }
  using T = bf16;
  return launch_bwd_wgmma<D, VitBf16Bwd<D>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), l, static_cast<const T*>(dout), nullptr, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), dl, bh, n, n, 0, 0, scale, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Head dims 64 and 80. All arrays are
// contiguous device arrays, 16-byte aligned: q, k, v, o (bh, n, d); lse
// (bh, n) float32. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported dtype or head dim).
extern "C" int vit_attn_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, int bh, int n, int d, int dtype, float scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64: launch_fwd<64>(dtype, q, k, v, o, lse, bh, n, scale, s); break;
    case 80: launch_fwd<80>(dtype, q, k, v, o, lse, bh, n, scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// delta is (bh, n) float32 scratch; dq, dk, dv as q.
extern "C" int vit_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* lse, const void* dout, void* dq, void* dk,
                            void* dv, void* delta, int bh, int n, int d, int dtype,
                            float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64: return launch_bwd<64>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta, bh, n, scale, s);
    case 80: return launch_bwd<80>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta, bh, n, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
