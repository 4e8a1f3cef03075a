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
// here. So the forward is flash-style: one block per (head, 64-row query
// tile), looping over 64-key K/V tiles staged in shared memory, with a
// float32 running max and sum per row. It keeps the same residuals
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
// - float32 (the CLI's default dtype; no TF32, so no tensor cores): CUDA-core
//   FMA loops. Two threads share a row (D/2 columns each, one warp shuffle
//   per dot product); rows of K, V, Q or dO are broadcast from shared
//   memory. Two beat four (fewer shuffles) and one (dK/dV spills registers):
//   scripts/sweep_vit_attention_fp32_torch.py.
//   Bound: operations, 4*B*H*N^2*D forward and 10*B*H*N^2*D backward at the
//   card's float32 FMA rate.
// - bfloat16: tensor cores through mma.sync m16n8k16 (bf16 operands, float32
//   accumulators), four warps of 16 rows each. Scores, P and dS stay in
//   registers: a score accumulator fragment is re-packed as the A operand of
//   the next product (P V, dS K, ...), so no N x N tile touches shared or
//   device memory. Operands that a product needs transposed are read with
//   ldmatrix.trans. Bound: bytes (q, k, v, o read or written once: about
//   16.8 MB forward at B*H = 128, N = 257, D = 64; chip_smoke.py computes
//   it as bound_ms). Loads are synchronous
//   (no cp.async/TMA pipeline) and the products are not wgmma: later work.

#include <math.h>

#include "mma_bf16.cuh"

namespace {

// ====================================================== float32: FMA kernels
constexpr int kTpr = 2;               // threads per row
constexpr int kRows = 64;             // rows (queries or keys) per block
constexpr int kTile = 64;             // rows per shared-memory tile
constexpr int kThreads = kRows * kTpr;
constexpr int kChunk = 16;            // keys per online-softmax update

// Sum over the kTpr consecutive lanes that share a row; every lane gets the
// same bits (a + b == b + a in floating point).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = kTpr / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage `valid` rows of a (rows, D) slab into shared memory; the rest of the
// tile is zero.
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int valid) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    dst[e] = (e / D) < valid ? src[e] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int n, float scale) {
  constexpr int kD = D / kTpr;
  __shared__ float ks[kTile * D];
  __shared__ float vs[kTile * D];
  const int bh = blockIdx.x;
  const int row = blockIdx.y * kRows + threadIdx.x / kTpr;
  const int c0 = (threadIdx.x % kTpr) * kD;
  const bool live = row < n;
  const size_t base = (size_t)bh * n * D;

  float qr[kD], acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = live ? __fmul_rn(q[base + (size_t)row * D + c0 + d], scale) : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int kv0 = 0; kv0 < n; kv0 += kTile) {
    const int valid = min(kTile, n - kv0);
    __syncthreads();
    stage_f32<D>(ks, k + base + (size_t)kv0 * D, valid);
    stage_f32<D>(vs, v + base + (size_t)kv0 * D, valid);
    __syncthreads();
    for (int j0 = 0; j0 < valid; j0 += kChunk) {
      float s[kChunk];
      float cmax = kNegBig;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* kr = ks + (j0 + j) * D + c0;
        float part = 0.f;
#pragma unroll
        for (int d = 0; d < kD; ++d) part = fmaf(qr[d], kr[d], part);
        const float full = row_sum(part);  // every lane of the warp shuffles
        const float sj = j0 + j < valid ? full : kNegBig;
        s[j] = sj;
        cmax = fmaxf(cmax, sj);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);  // 0 on the first chunk (m = -inf)
      l *= alpha;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(s[j] - m_new);  // exactly 0 for masked columns
        l += p;
        const float* vr = vs + (j0 + j) * D + c0;
#pragma unroll
        for (int d = 0; d < kD; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
      }
      m = m_new;
    }
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < kD; ++d) o[base + (size_t)row * D + c0 + d] = acc[d] / l;
    if (c0 == 0) lse[(size_t)bh * n + row] = m + logf(l);
  }
}

// dQ over query tiles; also writes delta = rowsum(dO * O) for the dK/dV kernel.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ lse, const float* __restrict__ dout,
                  float* __restrict__ dq, float* __restrict__ delta, int n, float scale) {
  constexpr int kD = D / kTpr;
  __shared__ float ks[kTile * D];
  __shared__ float vs[kTile * D];
  const int bh = blockIdx.x;
  const int row = blockIdx.y * kRows + threadIdx.x / kTpr;
  const int c0 = (threadIdx.x % kTpr) * kD;
  const bool live = row < n;
  const size_t base = (size_t)bh * n * D;

  float qr[kD], dor[kD], acc[kD];
  float dpart = 0.f;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    const size_t at = base + (size_t)row * D + c0 + d;
    qr[d] = live ? q[at] : 0.f;
    dor[d] = live ? dout[at] : 0.f;
    dpart = fmaf(dor[d], live ? o[at] : 0.f, dpart);
    acc[d] = 0.f;
  }
  const float dl = row_sum(dpart);
  const float lse_r = live ? lse[(size_t)bh * n + row] : 0.f;
  if (live && c0 == 0) delta[(size_t)bh * n + row] = dl;

  for (int kv0 = 0; kv0 < n; kv0 += kTile) {
    const int valid = min(kTile, n - kv0);
    __syncthreads();
    stage_f32<D>(ks, k + base + (size_t)kv0 * D, valid);
    stage_f32<D>(vs, v + base + (size_t)kv0 * D, valid);
    __syncthreads();
    for (int j = 0; j < valid; ++j) {
      const float* kr = ks + j * D + c0;
      const float* vr = vs + j * D + c0;
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        sp = fmaf(qr[d], kr[d], sp);
        dpp = fmaf(dor[d], vr[d], dpp);
      }
      const float s = __fmul_rn(row_sum(sp), scale);
      const float p = expf(s - lse_r);
      const float dp = row_sum(dpp);
      const float ds = __fmul_rn(__fmul_rn(p, dp - dl), scale);
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
    }
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < kD; ++d) dq[base + (size_t)row * D + c0 + d] = acc[d];
  }
}

// dK and dV over key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ lse,
                   const float* __restrict__ delta, const float* __restrict__ dout,
                   float* __restrict__ dk, float* __restrict__ dv, int n, float scale) {
  constexpr int kD = D / kTpr;
  __shared__ float qs[kTile * D];
  __shared__ float dos[kTile * D];
  __shared__ float lses[kTile];
  __shared__ float dls[kTile];
  const int bh = blockIdx.x;
  const int row = blockIdx.y * kRows + threadIdx.x / kTpr;  // key index
  const int c0 = (threadIdx.x % kTpr) * kD;
  const bool live = row < n;
  const size_t base = (size_t)bh * n * D;

  float kr[kD], vr[kD], dka[kD], dva[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    const size_t at = base + (size_t)row * D + c0 + d;
    kr[d] = live ? k[at] : 0.f;
    vr[d] = live ? v[at] : 0.f;
    dka[d] = 0.f;
    dva[d] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += kTile) {
    const int valid = min(kTile, n - q0);
    __syncthreads();
    stage_f32<D>(qs, q + base + (size_t)q0 * D, valid);
    stage_f32<D>(dos, dout + base + (size_t)q0 * D, valid);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      lses[i] = i < valid ? lse[(size_t)bh * n + q0 + i] : 0.f;
      dls[i] = i < valid ? delta[(size_t)bh * n + q0 + i] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < valid; ++i) {
      const float* qi = qs + i * D + c0;
      const float* di = dos + i * D + c0;
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        sp = fmaf(qi[d], kr[d], sp);
        dpp = fmaf(di[d], vr[d], dpp);
      }
      const float s = __fmul_rn(row_sum(sp), scale);
      const float p = expf(s - lses[i]);
      const float dp = row_sum(dpp);
      const float ds = __fmul_rn(__fmul_rn(p, dp - dls[i]), scale);
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        dva[d] = fmaf(p, di[d], dva[d]);
        dka[d] = fmaf(ds, qi[d], dka[d]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      const size_t at = base + (size_t)row * D + c0 + d;
      dk[at] = dka[d];
      dv[at] = dva[d];
    }
  }
}

// ============================================ bfloat16: tensor-core kernels
// (fragment layouts and the shared helpers: mma_bf16.cuh)

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

// dQ over query tiles; also writes delta = rowsum(dO * O) for the dK/dV kernel.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const float* __restrict__ lse, const bf16* __restrict__ dout,
                  bf16* __restrict__ dq, float* __restrict__ delta, int n, float scale) {
  __shared__ __align__(16) bf16 ks[kKv * (D + kPad)];
  __shared__ __align__(16) bf16 vs[kKv * (D + kPad)];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int row0 = blockIdx.y * kMmaRows + warp * 16;
  const size_t base = (size_t)bh * n * D;

  uint32_t qa[D / 16][4], da[D / 16][4], oa[D / 16][4];
  load_a<D>(qa, q + base, row0, n, g, t);
  load_a<D>(da, dout + base, row0, n, g, t);
  load_a<D>(oa, o + base, row0, n, g, t);
  float dl[2] = {0.f, 0.f}, lse_r[2];
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dl[i & 1] = fmaf(bf16_lo(da[s][i]), bf16_lo(oa[s][i]), dl[i & 1]);
      dl[i & 1] = fmaf(bf16_hi(da[s][i]), bf16_hi(oa[s][i]), dl[i & 1]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + h * 8;
    dl[h] = quad_sum(dl[h]);
    lse_r[h] = row < n ? lse[(size_t)bh * n + row] : 0.f;
    if (t == 0 && row < n) delta[(size_t)bh * n + row] = dl[h];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int kv0 = 0; kv0 < n; kv0 += kKv) {
    const int valid = min(kKv, n - kv0);
    __syncthreads();
    stage_bf16<D>(ks, k + base + (size_t)kv0 * D, valid);
    stage_bf16<D>(vs, v + base + (size_t)kv0 * D, valid);
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_abt<D>(s, qa, ks, g, t);   // S = Q K^T
    mma_abt<D>(dp, da, vs, g, t);  // dP = dO V^T
    uint32_t dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool live = j * 8 + 2 * t + (c & 1) < valid;
        const float p = live ? expf(__fmul_rn(s[j][c], scale) - lse_r[c >> 1]) : 0.f;
        ds[c] = __fmul_rn(__fmul_rn(p, dp[j][c] - dl[c >> 1]), scale);
      }
      pack_a(dsa, j, ds[0], ds[1], ds[2], ds[3]);
    }
    mma_ab<D>(acc, dsa, ks, lane);  // dQ += dS K
  }
  store_rows<D>(dq + base, acc, row0, n, g, t, 1.f, 1.f);
}

// dK and dV over key tiles: S^T = K Q^T and dP^T = V dO^T, so this warp's
// 16 keys are the rows of every product.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ lse,
                   const float* __restrict__ delta, const bf16* __restrict__ dout,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int n, float scale) {
  __shared__ __align__(16) bf16 qs[kKv * (D + kPad)];
  __shared__ __align__(16) bf16 dos[kKv * (D + kPad)];
  __shared__ float lses[kKv];
  __shared__ float dls[kKv];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int row0 = blockIdx.y * kMmaRows + warp * 16;  // key rows
  const size_t base = (size_t)bh * n * D;

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, k + base, row0, n, g, t);
  load_a<D>(va, v + base, row0, n, g, t);
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[nt][c] = dva[nt][c] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += kKv) {
    const int valid = min(kKv, n - q0);
    __syncthreads();
    stage_bf16<D>(qs, q + base + (size_t)q0 * D, valid);
    stage_bf16<D>(dos, dout + base + (size_t)q0 * D, valid);
    for (int i = threadIdx.x; i < kKv; i += kMmaThreads) {
      lses[i] = i < valid ? lse[(size_t)bh * n + q0 + i] : 0.f;
      dls[i] = i < valid ? delta[(size_t)bh * n + q0 + i] : 0.f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];
    mma_abt<D>(st, ka, qs, g, t);    // S^T = K Q^T
    mma_abt<D>(dpt, va, dos, g, t);  // dP^T = V dO^T
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = j * 8 + 2 * t + (c & 1);
        const bool live = qi < valid;
        p[c] = live ? expf(__fmul_rn(st[j][c], scale) - lses[qi]) : 0.f;
        ds[c] = __fmul_rn(__fmul_rn(p[c], dpt[j][c] - dls[qi]), scale);
      }
      pack_a(pa, j, p[0], p[1], p[2], p[3]);
      pack_a(dsa, j, ds[0], ds[1], ds[2], ds[3]);
    }
    mma_ab<D>(dva, pa, dos, lane);  // dV += P^T dO
    mma_ab<D>(dka, dsa, qs, lane);  // dK += dS^T Q
  }
  store_rows<D>(dk + base, dka, row0, n, g, t, 1.f, 1.f);
  store_rows<D>(dv + base, dva, row0, n, g, t, 1.f, 1.f);
}

// ================================================================= launches
template <int D>
void launch_fwd(int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
                int bh, int n, float scale, cudaStream_t s) {
  if (dtype == 0) {
    fwd_fma_kernel<D><<<dim3(bh, (n + kRows - 1) / kRows), kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse),
        n, scale);
  } else {
    fwd_mma_kernel<D><<<dim3(bh, (n + kMmaRows - 1) / kMmaRows), kMmaThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), static_cast<float*>(lse), n, scale);
  }
}

template <int D>
void launch_bwd(int dtype, const void* q, const void* k, const void* v, const void* o,
                const void* lse, const void* dout, void* dq, void* dk, void* dv,
                void* delta, int bh, int n, float scale, cudaStream_t s) {
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0) {
    using T = float;
    const dim3 grid(bh, (n + kRows - 1) / kRows);
    bwd_dq_fma_kernel<D><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), l, static_cast<const T*>(dout), static_cast<T*>(dq), dl,
        n, scale);
    if (cudaPeekAtLastError() != cudaSuccess) return;
    bwd_dkv_fma_kernel<D><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), l, dl,
        static_cast<const T*>(dout), static_cast<T*>(dk), static_cast<T*>(dv), n, scale);
  } else {
    using T = bf16;
    const dim3 grid(bh, (n + kMmaRows - 1) / kMmaRows);
    bwd_dq_mma_kernel<D><<<grid, kMmaThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), l, static_cast<const T*>(dout), static_cast<T*>(dq), dl,
        n, scale);
    if (cudaPeekAtLastError() != cudaSuccess) return;
    bwd_dkv_mma_kernel<D><<<grid, kMmaThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), l, dl,
        static_cast<const T*>(dout), static_cast<T*>(dk), static_cast<T*>(dv), n, scale);
  }
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
    case 64: launch_bwd<64>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta, bh, n, scale, s); break;
    case 80: launch_bwd<80>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta, bh, n, scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
