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
// whole K/V row in VMEM and walks 128-key blocks; here each block owns 64
// query rows (or 64 keys in dK/dV; 32 for float32 at D = 128) and streams
// the other side through shared memory in 64-row tiles (32 for float32 at
// D = 128).
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
// - float32 (no TF32, so no tensor cores): CUDA-core FMA loops, a row's
//   dot products split over 2 threads (4 in the backward at D = 128, where
//   2 spill; F32Shape). Bound: operations, 4*nq*nk*D (forward) and
//   10*nq*nk*D (backward) per head, halved when causal, at the card's
//   float32 FMA rate.
// - bfloat16: tensor cores through mma.sync m16n8k16 (mma_bf16.cuh), four
//   warps of 16 rows. Scores, P and dS stay in registers. The backward
//   kernels keep their block's own operands (Q and dO for dQ, K and V for
//   dK/dV) in shared memory and read A fragments from there one k-step at a
//   time: at D = 128 the dK and dV accumulators alone take 128 registers a
//   thread. Bound: bytes at these sequence lengths (q, k, v, o read or
//   written once); chip_smoke.py computes it as bound_ms. Loads are
//   synchronous (no cp.async/TMA pipeline) and the products are not wgmma:
//   later work.

#include <math.h>

#include "mma_bf16.cuh"

namespace {

// ====================================================== float32: FMA kernels
constexpr int kChunk = 16;  // keys per online-softmax update

// Per head dim, forward (Fwd) or backward: rows (queries or keys) per block,
// threads per row, rows per shared-memory tile (16 KB of K, V, Q or dO).
// At D = 128 the forward shares a row between 2 threads, the backward
// between 4 (at 2 its accumulators spill): scripts/sweep_flash_fp32_torch.py.
template <int D, bool Fwd>
struct F32Shape;
template <bool Fwd>
struct F32Shape<64, Fwd> { static constexpr int kRows = 64, kTpr = 2, kTile = 64; };
template <>
struct F32Shape<128, true> { static constexpr int kRows = 32, kTpr = 2, kTile = 32; };
template <>
struct F32Shape<128, false> { static constexpr int kRows = 32, kTpr = 4, kTile = 32; };

template <int D, bool Fwd>
struct F32 : F32Shape<D, Fwd> {
  static constexpr int kThreads = F32Shape<D, Fwd>::kRows * F32Shape<D, Fwd>::kTpr;
  static constexpr int kD = D / F32Shape<D, Fwd>::kTpr;  // columns per thread
};

// Sum over the kTpr consecutive lanes that share a row; every lane gets the
// same bits.
template <class P>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = P::kTpr / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage `valid` rows of a (rows, D) slab into a shared tile; the rest is zero.
template <class P, int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int valid) {
  for (int e = threadIdx.x; e < P::kTile * D; e += P::kThreads) {
    dst[e] = (e / D) < valid ? src[e] : 0.f;
  }
}

// the masks, shared by every kernel: key col visible from query row
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

template <int D>
__global__ void __launch_bounds__(F32<D, true>::kThreads)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     const float* __restrict__ slopes, int nq, int nk, int causal, int q_off,
                     float scale) {
  using P = F32<D, true>;
  constexpr int kD = P::kD;
  __shared__ float ks[P::kTile * D];
  __shared__ float vs[P::kTile * D];
  const int bh = blockIdx.x;
  const int r0 = blockIdx.y * P::kRows;
  const int row = r0 + threadIdx.x / P::kTpr;
  const int c0 = (threadIdx.x % P::kTpr) * kD;
  const bool live = row < nq;
  const size_t qb = (size_t)bh * nq * D, kb = (size_t)bh * nk * D;
  const float slope = slopes ? slopes[bh] : 0.f;

  float qr[kD], acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = live ? __fmul_rn(q[qb + (size_t)row * D + c0 + d], scale) : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegBig, l = 0.f;
  const int hi = key_end(r0, P::kRows, nk, causal, q_off);

  for (int kv0 = 0; kv0 < hi; kv0 += P::kTile) {
    __syncthreads();
    stage_f32<P, D>(ks, k + kb + (size_t)kv0 * D, min(P::kTile, nk - kv0));
    stage_f32<P, D>(vs, v + kb + (size_t)kv0 * D, min(P::kTile, nk - kv0));
    __syncthreads();
    const int cols = min(P::kTile, hi - kv0);
    for (int j0 = 0; j0 < cols; j0 += kChunk) {
      float s[kChunk];
      uint32_t ok = 0u;
      float cmax = kNegBig;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* kr = ks + (j0 + j) * D + c0;
        float part = 0.f;
#pragma unroll
        for (int d = 0; d < kD; ++d) part = fmaf(qr[d], kr[d], part);
        float sj = row_sum<P>(part);  // every lane of the warp shuffles
        const int col = kv0 + j0 + j;
        if (slopes) sj = alibi(sj, slope, row, col);
        const bool vis = visible(row, col, nq, nk, causal, q_off);
        ok |= (vis ? 1u : 0u) << j;
        s[j] = vis ? sj : kNegBig;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = (ok >> j) & 1u ? expf(s[j] - m_new) : 0.f;
        l += p;
        const float* vr = vs + (j0 + j) * D + c0;
#pragma unroll
        for (int d = 0; d < kD; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
      }
      m = m_new;
    }
  }
  if (live) {
    const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int d = 0; d < kD; ++d) o[qb + (size_t)row * D + c0 + d] = acc[d] / l_safe;
    if (c0 == 0) lse[(size_t)bh * nq + row] = m + logf(l_safe);
  }
}

// dQ over query tiles; also writes delta = rowsum(dO * O) for the dK/dV kernel.
template <int D>
__global__ void __launch_bounds__(F32<D, false>::kThreads)
flash_bwd_dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ lse, const float* __restrict__ dout,
                        const float* __restrict__ slopes, float* __restrict__ dq,
                        float* __restrict__ delta, int nq, int nk, int causal, int q_off,
                        float scale) {
  using P = F32<D, false>;
  constexpr int kD = P::kD;
  __shared__ float ks[P::kTile * D];
  __shared__ float vs[P::kTile * D];
  const int bh = blockIdx.x;
  const int r0 = blockIdx.y * P::kRows;
  const int row = r0 + threadIdx.x / P::kTpr;
  const int c0 = (threadIdx.x % P::kTpr) * kD;
  const bool live = row < nq;
  const size_t qb = (size_t)bh * nq * D, kb = (size_t)bh * nk * D;
  const float slope = slopes ? slopes[bh] : 0.f;

  float qr[kD], dor[kD], acc[kD];
  float dpart = 0.f;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    const size_t at = qb + (size_t)row * D + c0 + d;
    qr[d] = live ? q[at] : 0.f;
    dor[d] = live ? dout[at] : 0.f;
    dpart = fmaf(dor[d], live ? o[at] : 0.f, dpart);
    acc[d] = 0.f;
  }
  const float dl = row_sum<P>(dpart);
  const float lse_r = live ? lse[(size_t)bh * nq + row] : 0.f;
  if (live && c0 == 0) delta[(size_t)bh * nq + row] = dl;
  const int hi = key_end(r0, P::kRows, nk, causal, q_off);

  for (int kv0 = 0; kv0 < hi; kv0 += P::kTile) {
    __syncthreads();
    stage_f32<P, D>(ks, k + kb + (size_t)kv0 * D, min(P::kTile, nk - kv0));
    stage_f32<P, D>(vs, v + kb + (size_t)kv0 * D, min(P::kTile, nk - kv0));
    __syncthreads();
    const int cols = min(P::kTile, hi - kv0);
    for (int j = 0; j < cols; ++j) {
      const float* kr = ks + j * D + c0;
      const float* vr = vs + j * D + c0;
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        sp = fmaf(qr[d], kr[d], sp);
        dpp = fmaf(dor[d], vr[d], dpp);
      }
      const int col = kv0 + j;
      float s = __fmul_rn(row_sum<P>(sp), scale);
      if (slopes) s = alibi(s, slope, row, col);
      const float p = visible(row, col, nq, nk, causal, q_off) ? expf(s - lse_r) : 0.f;
      const float dp = row_sum<P>(dpp);
      const float ds = __fmul_rn(__fmul_rn(p, dp - dl), scale);
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
    }
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < kD; ++d) dq[qb + (size_t)row * D + c0 + d] = acc[d];
  }
}

// dK and dV over key tiles.
template <int D>
__global__ void __launch_bounds__(F32<D, false>::kThreads)
flash_bwd_dkv_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ lse,
                         const float* __restrict__ delta, const float* __restrict__ dout,
                         const float* __restrict__ slopes, float* __restrict__ dk,
                         float* __restrict__ dv, int nq, int nk, int causal, int q_off,
                         float scale) {
  using P = F32<D, false>;
  constexpr int kD = P::kD;
  __shared__ float qs[P::kTile * D];
  __shared__ float dos[P::kTile * D];
  __shared__ float lses[P::kTile];
  __shared__ float dls[P::kTile];
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * P::kRows;
  const int key = k0 + threadIdx.x / P::kTpr;
  const int c0 = (threadIdx.x % P::kTpr) * kD;
  const bool live = key < nk;
  const size_t qb = (size_t)bh * nq * D, kb = (size_t)bh * nk * D;
  const float slope = slopes ? slopes[bh] : 0.f;

  float kr[kD], vr[kD], dka[kD], dva[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    const size_t at = kb + (size_t)key * D + c0 + d;
    kr[d] = live ? k[at] : 0.f;
    vr[d] = live ? v[at] : 0.f;
    dka[d] = 0.f;
    dva[d] = 0.f;
  }

  for (int q0 = query_start(k0, P::kTile, causal, q_off); q0 < nq; q0 += P::kTile) {
    const int valid = min(P::kTile, nq - q0);
    __syncthreads();
    stage_f32<P, D>(qs, q + qb + (size_t)q0 * D, valid);
    stage_f32<P, D>(dos, dout + qb + (size_t)q0 * D, valid);
    for (int i = threadIdx.x; i < P::kTile; i += P::kThreads) {
      lses[i] = i < valid ? lse[(size_t)bh * nq + q0 + i] : 0.f;
      dls[i] = i < valid ? delta[(size_t)bh * nq + q0 + i] : 0.f;
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
      const int row = q0 + i;
      float s = __fmul_rn(row_sum<P>(sp), scale);
      if (slopes) s = alibi(s, slope, row, key);
      const float p = visible(row, key, nq, nk, causal, q_off) ? expf(s - lses[i]) : 0.f;
      const float dp = row_sum<P>(dpp);
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
      const size_t at = kb + (size_t)key * D + c0 + d;
      dk[at] = dka[d];
      dv[at] = dva[d];
    }
  }
}

// ============================================ bfloat16: tensor-core kernels
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     const float* __restrict__ slopes, int nq, int nk, int causal, int q_off,
                     float scale) {
  __shared__ __align__(16) bf16 ks[kKv * (D + kPad)];
  __shared__ __align__(16) bf16 vs[kKv * (D + kPad)];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int r0 = blockIdx.y * kMmaRows;
  const int row0 = r0 + warp * 16;
  const size_t qb = (size_t)bh * nq * D, kb = (size_t)bh * nk * D;
  const float slope = slopes ? slopes[bh] : 0.f;

  // q scaled in bf16 before the product: the exact product rounded once
  const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
  uint32_t qa[D / 16][4];
  load_a<D>(qa, q + qb, row0, nq, g, t);
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
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};  // rows g, g+8
  const int hi = key_end(r0, kMmaRows, nk, causal, q_off);

  for (int kv0 = 0; kv0 < hi; kv0 += kKv) {
    __syncthreads();
    stage_bf16<D>(ks, k + kb + (size_t)kv0 * D, min(kKv, nk - kv0));
    stage_bf16<D>(vs, v + kb + (size_t)kv0 * D, min(kKv, nk - kv0));
    __syncthreads();

    float s[8][4];
    mma_abt<D>(s, qa, ks, g, t);
    uint32_t ok = 0u;  // bit 4j + c: score s[j][c] is visible
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = row0 + g + (c >> 1) * 8;
        const int col = kv0 + j * 8 + 2 * t + (c & 1);
        float sc = s[j][c];
        if (slopes) sc = alibi(sc, slope, row, col);
        const bool vis = visible(row, col, nq, nk, causal, q_off);
        ok |= (vis ? 1u : 0u) << (4 * j + c);
        s[j][c] = vis ? sc : kNegBig;  // before the max
        mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = expf(m[h] - m_new);
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
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = (ok >> (4 * j + c)) & 1u ? expf(s[j][c] - m[c >> 1]) : 0.f;
      }
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      pack_a(pa, j, p[0], p[1], p[2], p[3]);
    }
    mma_ab<D>(acc, pa, vs, lane);
  }

  float ls[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lh = quad_sum(l[h]);
    ls[h] = lh == 0.f ? 1.f : lh;
  }
  store_rows<D>(o + qb, acc, row0, nq, g, t, 1.f / ls[0], 1.f / ls[1]);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + h * 8;
      if (row < nq) lse[(size_t)bh * nq + row] = m[h] + logf(ls[h]);
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
template <int D>
void launch_fwd(int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
                const float* slopes, int bh, int nq, int nk, int causal, int q_off,
                float scale, cudaStream_t s) {
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    using T = float;
    constexpr int kRows = F32<D, true>::kRows;
    flash_fwd_fma_kernel<D><<<dim3(bh, (nq + kRows - 1) / kRows), F32<D, true>::kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), l, slopes, nq, nk, causal, q_off, scale);
  } else {
    using T = bf16;
    flash_fwd_mma_kernel<D><<<dim3(bh, (nq + kMmaRows - 1) / kMmaRows), kMmaThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), l, slopes, nq, nk, causal, q_off, scale);
  }
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
    constexpr int kThreads = F32<D, false>::kThreads, kRows = F32<D, false>::kRows;
    flash_bwd_dq_fma_kernel<D><<<dim3(bh, (nq + kRows - 1) / kRows), kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), l, static_cast<const T*>(dout), slopes,
        static_cast<T*>(dq), dl, nq, nk, causal, q_off, scale);
    if (cudaPeekAtLastError() != cudaSuccess) return;
    flash_bwd_dkv_fma_kernel<D><<<dim3(bh, (nk + kRows - 1) / kRows), kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), l, dl,
        static_cast<const T*>(dout), slopes, static_cast<T*>(dk), static_cast<T*>(dv), nq,
        nk, causal, q_off, scale);
  } else {
    using T = bf16;
    constexpr int kSmem = bwd_smem_bytes<D>();
    // above 48 KB a kernel must opt in; cheap, and idempotent
    if (cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem) != cudaSuccess ||
        cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem) != cudaSuccess) {
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
// unsupported dtype or head dim).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, const void* slopes, int bh, int nq, int nk, int d,
                              int dtype, int causal, int q_off, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sl = static_cast<const float*>(slopes);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64: launch_fwd<64>(dtype, q, k, v, o, lse, sl, bh, nq, nk, causal, q_off, scale, s); break;
    case 128: launch_fwd<128>(dtype, q, k, v, o, lse, sl, bh, nq, nk, causal, q_off, scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
