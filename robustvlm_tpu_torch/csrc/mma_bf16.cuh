// bfloat16 tensor-core building blocks: mma.sync m16n8k16 with bf16
// operands and float32 accumulators (vit_attention.cu's bf16 forward, four
// warps of 16 rows per block, K/V tiles of 64 rows staged in padded shared
// memory; q4_matmul.cu), and the bf16 packing and quad reductions that the
// wgmma kernels share.
//
// mma.sync m16n8k16 fragments (PTX ISA), lane = 4 * g + t:
//   A (16 x 16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..),
//                           a[2] = (g, 2t+8..),   a[3] = (g+8, 2t+8..);
//   B (16 x 8, "col"):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g);
//   C (16 x 8, float32):    c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..).
// Two neighbouring C tiles (columns 16kk..16kk+15) are, packed to bf16, the A
// fragment of k-step kk of the next product: pack_a below.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kMmaRows = 16 * kWarps;  // rows per block (16 per warp)
constexpr int kKv = 64;                // rows per shared-memory tile
constexpr int kPad = 8;                // bf16 padding per shared row: 16-byte
                                       // aligned rows, conflict-free reads

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed: each lane gives the
// address of one 16-byte row (lanes 8i..8i+7: matrix i).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Stage `valid` rows of a (rows, D) bf16 slab into a padded shared tile of
// kKv rows (row stride D + kPad), 16 bytes a thread; the rest is zero.
template <int D>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src, int valid) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kKv * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + col);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + col) = val;
  }
}

// A fragments of a warp's 16 rows (row0 = first row) of a (n, D) array in
// device memory, one per 16-column k-step; rows past n are zero.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* src,
                                       int row0, int n, int g, int t) {
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + (i & 1) * 8;
      const int col = s * 16 + (i >> 1) * 8 + 2 * t;
      a[s][i] = row < n ? ld32(src + (size_t)row * D + col) : 0u;
    }
  }
}

// c[j] (16 x 8, j = 0..7) = A (16 x D, fragments a) times rows 8j..8j+7 of
// the shared tile (64 x D): A B^T with B read straight (no transpose).
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const uint32_t (&a)[D / 16][4],
                                        const bf16* tile, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
      const bf16* b = tile + (j * 8 + g) * (D + kPad) + s * 16 + 2 * t;
      mma16816(c[j], a[s], ld32(b), ld32(b + 8));
    }
  }
}

// acc (16 x D) += P (16 x 64, A fragments p[kk] per 16-column k-step) times
// the shared tile (64 x D), read transposed by ldmatrix.
template <int D>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const uint32_t (&p)[4][4],
                                       const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      uint32_t b[4];
      ldsm_x4_trans(b, tile + r * (D + kPad) + np * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * np], p[kk], b[0], b[1]);
      mma16816(acc[2 * np + 1], p[kk], b[2], b[3]);
    }
  }
}

// The C tile j's values (c0, c1 in row g; c2, c3 in row g+8) packed into
// their place of the A fragments of the next product.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], int j, float c0, float c1,
                                       float c2, float c3) {
  a[j / 2][(j & 1) * 2] = pack_bf16(c0, c1);
  a[j / 2][(j & 1) * 2 + 1] = pack_bf16(c2, c3);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store a warp's 16 x D float32 accumulator as bf16 rows row0.. of dst
// (rows past n are dropped), each value times mul[0] (row g) or mul[1].
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4], int row0,
                                           int n, int g, int t, float mul0, float mul1) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + h * 8;
    if (row >= n) continue;
    const float mul = h ? mul1 : mul0;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(dst + (size_t)row * D + nt * 8 + 2 * t) =
          pack_bf16(acc[nt][2 * h] * mul, acc[nt][2 * h + 1] * mul);
    }
  }
}

}  // namespace
