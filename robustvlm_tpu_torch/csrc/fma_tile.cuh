// float32 building blocks for attention kernels on the CUDA cores (no TF32,
// so no tensor cores): 16-byte cp.async staging of row-major tiles into
// padded shared memory, and two register-tiled products computed
// SGEMM-style: every operand is loaded from shared memory 16 bytes at a
// time and used from registers, 8 to 13 FMAs a load at the shapes in use.
//
// One thread layout serves both products. A block of kThreads threads is a
// grid of G = kThreads / 8 row groups by 8 column groups; thread (gy, lx) =
// (row_group(), col_group()) owns
//   rows     gy + i * G            i < R   (of the block's R * G rows),
//   columns  lx + 8 * j            j < SN  of an A B^T product (tile_abt),
//   columns  4 * lx + 32 * c + e   c < NC, e < 4  of an A B product (tile_ab).
// A warp is 4 neighbouring row groups by the 8 column groups, so the 8
// threads that share a row are lanes of one warp: row maxima and sums are
// three xor-shuffles (oct_max, oct_sum), once a tile, never once a product.
//
// Lanes within a warp. A warp's 16-byte shared-memory load takes 2 cycles
// of the shared-memory pipe when every 4 neighbouring lanes (4q .. 4q + 3)
// read at most 2 different 16-byte chunks, and 4 cycles otherwise, however
// few chunks the warp reads in all (scripts/bench_shared_load_torch.py
// measures it). So each such lane quad is a 2 x 2 patch of the warp's 4 x 8
// (row group, column group) grid: lane bits 0, 2, 3 are the column group,
// bits 1, 4 the row group. Loads of an operand indexed by the row group
// (A, P) and of one indexed by the column group (B, V) then both see 2
// chunks a quad: every operand load runs at the fast rate.
//
// Shared-memory banks. Tiles whose rows are the inner dimension's vectors
// (Q, K, V, dO: D floats a row) are padded to D + kPadF floats, a row stride
// of 4 banks (mod 32): the 8 neighbouring rows that a warp's column groups
// load (16 bytes each, same offset) cover the 32 banks once, and the 4
// neighbouring rows that its row groups load (broadcast to 8 lanes each)
// fall in 4 different bank quads: no load of a warp has a bank conflict.
// The P / dS tiles (kTile floats a row) are padded to kTile + kPadP, a row
// stride of 8 banks: the warp's 4 x 8 scalar stores of a micro-tile column
// hit 32 different banks, and its 16-byte loads of 4 neighbouring rows stay
// conflict-free.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPadF = 4;  // floats of padding after a D-float shared row
constexpr int kPadP = 8;  // floats of padding after a P / dS shared row

// ------------------------------------------------------------ thread layout
__device__ __forceinline__ int col_group() {  // lx: lane bits 0, 2, 3
  return (threadIdx.x & 1) | ((threadIdx.x >> 1) & 6);
}
__device__ __forceinline__ int row_group() {  // gy: 4 a warp, lane bits 1, 4
  return (threadIdx.x >> 5) * 4 + ((threadIdx.x >> 1) & 1) + ((threadIdx.x >> 3) & 2);
}

// ------------------------------------------------------------------ cp.async
// 16 bytes from device to shared memory, not through registers; with
// valid == false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

// 4 bytes (rows of lse and delta, which are only 4-byte aligned)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of a (kRows, D) slab (row stride D) into a padded shared
// tile of DP-float rows (row stride DP + kPadF, DP >= D a multiple of 4);
// rows from `valid` on, and columns from D on, are zero-filled. Chunk c of
// 16 bytes belongs to thread c % kThreads: scale_own_chunks visits the same
// ones.
template <int D, int kRows, int kThreads, int DP = D>
__device__ __forceinline__ void stage_tile_async(float* dst, const float* src, int valid) {
  constexpr int kChunks = DP / 4;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 4;
    const bool ok = r < valid && col < D;
    cp_async16(dst + r * (DP + kPadF) + col, src + (ok ? (size_t)r * D + col : 0), ok);
  }
}

// Multiply by `mul` (round to nearest) the chunks this thread itself staged
// with stage_tile_async: after its own cp_async_wait they are visible to it,
// so no barrier is needed before, only one before another thread reads them.
template <int DP, int kRows, int kThreads>
__device__ __forceinline__ void scale_own_chunks(float* tile, float mul) {
  constexpr int kChunks = DP / 4;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    float4* p = reinterpret_cast<float4*>(tile + (c / kChunks) * (DP + kPadF) + (c % kChunks) * 4);
    float4 x = *p;
    x.x = __fmul_rn(x.x, mul);
    x.y = __fmul_rn(x.y, mul);
    x.z = __fmul_rn(x.z, mul);
    x.w = __fmul_rn(x.w, mul);
    *p = x;
  }
}

// Start the copy of `n` floats of a row that is only 4-byte aligned (lse,
// delta); floats from `valid` on are zero-filled.
template <int kThreads>
__device__ __forceinline__ void stage_row_async(float* dst, const float* src, int n, int valid) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool ok = i < valid;
    cp_async4(dst + i, src + (ok ? i : 0), ok);
  }
}

// ------------------------------------------------------------------ products
__device__ __forceinline__ float4 lds128(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] += sum_k A[gy + i G][k] * B[lx + 8 j][k] for k < K: both tiles
// row-major in shared memory with the inner dimension contiguous. `a` points
// at row gy of A (row stride LDA), `b` at row lx of B (row stride LDB). Per
// 4 values of k: R + SN 16-byte loads, 4 R SN FMAs.
template <int R, int SN, int G, int K, int LDA, int LDB>
__device__ __forceinline__ void tile_abt(float (&acc)[R][SN], const float* a, const float* b) {
#pragma unroll 8
  for (int k = 0; k < K; k += 4) {
    float4 av[R], bv[SN];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = lds128(a + i * G * LDA + k);
#pragma unroll
    for (int j = 0; j < SN; ++j) bv[j] = lds128(b + j * 8 * LDB + k);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][4 c + e] += sum_k P[gy + i G][k] * V[k][4 lx + 32 c + e] for k < K:
// P row-major with k contiguous (row stride LDP), V with k its row (row
// stride LDV). `p` points at row gy of P, `v` at column 4 lx of V. Per 4
// values of k: R + 4 NC 16-byte loads, 16 R NC FMAs.
template <int R, int NC, int G, int K, int LDP, int LDV>
__device__ __forceinline__ void tile_ab(float (&acc)[R][4 * NC], const float* p, const float* v) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 pv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) pv[i] = lds128(p + i * G * LDP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = lds128(v + (k + kk) * LDV + 32 * c);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pe = kk == 0 ? pv[i].x : kk == 1 ? pv[i].y : kk == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[i][4 * c + 0] = fmaf(pe, vv[c].x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(pe, vv[c].y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pe, vv[c].z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pe, vv[c].w, acc[i][4 * c + 3]);
        }
      }
    }
  }
}

// Max and sum over the 8 lanes that share a row (they differ in lane bits 0,
// 2, 3); every lane gets the same bits (each step adds the same two
// partials in both lanes).
__device__ __forceinline__ float oct_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
}
__device__ __forceinline__ float oct_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v + __shfl_xor_sync(0xffffffffu, v, 8);
}

}  // namespace
