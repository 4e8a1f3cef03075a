// Hopper building blocks for bfloat16 tensor-core kernels: the Tensor
// Memory Accelerator (TMA) and its mbarriers, and warpgroup matrix products
// (wgmma) with B in shared memory and A in shared memory (_ss) or in
// registers (_rs). sm_90a only.
//
// Tiles are copied by TMA from (inner, rows, heads, batch) bf16 arrays
// (inner = head dim, rows = sequence), each addressed through its own
// strides, as boxes of 64 inner elements
// (128 bytes) by `box_rows` rows, with the 128-byte swizzle: row r of a box
// lands at byte 128 r of it, its 16-byte chunk c at chunk c ^ (r % 8). Rows
// past the array's `rows`, and columns past `inner` (a head dim of 80 or 88
// read as two boxes), are zero-filled by the hardware, which still counts the
// whole box towards the mbarrier's transaction bytes. Every box
// starts on a 1024-byte boundary of shared memory, so the swizzle is that
// of the address and wgmma's descriptors below read it with layout mode
// "128-byte swizzle".
//
// wgmma m64nNk16 (PTX ISA, "Matrix fragments for wgmma"): the four warps of
// a warpgroup own rows 16 w .. 16 w + 15 of the 64-row tile; within a warp,
// lane = 4 g + t, the fragments are those of mma.sync m16n8k16
// (mma_bf16.cuh), repeated over N in 8-column steps:
//   A (16 x 16 of the warp, 4 registers): (g, 2t..), (g + 8, 2t..),
//                                         (g, 2t + 8..), (g + 8, 2t + 8..);
//   D (16 x N of the warp, N / 2 floats): d[4 j + c] is row g (c < 2) or
//     g + 8 (c >= 2), column 8 j + 2 t + (c & 1).
// So two neighbouring 8-column groups of a float32 D are, rounded to bf16,
// the A fragment of one 16-wide k-step of the next product.
//
// Shared-memory matrix descriptors (128-byte swizzle):
// - K-major (the k index contiguous: Q and K of S = Q K^T, rows = queries
//   or keys): rows of 128 bytes, 8-row groups SBO = 1024 bytes apart; a
//   k-step of 16 inside the 128-byte row moves the start address by 32
//   bytes; LBO is unused.
// - MN-major (B's n index contiguous: V of O = P V, rows = keys, n = head
//   dim), read with the transpose bit: 64 n a 128-byte row, groups of 8 k
//   rows SBO = 1024 bytes apart, the next 64 n (the next box) LBO bytes
//   on; a k-step of 16 rows moves the start address by 2048 bytes.
// scripts/probe_wgmma_torch.py holds both products against torch.matmul.
//
// A fault to avoid, found on the card: in the flash forward's loop, S =
// Q K^T as an _rs product after O += P V, an _rs product of the same shape
// with the transpose bit (key tile N = head dim D), gave wrong scores from
// the second key tile on, with every fence and wait in place; N != D, or
// S with A from shared memory (_ss, what the forward runs), is right. One
// such pair alone is right (the probe runs it), so the loop is needed.
//
// Ordering: wgmma_fence() before the first wgmma that reads registers
// written by ordinary instructions (A fragments, a rescaled accumulator);
// commit, then wait until the group is done before the accumulator or a
// B tile is touched again; fence_regs() keeps the compiler from moving
// accesses of the accumulator across those asm statements.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// Above 48 KB of dynamic shared memory a kernel must opt in; the launchers
// call this once an instantiation (a static), not on every launch.
template <class Kernel>
bool allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) ==
         cudaSuccess;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA); a block
// barrier must follow before any other thread uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This thread's arrival, and `bytes` more that the barrier's phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase with this parity (0, 1, 0, ...: the n-th use of the
// barrier has parity n % 2) is complete. A phase that has not completed
// after about 2^35 clock cycles (some seconds) can only be a fault (bytes
// that never come): the kernel traps, so the launch fails instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  long long start = -1;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) {
      start = now;
    } else if (now - start > (1ll << 35)) {
      __trap();
    }
  }
}

// ----------------------------------------------------------------------- TMA
// Element strides of a (batch, heads, rows, inner) bf16 operand whose inner
// dimension is contiguous: a contiguous (B*H, n, D) array has (H n D, n D,
// D); a head's view into a token-major (B, n, H, D) array or into a fused
// (B, n, 3 H D) projection has (n W, D, W) with W the row's width.
struct Bhn {
  long long b, h, n;
};

// Whether st are the strides of a contiguous (batch, heads, n, d) array: what
// the float32 kernels, which take no strides, need.
inline bool packed(const Bhn& st, int heads, int n, int d) {
  return st.n == d && st.h == (long long)n * d && st.b == (long long)heads * n * d;
}

// One box of a 4-D tensor map into shared memory at dst (1024-byte aligned
// for the 128-byte swizzle), completing on bar. Coordinates innermost first:
// column, row, head, batch.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 3-D tensor map into shared memory at dst (1024-byte aligned
// for the 128-byte swizzle), completing on bar. Coordinates innermost first.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A driver function, found through the runtime's entry-point query (so the
// library needs no -lcuda); null if it is not there.
inline void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess) {
    return nullptr;
  }
  return p;
}

// cuTensorMapEncodeTiled (found once), ready to call. It fails without a
// current context, which a thread lacks until some runtime call binds one:
// autograd's device thread can reach a backward having made none, when the
// caching allocator served every tensor it made. cudaFree(nullptr) binds
// the runtime's. Null if the encoder is not there or no context can be bound.
inline EncodeTiled encode_tiled() {
  using GetCurrent = CUresult (*)(CUcontext*);
  static const EncodeTiled fn =
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  static const GetCurrent current =
      reinterpret_cast<GetCurrent>(driver_entry("cuCtxGetCurrent"));
  CUcontext ctx = nullptr;
  if (current == nullptr || current(&ctx) != CUDA_SUCCESS) return nullptr;
  if (ctx == nullptr && cudaFree(nullptr) != cudaSuccess) return nullptr;
  return fn;
}

// A tensor map over a contiguous (planes, rows, inner) bf16 array, boxes of
// 64 x box_rows x 1, 128-byte swizzle, zero fill (scripts/probe_wgmma_torch.py's
// tiles). False on failure.
inline bool make_map_3d(CUtensorMap* map, const void* base, int inner, int rows, int planes,
                        int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2, (cuuint64_t)rows * inner * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map over a (batch, heads, rows, inner) bf16 operand with element
// strides st (multiples of 8: TMA takes strides of whole 16 bytes), boxes of
// 64 x box_rows x 1 x 1, 128-byte swizzle, zero fill past rows and inner
// whatever the strides put there. False on failure.
inline bool make_map_4d(CUtensorMap* map, const void* base, int inner, int rows, int heads,
                        int batch, Bhn st, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.n * 2, (cuuint64_t)st.h * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// --------------------------------------------------------------------- wgmma
// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (multiples of 16 bytes).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// The descriptors of k-step kk of a tile of `rows` rows copied as above
// (boxes of `rows` 128-byte rows, the next box rows * 128 bytes on):
// K-major, 4 k-steps of 16 in each box row; MN-major (read with the
// transpose bit), 16 rows a k-step, the tile's columns the product's N.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int kk) {
  return wgmma_desc(tile + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows, int kk) {
  return wgmma_desc(tile + kk * 16 * 128, rows * 128, 1024);
}

// Make this thread's ordinary shared-memory writes visible to the async
// proxy (wgmma's and TMA's reads); a block barrier must follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of wgmma are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+r"(r[i][c])::"memory");
  }
}

// D (64 x 64, float32, fragment d) += A (64 x 16 bf16, registers a) * B (16 x 64
// bf16, shared memory, descriptor b); scale_d = 0 drops D's old value.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
}

// D (64 x 80, float32, fragment d) += A (64 x 16 bf16, registers a) * B (16 x 80
// bf16, shared memory, descriptor b): O += P V at head dim 80, whose B spans
// one 64-column box and 16 columns of the next (LBO bytes on).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n80k16_rs(float (&d)[40], const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
}

// D (64 x 88, float32, fragment d) += A (64 x 16 bf16, registers a) * B (16 x 88
// bf16, shared memory, descriptor b): O += P V at head dim 88 (ViT-g/14),
// whose B spans one 64-column box and 24 columns of the next (LBO bytes on).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n88k16_rs(float (&d)[44], const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %49, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43}, "
      "{%44, %45, %46, %47}, %48, p, 1, 1, %50;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
}

// D (64 x 128, float32, fragment d) += A (64 x 16 bf16, registers a) * B (16 x 128
// bf16, shared memory, descriptor b); scale_d = 0 drops D's old value.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB));
}

// D (64 x 32, float32) += A (64 x 16 bf16, shared memory, descriptor a) * B
// (16 x 32 bf16, shared memory, descriptor b); both K-major.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t a, uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 16 bf16, shared memory, descriptor a) * B
// (16 x 64 bf16, shared memory, descriptor b); both K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 128, float32) += A (64 x 16 bf16, shared memory, descriptor a) * B
// (16 x 128 bf16, shared memory, descriptor b); both K-major.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a, uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The products for N = 64, 80, 88 or 128 (32, 64 or 128 with A from shared memory).
template <int N, int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  static_assert(N == 64 || N == 80 || N == 88 || N == 128,
                "wgmma_rs wrappers exist for N = 64, 80, 88 and 128");
  if constexpr (N == 64) {
    wgmma_m64n64k16_rs<TransB>(d, a, b, scale_d);
  } else if constexpr (N == 80) {
    wgmma_m64n80k16_rs<TransB>(d, a, b, scale_d);
  } else if constexpr (N == 88) {
    wgmma_m64n88k16_rs<TransB>(d, a, b, scale_d);
  } else {
    wgmma_m64n128k16_rs<TransB>(d, a, b, scale_d);
  }
}
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss wrappers exist for N = 32, 64 and 128");
  if constexpr (N == 32) {
    wgmma_m64n32k16_ss(d, a, b, scale_d);
  } else if constexpr (N == 64) {
    wgmma_m64n64k16_ss(d, a, b, scale_d);
  } else {
    wgmma_m64n128k16_ss(d, a, b, scale_d);
  }
}

}  // namespace
