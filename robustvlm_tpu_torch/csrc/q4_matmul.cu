// Packed-int4 weight times a decode-sized activation on Hopper: the
// counterpart of `_q4_matmul_2d` (robustvlm_tpu/ops/pallas/q4_matmul.py:168)
// and both of its bodies, `_kernel_group` (the default) and `_kernel`
// (Q4_KERNEL=shift).
//
// out (B, N) = x_lo (B, K/2) W_lo + x_hi (B, K/2) W_hi for B <= 32. The
// uint8 p (K/2, N) holds row r of W_lo in its low nibble and row r of W_hi
// in its high nibble, code q standing for q - 8; the float32 scales s
// (K/G, N) hold one scale per G rows and column, the first K/(2G) groups
// for W_lo. x is read in bf16; the output is float32 or bf16 (x's dtype).
//
//   group: part = x_h[rows of group g] . (q - 8), float32, then
//          y += part * s_h[g]              (scale on the float32 partials)
//   shift: w = bf16(bf16(q - 8) * bf16(s_h[g])), y += x_h[rows of g] . w
//
// What bounds it: the bytes. A decode step reads every packed byte once and
// each byte feeds 2 B multiply-adds, far below the tensor cores' rate, so
// the kernel streams p once, coalesced along N, and never writes a decoded
// weight to memory. Three things keep it near that bound on this card:
// - Enough blocks. A block owns kCols output columns and a run of whole
//   groups of rows: the K range is split across `splits` blocks, so that
//   N = 4096 (64 column tiles) still launches several blocks an SM. Splits
//   fall on group boundaries and may differ by one group (w_down's 43
//   groups a half over 8 splits: 5 or 6). Fewer splits at larger B
//   (kMaxSplits), whose partials are larger.
// - Bytes in flight all the time, and no load on the critical path. The
//   block's rows stream through a ring of kStages stages of kStageRows
//   packed rows (16 where that does not divide the group) in shared memory,
//   each with the same rows of x, filled by 16-byte cp.async: the next
//   stages land while this one is decoded and multiplied. A group's scales
//   are loaded a group ahead. The 16-byte chunks of p are placed with an XOR
//   swizzle (bits 5 and 6 of a byte's offset flipped by bits 2 and 3 of its
//   row) so that the warp's 4-byte reads below hit 32 different banks.
// - Few instructions a byte: the kernel is bound by its issue rate before
//   the bytes once it is not waiting on them. A stage lies in one group, so
//   the stage loop has no test inside; its k-steps are unrolled with
//   constant shared-memory offsets; the nibble mask and the magic number
//   take one lop3.
// - One launch. The split blocks of a column tile form a thread-block
//   cluster (cluster dims (splits, 1, 1), launched by cudaLaunchKernelEx,
//   which a CUDA graph captures). Each writes its float32 partial (B x kCols)
//   into its own shared memory; after cluster.sync(), block r adds up its
//   share of the tile's outputs over the ranks 0, 1, ... in that order,
//   reading its peers' partials through distributed shared memory (all
//   loads issued before the first add), and writes them. No atomics, no
//   second kernel, and the order of every sum is fixed: bitwise repeatable.
//   (Pushing the partials into their owners' shared memory and arriving on
//   the owners' mbarriers, in place of the two cluster barriers, was tried
//   on the card and was slower.)
//
// Inside a block:
// - Warp w owns 32 of the block's columns and every k-step (16 packed rows)
//   of its range. mma.sync m16n8k16 (bf16 operands, float32 accumulators)
//   computes out^T: the weight is the A operand (16 columns x 16 rows), x
//   the B operand (16 rows x 8 batch rows), so B = 1..8 takes one batch
//   tile; NB tiles cover B <= 32 (template NB).
// - The fragments' row and column order is free as long as A, B and C agree:
//   thread (g, t) of a warp takes rows 4t..4t+3 of a 16-row k-step and
//   columns 4g..4g+3 of the warp's 32 (its A rows m = g and g + 8 of two
//   16-column tiles). Its weight fragment is then four 32-bit shared loads,
//   one per row; x follows the same row order (8 bytes per thread and half,
//   from the stage).
// - Nibbles become bf16 without a convert: 0x4300 | q is the bf16 of
//   128 + q, and subtracting 136 leaves q - 8 exactly (magic-number dequant,
//   as the JAX kernel does in float32). bf16 x times q - 8 is exact in
//   float32, so the two bodies differ from their plain versions only in the
//   order of float32 sums.
// - Each stage's partial sum is folded into the running sum once, in both
//   bodies (the group body scales it there), so no mma chain spans more
//   than one stage, and so none more than one group.

#include <cooperative_groups.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

// The block's shape: output columns (32 a warp), packed rows a ring stage
// (where they divide the group, else 16), ring stages, the blocks an SM that
// the split count aims at, and the most splits (the cluster size) by batch
// tiles NB = 1..4. Chosen on the card at the LLaVA-1.5-7B decode shapes by
// scripts/sweep_q4_matmul_torch.py, which rewrites these lines.
constexpr int kCols = 64;
constexpr int kStageRows = 128;
constexpr int kStages = 2;
constexpr int kCtasPerSm = 4;
constexpr int kMaxSplits[4] = {8, 8, 8, 4};

constexpr int kQWarps = kCols / 32;
constexpr int kQThreads = 32 * kQWarps;
static_assert(kMaxSplits[0] >= 1 && kMaxSplits[0] <= 8 && kMaxSplits[1] >= 1 &&
                  kMaxSplits[1] <= 8 && kMaxSplits[2] >= 1 && kMaxSplits[2] <= 8 &&
                  kMaxSplits[3] >= 1 && kMaxSplits[3] <= 8,
              "1 to 8 splits: a cluster of a portable size");
static_assert(kCols == 32 || kCols == 64 || kCols == 128, "32, 64 or 128 columns a block");
static_assert(kStageRows % 16 == 0 && kStages >= 2, "whole k-steps a stage, two stages or more");

// A ring stage of SR packed rows (SR divides the group, so a stage lies in
// one group): the rows of the block's kCols columns, then the same rows of x
// for each of NB * 8 batch rows and both halves (bf16, rows of kXRow padded
// so that a warp's 8-byte reads of 4 batch rows fall in different banks).
// The ring then holds the block's partial sums (NB * 8 batch rows of kCols
// floats).
template <int NB, int SR>
struct Ring {
  static constexpr int kXRow = SR + 8;
  static constexpr int kWBytes = SR * kCols;
  static constexpr int kStageBytes = kWBytes + NB * 8 * 2 * kXRow * 2;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kPartBytes = NB * 8 * kCols * 4;
  static constexpr int kSmem = kRingBytes > kPartBytes ? kRingBytes : kPartBytes;
  static_assert(SR % 16 == 0 && kStageBytes % 16 == 0 && kSmem <= 227 * 1024,
                "whole k-steps, 16-byte stages, 227 KB");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte `b` of packed row `r` of a stage: rows of kCols bytes, bits 5 and 6
// flipped by bits 2 and 3 of the row. A warp's read of rows 4t + i (t =
// 0..3), 32 bytes each, then covers 32 banks; the flip stays inside one
// 128-byte line, so 16-byte chunks stay whole.
__device__ __forceinline__ int swz(int r, int b) { return (r * kCols + b) ^ (((r >> 2) & 3) << 5); }

__device__ __forceinline__ float4 ldg128(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bits_bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// bf16x2 (q0 - 8, q1 - 8) of the biased codes in bits 0-3 and 16-19 of v:
// (v & 0x000F000F) | 0x43004300 is bf16x2 (128 + q0, 128 + q1), exact, in one
// lop3 (the compiler splits it in two with both masks as immediates).
__device__ __forceinline__ uint32_t codes_to_bf16x2(uint32_t v) {
  uint32_t magic;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(magic) : "r"(v), "r"(0x000F000Fu), "r"(0x43004300u));
  return bf2_bits(__hsub2(bits_bf2(magic), bits_bf2(0x43084308u)));  // - (136, 136)
}

// Byte j (column j) of w0 and w1 (two neighbouring rows) as the bf16x2 pair
// of their low nibbles (W_lo) and of their high nibbles (W_hi), the first
// row in the low half of each register.
__device__ __forceinline__ void decode_pair(uint32_t w0, uint32_t w1, int j, uint32_t& lo,
                                            uint32_t& hi) {
  const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
  const uint32_t u = __byte_perm(w0, w1, sel);  // bytes w0[j], w0[j], w1[j], w1[j]
  lo = codes_to_bf16x2(u);
  hi = codes_to_bf16x2(u >> 4);
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Grid (splits, N / kCols), cluster (splits, 1, 1): blockIdx.x is the split
// and the block's rank in its cluster, blockIdx.y the column tile. SR, the
// stage's packed rows, divides the group size G.
template <int NB, int SR, bool SHIFT, bool OUT_BF16>
__global__ void __launch_bounds__(kQThreads)
q4_matmul_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ p,
                 const float* __restrict__ s, void* __restrict__ out, int B, int Kh, int N,
                 int ngh) {
  using R = Ring<NB, SR>;
  extern __shared__ __align__(16) unsigned char ring[];
  cg::cluster_group cluster = cg::this_cluster();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int splits = gridDim.x, rank = blockIdx.x;
  const int col0 = blockIdx.y * kCols;
  const int cb = 32 * warp + 4 * g;  // this thread's 4 columns, from the tile's first
  const int K = 2 * Kh;
  const int G = Kh / ngh;
  const int grp0 = rank * ngh / splits, grp1 = (rank + 1) * ngh / splits;
  const int row0 = grp0 * G;                      // the block's first packed row
  const int n_stages = (grp1 - grp0) * (G / SR);  // its stages, whole groups of them

  // Stage st (rows row0 + st * SR ..) into ring slot st % kStages: the
  // packed rows and x's B batch rows of both halves, 16 bytes a thread at a
  // time; one commit group a stage, empty past the end. Each thread's
  // chunks sit at the same offsets in every stage: computed once here.
  constexpr int kRowChunks = kCols / 16, kChunks = SR * kRowChunks;
  constexpr int kWPer = (kChunks + kQThreads - 1) / kQThreads;
  constexpr int kXChunks = SR / 8;  // of a (batch row, half) slice
  constexpr int kXPer = (2 * NB * 8 * kXChunks + kQThreads - 1) / kQThreads;
  int w_smem[kWPer], w_glob[kWPer], x_smem[kXPer], x_glob[kXPer];
#pragma unroll
  for (int i = 0; i < kWPer; ++i) {
    const int c = threadIdx.x + i * kQThreads;
    const int r = c / kRowChunks, b = (c % kRowChunks) * 16;
    w_smem[i] = c < kChunks ? swz(r, b) : -1;
    w_glob[i] = r * N + b;
  }
#pragma unroll
  for (int i = 0; i < kXPer; ++i) {
    const int c = threadIdx.x + i * kQThreads;
    const int bh = c / kXChunks, off = (c % kXChunks) * 8;  // bh = 2 b + half
    x_smem[i] = c < 2 * B * kXChunks ? R::kWBytes + 2 * (bh * R::kXRow + off) : -1;
    x_glob[i] = (bh >> 1) * K + (bh & 1) * Kh + off;
  }
  auto load_stage = [&](int st) {
    if (st < n_stages) {
      unsigned char* dst = ring + (st % kStages) * R::kStageBytes;
      const uint8_t* src = p + (size_t)(row0 + st * SR) * N + col0;
      const bf16* xsrc = x + row0 + st * SR;
#pragma unroll
      for (int i = 0; i < kWPer; ++i) {
        if (w_smem[i] >= 0) cp_async16(dst + w_smem[i], src + w_glob[i]);
      }
#pragma unroll
      for (int i = 0; i < kXPer; ++i) {
        if (x_smem[i] >= 0) cp_async16(dst + x_smem[i], xsrc + x_glob[i]);
      }
    }
    cp_async_commit();
  };
  // The scales of a group, loaded a group ahead of their use
  auto load_scales = [&](int grp, float4& lo, float4& hi) {
    lo = ldg128(s + (size_t)grp * N + col0 + cb);
    hi = ldg128(s + (size_t)(ngh + grp) * N + col0 + cb);
  };
  float4 slo, shi, next_lo, next_hi;
  load_scales(grp0, next_lo, next_hi);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) load_stage(st);

  // y[nb][mt][c]: column cb + 2 mt + (c >> 1), batch row 8 nb + 2t + (c & 1)
  float y[NB][2][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) y[nb][mt][c] = 0.f;
  uint32_t sb_lo[4], sb_hi[4];  // shift: each column's scale as bf16x2

  // The thread's shared-memory offsets in a stage: rows 4t + i of k-step 0
  // (k-step kk adds kk * 16 rows: the swizzle of rows 4t + i is that of
  // 16 kk + 4t + i) and x's rows 4t.. of batch row g, low half.
  int woff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) woff[i] = swz(4 * t + i, cb);
  const int xoff = 2 * g * R::kXRow + 4 * t;
  int next_grp = grp0;  // the group whose scales next_lo / next_hi hold
  int group_left = 0;   // stages left in the current group

  for (int st = 0; st < n_stages; ++st) {
    if (group_left-- == 0) {  // a new group: its scales, and the next one's on their way
      group_left = G / SR - 1;
      slo = next_lo;
      shi = next_hi;
      if (++next_grp < grp1) load_scales(next_grp, next_lo, next_hi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sb_lo[j] = bf2_bits(__float2bfloat162_rn(comp(slo, j)));
        sb_hi[j] = bf2_bits(__float2bfloat162_rn(comp(shi, j)));
      }
    }
    load_stage(st + kStages - 1);  // the slot that the last stage's sync freed
    cp_async_wait<kStages - 1>();  // this thread's copies of stage st are here
    __syncthreads();               // and every thread's
    const unsigned char* stage = ring + (st % kStages) * R::kStageBytes;
    const bf16* xs = reinterpret_cast<const bf16*>(stage + R::kWBytes) + xoff;
    float clo[NB][2][4], chi[NB][2][4];  // the stage's sums: one mma chain a stage
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) clo[nb][mt][c] = chi[nb][mt][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < SR / 16; ++kk) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = *reinterpret_cast<const uint32_t*>(stage + kk * 16 * kCols + woff[i]);
      }
      // A fragments: a[mt][h] rows r, r+1 and a[mt][2 + h] rows r+2, r+3 of
      // column j = 2 mt + h
      uint32_t alo[2][4], ahi[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t l01, h01, l23, h23;
        decode_pair(w[0], w[1], j, l01, h01);
        decode_pair(w[2], w[3], j, l23, h23);
        if (SHIFT) {
          l01 = bf2_bits(__hmul2(bits_bf2(l01), bits_bf2(sb_lo[j])));
          l23 = bf2_bits(__hmul2(bits_bf2(l23), bits_bf2(sb_lo[j])));
          h01 = bf2_bits(__hmul2(bits_bf2(h01), bits_bf2(sb_hi[j])));
          h23 = bf2_bits(__hmul2(bits_bf2(h23), bits_bf2(sb_hi[j])));
        }
        alo[j >> 1][j & 1] = l01;
        alo[j >> 1][2 + (j & 1)] = l23;
        ahi[j >> 1][j & 1] = h01;
        ahi[j >> 1][2 + (j & 1)] = h23;
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        // the B operand's column b = 8 nb + g: x's rows 4t..4t+3 of each half
        uint2 xl = make_uint2(0u, 0u), xh = make_uint2(0u, 0u);
        if (nb * 8 + g < B) {
          const bf16* xr = xs + nb * 16 * R::kXRow + kk * 16;
          xl = *reinterpret_cast<const uint2*>(xr);
          xh = *reinterpret_cast<const uint2*>(xr + R::kXRow);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(clo[nb][mt], alo[mt], xl.x, xl.y);
          mma16816(chi[nb][mt], ahi[mt], xh.x, xh.y);
        }
      }
    }
    // fold the stage in (the group body scales it here)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 2 * mt + (c >> 1);
          if (SHIFT) {
            y[nb][mt][c] += clo[nb][mt][c] + chi[nb][mt][c];
          } else {
            y[nb][mt][c] += clo[nb][mt][c] * comp(slo, j);
            y[nb][mt][c] += chi[nb][mt][c] * comp(shi, j);
          }
        }
    __syncthreads();  // every warp is done with this stage: it may be refilled
  }

  // The block's partial (batch row, column) sums, in the ring's place; then
  // block `rank` adds its share of the tile's B * kCols outputs over the
  // cluster's blocks in rank order, the peers' loads all issued first.
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        part[(nb * 8 + 2 * t + (c & 1)) * kCols + cb + 2 * mt + (c >> 1)] = y[nb][mt][c];
      }
  cluster.sync();  // every block's partials are written
  constexpr int kSplitsMost = kMaxSplits[NB - 1];  // splits <= this (choose_splits)
  const int total = B * kCols;
  const int e1 = (rank + 1) * total / splits;
  for (int e = rank * total / splits + threadIdx.x; e < e1; e += kQThreads) {
    float v[kSplitsMost];
#pragma unroll
    for (int src = 0; src < kSplitsMost; ++src) {
      if (src < splits) v[src] = cluster.map_shared_rank(part, src)[e];
    }
    float acc = 0.f;
#pragma unroll
    for (int src = 0; src < kSplitsMost; ++src) {
      if (src < splits) acc += v[src];  // fixed order
    }
    const int b = e / kCols, n = col0 + e % kCols;
    if (OUT_BF16) {
      reinterpret_cast<bf16*>(out)[(size_t)b * N + n] = __float2bfloat16_rn(acc);
    } else {
      reinterpret_cast<float*>(out)[(size_t)b * N + n] = acc;
    }
  }
  cluster.sync();  // no block leaves while a peer may still read its partials
}

int num_sms() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

// Splits of the K range: enough blocks for kCtasPerSm an SM, at most
// kMaxSplits[NB - 1] and one group a split.
int choose_splits(int nb, int tiles, int ngh) {
  const int want = (kCtasPerSm * num_sms() + tiles - 1) / tiles;
  return max(1, min(want, min(kMaxSplits[nb - 1], ngh)));
}

// Shared memory above 48 KB needs the kernel's opt-in; set once an
// instantiation.
template <class Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return err;
}

template <int NB, int SR, bool SHIFT, bool OUT_BF16>
cudaError_t launch(const bf16* x, const uint8_t* p, const float* s, void* out, int B, int Kh,
                   int N, int ngh, cudaStream_t stream) {
  auto kernel = q4_matmul_kernel<NB, SR, SHIFT, OUT_BF16>;
  constexpr int kSmem = Ring<NB, SR>::kSmem;
  static const cudaError_t prepared = prepare(kernel, kSmem);
  if (prepared != cudaSuccess) return prepared;
  const int tiles = N / kCols;
  const int splits = choose_splits(NB, tiles, ngh);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, tiles, 1);
  cfg.blockDim = dim3(kQThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, p, s, out, B, Kh, N, ngh);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int SR, bool SHIFT, bool OUT_BF16>
cudaError_t launch_nb(const bf16* x, const uint8_t* p, const float* s, void* out, int B, int Kh,
                      int N, int ngh, cudaStream_t stream) {
  switch ((B + 7) / 8) {
    case 1: return launch<1, SR, SHIFT, OUT_BF16>(x, p, s, out, B, Kh, N, ngh, stream);
    case 2: return launch<2, SR, SHIFT, OUT_BF16>(x, p, s, out, B, Kh, N, ngh, stream);
    case 3: return launch<3, SR, SHIFT, OUT_BF16>(x, p, s, out, B, Kh, N, ngh, stream);
    default: return launch<4, SR, SHIFT, OUT_BF16>(x, p, s, out, B, Kh, N, ngh, stream);
  }
}

// Stages of kStageRows packed rows where they divide the group, else of 16.
template <bool SHIFT, bool OUT_BF16>
cudaError_t launch_sr(const bf16* x, const uint8_t* p, const float* s, void* out, int B, int Kh,
                      int N, int ngh, cudaStream_t stream) {
  if ((Kh / ngh) % kStageRows == 0) {
    return launch_nb<kStageRows, SHIFT, OUT_BF16>(x, p, s, out, B, Kh, N, ngh, stream);
  }
  return launch_nb<16, SHIFT, OUT_BF16>(x, p, s, out, B, Kh, N, ngh, stream);
}

}  // namespace

// x: bf16 (B, 2 Kh); p: uint8 (Kh, N); s: float32 (2 ngh, N); out: (B, N),
// bf16 when out_bf16 else float32. shift != 0 selects the `_kernel` body.
// Takes 1 <= B <= 32, N a multiple of 128 and groups of a multiple of 16
// rows (G = Kh / ngh); returns cudaErrorInvalidValue otherwise. One launch.
extern "C" int q4_matmul(const void* x, const void* p, const void* s, void* out, int B, int Kh,
                         int N, int ngh, int out_bf16, int shift, void* stream) {
  if (B < 1 || B > 32 || N < 128 || N % 128 || ngh < 1 || Kh % ngh || (Kh / ngh) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t* pb = static_cast<const uint8_t*>(p);
  const float* sf = static_cast<const float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (shift) {
    err = out_bf16 ? launch_sr<true, true>(xb, pb, sf, out, B, Kh, N, ngh, st)
                   : launch_sr<true, false>(xb, pb, sf, out, B, Kh, N, ngh, st);
  } else {
    err = out_bf16 ? launch_sr<false, true>(xb, pb, sf, out, B, Kh, N, ngh, st)
                   : launch_sr<false, false>(xb, pb, sf, out, B, Kh, N, ngh, st);
  }
  return static_cast<int>(err);
}
