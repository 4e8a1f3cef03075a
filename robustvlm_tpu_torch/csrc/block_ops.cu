// One-pass LayerNorm and bias + activation for the CLIP block, forward and
// backward, on Hopper.
//
// Replaces no Pallas kernel. The JAX package leaves both chains to XLA,
// which fuses each into a pass or two; PyTorch runs them eagerly as chains
// of elementwise kernels. LayerNorm with float32 statistics was nine
// kernels forward (upcast, mean, var, subtract, rsqrt, two multiplies, an
// add and a downcast) and about fifteen backward, each moving a float32
// copy of the activation; the MLP's bias add and QuickGELU were four
// kernels over the (T, 4 x width) hidden, keeping both their input and the
// sigmoid for the backward. These kernels compute the same functions
// (models/clip/model.py's `layer_norm` and `act(h + fc_b)`; plain versions
// in ops/kernels/block_ops.py) in one pass each way.
//
// Bound: bytes. A few flops per element against 4 to 6 bytes moved in
// bf16. So each kernel reads its inputs once and writes its output once,
// with 16-byte loads and stores where the rows allow (width a multiple of
// 8 bf16 or 4 float32 values, 16-byte aligned rows; one element at a time
// otherwise), and nothing intermediate reaches device memory:
// - layer_norm_fwd: one row per warp, or per 2, 4 or 8 warps for rows past
//   1024 values (up to 8192), held in registers (8 to 32 values a lane), so
//   the mean and then the biased variance are taken in float32 from
//   registers; writes y in x's dtype and the row's float32 mean and rstd,
//   which the backward reads instead of an activation-sized residual.
//   Rows may be strided (`ln_post` takes x[:, 0]).
// - layer_norm_bwd: x and dy of a row in registers; x-hat rebuilt from the
//   saved statistics; dx = rstd (dy g - mean(dy g) - x-hat mean(dy g x-hat))
//   in float32, written once. The gain and bias gradients (only when asked
//   for) are summed per row slot in registers over a fixed set of rows,
//   written as float32 partials, and summed over the slots by
//   sum_slots_kernel in a fixed order: no atomics, so a backward repeats
//   bitwise on one card.
// - bias_act_fwd: z = h + bias rounded to h's dtype (as `h + bias.to(dtype)`
//   rounds it), then QuickGELU z sigmoid(1.702 z), the exact erf GELU or
//   ReLU (OPT's MLP) in float32, rounded once. A thread owns 8 (bf16) or 4 (float32) columns
//   and keeps their bias in registers over its rows; several rows are
//   loaded before any is computed, to keep loads in flight.
// - bias_act_bwd: z and the activation's derivative recomputed from h and
//   the bias (nothing but h is saved), dh = dy act'(z) written once; the
//   bias gradient (only when asked for) as float32 partials per row slice,
//   summed by sum_slots_kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

template <typename T>
struct Tag {
  using type = T;
};
template <int N>
using Int = std::integral_constant<int, N>;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// N consecutive elements at p into float r[N]: 16-byte words where N
// elements fill whole words (the caller guarantees their alignment), one
// element at a time otherwise.
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* __restrict__ p, float* r) {
  if constexpr ((N * sizeof(T)) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int w = 0; w < N / kPer; ++w) {
      alignas(16) T e[kPer];
      *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(p)[w];
#pragma unroll
      for (int i = 0; i < kPer; ++i) r[w * kPer + i] = to_f(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = to_f(p[i]);
  }
}

template <int N, typename T>
__device__ __forceinline__ void store_n(T* __restrict__ p, const float* r) {
  if constexpr ((N * sizeof(T)) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int w = 0; w < N / kPer; ++w) {
      alignas(16) T e[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) e[i] = from_f<T>(r[w * kPer + i]);
      reinterpret_cast<uint4*>(p)[w] = *reinterpret_cast<const uint4*>(e);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = from_f<T>(r[i]);
  }
}

// xor butterfly: float addition commutes exactly, so every lane ends with
// the same value
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ================================================================ LayerNorm
constexpr int kLnThreads = 256;
constexpr int kLnWarps = kLnThreads / 32;
constexpr int kLnBwdMinBlocks = 2;  // resident blocks an SM asked of the dx-only backward

// Sums v[] over the wpr warps that share a row, in warp order (every warp
// of the row gets the same values). wpr is uniform over the block, so the
// barriers are reached by every thread.
template <int K>
__device__ __forceinline__ void row_sum(float (&v)[K], float* smem, int warp, int lane, int wpr) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (wpr > 1) {
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) smem[warp * K + k] = v[k];
    }
    __syncthreads();
    const int first = warp - warp % wpr;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = 0.f;
      for (int j = 0; j < wpr; ++j) s += smem[(first + j) * K + k];
      v[k] = s;
    }
    __syncthreads();
  }
}

// A row of `width` values is held by wpr warps, E values a lane in chunks of
// VEC: value ((c * wpr + part) * 32 + lane) * VEC + i, so a warp's lanes
// touch consecutive 16-byte words.
template <typename T, int VEC, int E>
__global__ void __launch_bounds__(kLnThreads)
layer_norm_fwd_kernel(const T* __restrict__ x, long long x_stride, const float* __restrict__ g,
                      const float* __restrict__ b, T* __restrict__ y, float* __restrict__ mean,
                      float* __restrict__ rstd, long long rows, int width, int wpr, float eps) {
  constexpr int kChunks = E / VEC;
  __shared__ float smem[kLnWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = warp % wpr;
  const long long row = (long long)blockIdx.x * (kLnWarps / wpr) + warp / wpr;
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * x_stride;
  float v[E];
  float s[1] = {0.f};
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = ((c * wpr + part) * 32 + lane) * VEC;
    if (live && col < width) {
      load_n<VEC>(xr + col, v + c * VEC);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[c * VEC + i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) s[0] += v[c * VEC + i];
  }
  row_sum(s, smem, warp, lane, wpr);
  const float mu = s[0] / (float)width;
  float q[1] = {0.f};
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = ((c * wpr + part) * 32 + lane) * VEC;
    if (col < width) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[c * VEC + i] - mu;
        q[0] += d * d;
      }
    }
  }
  row_sum(q, smem, warp, lane, wpr);
  const float rs = rsqrtf(q[0] / (float)width + eps);
  if (!live) return;
  T* yr = y + row * (long long)width;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = ((c * wpr + part) * 32 + lane) * VEC;
    if (col < width) {
      float gv[VEC], bv[VEC], o[VEC];
      load_n<VEC>(g + col, gv);
      load_n<VEC>(b + col, bv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = (v[c * VEC + i] - mu) * rs * gv[i] + bv[i];
      store_n<VEC>(yr + col, o);
    }
  }
  if (part == 0 && lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// Row slots: the block's kLnWarps / wpr rows, walked over the grid (rows
// base, base + gridDim.x * rows a block, ...). With kWeights each slot sums
// dy x-hat and dy of its rows into part[slot] = [dg (width) | db (width)].
template <typename T, int VEC, int E, bool kWeights>
__global__ void __launch_bounds__(kLnThreads, kWeights ? 1 : kLnBwdMinBlocks)
layer_norm_bwd_kernel(const T* __restrict__ x, long long x_stride, const T* __restrict__ dy,
                      const float* __restrict__ g, const float* __restrict__ mean,
                      const float* __restrict__ rstd, T* __restrict__ dx, float* __restrict__ part,
                      long long rows, int width, int wpr) {
  constexpr int kChunks = E / VEC;
  constexpr int kAcc = kWeights ? E : 1;
  __shared__ float smem[kLnWarps * 2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows_per_block = kLnWarps / wpr;
  const int part_of_row = warp % wpr, slot_row = warp / wpr;
  const float inv_w = 1.f / (float)width;
  float adg[kAcc], adb[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) adg[i] = adb[i] = 0.f;
  for (long long base = (long long)blockIdx.x * rows_per_block; base < rows;
       base += (long long)gridDim.x * rows_per_block) {
    const long long row = base + slot_row;
    const bool live = row < rows;
    const long long r = live ? row : 0;
    float xh[E], wd[E];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = ((c * wpr + part_of_row) * 32 + lane) * VEC;
      if (live && col < width) {
        load_n<VEC>(x + r * x_stride + col, xh + c * VEC);
        load_n<VEC>(dy + r * (long long)width + col, wd + c * VEC);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) xh[c * VEC + i] = wd[c * VEC + i] = 0.f;
      }
    }
    const float mu = live ? mean[r] : 0.f;
    const float rs = live ? rstd[r] : 0.f;
    float sums[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = ((c * wpr + part_of_row) * 32 + lane) * VEC;
      float gv[VEC];
      if (col < width) {
        load_n<VEC>(g + col, gv);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) gv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int k = c * VEC + i;
        const float d = wd[k];
        xh[k] = (xh[k] - mu) * rs;  // a masked value has d = 0 and adds nothing
        if constexpr (kWeights) {
          adg[k] += d * xh[k];
          adb[k] += d;
        }
        wd[k] = d * gv[i];
        sums[0] += wd[k];
        sums[1] += wd[k] * xh[k];
      }
    }
    row_sum(sums, smem, warp, lane, wpr);
    const float a = sums[0] * inv_w, cc = sums[1] * inv_w;
    if (live) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = ((c * wpr + part_of_row) * 32 + lane) * VEC;
        if (col < width) {
          float o[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const int k = c * VEC + i;
            o[i] = rs * (wd[k] - a - xh[k] * cc);
          }
          store_n<VEC>(dx + row * (long long)width + col, o);
        }
      }
    }
  }
  if constexpr (kWeights) {
    float* p = part + ((long long)blockIdx.x * rows_per_block + slot_row) * 2LL * width;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = ((c * wpr + part_of_row) * 32 + lane) * VEC;
      if (col < width) {
        store_n<VEC>(p + col, adg + c * VEC);
        store_n<VEC>(p + width + col, adb + c * VEC);
      }
    }
  }
}

// ========================================================== slot reduction
constexpr int kSumThreads = 256;
constexpr int kSumWarps = kSumThreads / 32;

// out[col] = the sum over slots of part[slot * n + col] in a fixed order:
// warp w takes slots w, w + 8, ...; then warp 0 adds the 8 in warp order.
// Columns below n0 go to out0, the rest to out1[col - n0].
__global__ void __launch_bounds__(kSumThreads)
sum_slots_kernel(const float* __restrict__ part, long long slots, int n, float* __restrict__ out0,
                 float* __restrict__ out1, int n0) {
  __shared__ float smem[kSumWarps][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < n) {
#pragma unroll 8
    for (long long k = warp; k < slots; k += kSumWarps) s += part[k * n + col];
  }
  smem[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < n) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) t += smem[w][lane];
    if (col < n0) {
      out0[col] = t;
    } else {
      out1[col - n0] = t;
    }
  }
}

// ========================================================= bias + activation
constexpr int kActThreads = 256;
// rows loaded before any is computed: the forward keeps more loads in flight
// (one input), the backward fewer (two inputs, and registers for occupancy);
// from variants timed on the card at the ViT-L/14 cells' shapes
constexpr int kActFwdRows = 8;
constexpr int kActBwdRows = 2;
constexpr float kQuickAlpha = 1.702f;
// the activation, as the C interface's `act` names it
constexpr int kGelu = 0, kQuick = 1, kRelu = 2;

// The exponential and the division by the hardware's approximations (a few
// float32 ulp): a full-precision division costs as many instructions as the
// rest of the element, and the kernels would no longer be bound by bytes.
// ReLU is exact; its backward passes dy where z > 0 and +0 elsewhere (a
// select, as PyTorch's relu backward takes it, not dy * 0, which is -0 for
// a negative dy).
template <int kAct>
__device__ __forceinline__ float act(float z) {
  if constexpr (kAct == kQuick) {
    return __fdividef(z, 1.f + __expf(-kQuickAlpha * z));  // z sigmoid(1.702 z)
  } else if constexpr (kAct == kRelu) {
    return fmaxf(z, 0.f);
  } else {
    return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
  }
}

template <int kAct>
__device__ __forceinline__ float act_grad(float z) {
  if constexpr (kAct == kQuick) {
    const float s = __fdividef(1.f, 1.f + __expf(-kQuickAlpha * z));
    return s * (1.f + kQuickAlpha * z * (1.f - s));
  } else {
    return 0.5f * (1.f + erff(z * 0.70710678118654752f)) +
           z * 0.39894228040143268f * __expf(-0.5f * z * z);
  }
}

// dy act'(z)
template <int kAct>
__device__ __forceinline__ float act_bwd(float z, float dy) {
  if constexpr (kAct == kRelu) {
    return z > 0.f ? dy : 0.f;
  } else {
    return dy * act_grad<kAct>(z);
  }
}

// Thread (blockIdx.x, threadIdx.x) owns columns col .. col + VEC - 1; block
// row blockIdx.y walks rows blockIdx.y, + gridDim.y, ..., kActFwdRows (or
// kActBwdRows) at a time.
template <typename T, int VEC, int kAct>
__global__ void __launch_bounds__(kActThreads)
bias_act_fwd_kernel(const T* __restrict__ h, const float* __restrict__ bias, T* __restrict__ out,
                    long long rows, int n) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (col >= n) return;
  float bv[VEC];
  load_n<VEC>(bias + col, bv);
#pragma unroll
  for (int i = 0; i < VEC; ++i) bv[i] = to_f(from_f<T>(bv[i]));  // bias.to(h.dtype)
  const long long step = gridDim.y;
  for (long long r0 = blockIdx.y; r0 < rows; r0 += step * kActFwdRows) {
    float v[kActFwdRows][VEC];
#pragma unroll
    for (int u = 0; u < kActFwdRows; ++u) {
      const long long r = r0 + u * step;
      if (r < rows) load_n<VEC>(h + r * n + col, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kActFwdRows; ++u) {
      const long long r = r0 + u * step;
      if (r < rows) {
        float o[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) o[i] = act<kAct>(to_f(from_f<T>(v[u][i] + bv[i])));
        store_n<VEC>(out + r * n + col, o);
      }
    }
  }
}

// With kBias, block row blockIdx.y sums the rounded dh of its rows into
// part[blockIdx.y * n + col].
template <typename T, int VEC, int kAct, bool kBias>
__global__ void __launch_bounds__(kActThreads)
bias_act_bwd_kernel(const T* __restrict__ h, const float* __restrict__ bias, const T* __restrict__ dy,
                    T* __restrict__ dh, float* __restrict__ part, long long rows, int n) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (col >= n) return;
  float bv[VEC];
  load_n<VEC>(bias + col, bv);
#pragma unroll
  for (int i = 0; i < VEC; ++i) bv[i] = to_f(from_f<T>(bv[i]));
  float acc[kBias ? VEC : 1];
#pragma unroll
  for (int i = 0; i < (kBias ? VEC : 1); ++i) acc[i] = 0.f;
  const long long step = gridDim.y;
  for (long long r0 = blockIdx.y; r0 < rows; r0 += step * kActBwdRows) {
    float hv[kActBwdRows][VEC], dv[kActBwdRows][VEC];
#pragma unroll
    for (int u = 0; u < kActBwdRows; ++u) {
      const long long r = r0 + u * step;
      if (r < rows) {
        load_n<VEC>(h + r * n + col, hv[u]);
        load_n<VEC>(dy + r * n + col, dv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kActBwdRows; ++u) {
      const long long r = r0 + u * step;
      if (r < rows) {
        float o[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float z = to_f(from_f<T>(hv[u][i] + bv[i]));
          o[i] = to_f(from_f<T>(act_bwd<kAct>(z, dv[u][i])));
          if constexpr (kBias) acc[i] += o[i];
        }
        store_n<VEC>(dh + r * n + col, o);
      }
    }
  }
  if constexpr (kBias) store_n<VEC>(part + (long long)blockIdx.y * n + col, acc);
}

// ================================================================== launch
template <typename F>
void with_type(int dtype, int vec, F&& f) {
  if (dtype == 1) {
    if (vec) f(Tag<bf16>{}, Int<8>{}); else f(Tag<bf16>{}, Int<1>{});
  } else {
    if (vec) f(Tag<float>{}, Int<4>{}); else f(Tag<float>{}, Int<1>{});
  }
}

template <typename F>
void with_e(int e, F&& f) {
  switch (e) {
    case 8: f(Int<8>{}); break;
    case 16: f(Int<16>{}); break;
    case 24: f(Int<24>{}); break;
    default: f(Int<32>{}); break;
  }
}

template <typename F>
void with_bool(bool v, F&& f) {
  if (v) f(std::true_type{}); else f(std::false_type{});
}

template <typename F>
void with_act(int a, F&& f) {
  switch (a) {
    case kQuick: f(Int<kQuick>{}); break;
    case kRelu: f(Int<kRelu>{}); break;
    default: f(Int<kGelu>{}); break;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// warps a row (1, 2, 4 or 8) and values a lane (8, 16, 24 or 32)
struct LnShape {
  int wpr, e;
};
LnShape ln_shape(int width) {
  int wpr = 1;
  while (wpr * 32 * 32 < width) wpr *= 2;
  const int per = (width + wpr * 32 - 1) / (wpr * 32);
  return {wpr, (per + 7) / 8 * 8};
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The weight-gradient backward's grid: as many blocks as fit on the card at
// once (each walks its rows), never more than the rows need.
long long ln_weight_blocks(long long rows, int width, int dtype, int vec) {
  const LnShape s = ln_shape(width);
  const int rpb = kLnWarps / s.wpr;
  int per_sm = 1;
  with_type(dtype, vec, [&](auto tag, auto v) {
    using T = typename decltype(tag)::type;
    constexpr int VEC = decltype(v)::value;
    with_e(s.e, [&](auto ec) {
      constexpr int E = decltype(ec)::value;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layer_norm_bwd_kernel<T, VEC, E, true>,
                                                    kLnThreads, 0);
    });
  });
  const long long cap = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  const long long need = cdiv(rows, rpb);
  return need < cap ? (need > 0 ? need : 1) : cap;
}

struct ActGrid {
  int threads;
  dim3 grid;
};
// a row slice per blockIdx.y: enough blocks for eight of 256 threads an SM
ActGrid act_grid(long long rows, int n, int vec_n) {
  const long long per_row = cdiv(n, vec_n);
  int threads = (int)(cdiv(per_row, 32) * 32);
  if (threads > kActThreads) threads = kActThreads;
  const long long gx = cdiv(per_row, threads);
  long long gy = (long long)sm_count() * 8 * kActThreads / threads / gx;
  if (gy < 1) gy = 1;
  if (gy > rows) gy = rows > 0 ? rows : 1;
  if (gy > 65535) gy = 65535;
  return {threads, dim3((unsigned)gx, (unsigned)gy)};
}

void sum_slots(const float* part, long long slots, int n, float* out0, float* out1, int n0,
               cudaStream_t s) {
  sum_slots_kernel<<<(unsigned)cdiv(n, 32), kSumThreads, 0, s>>>(part, slots, n, out0, out1, n0);
}

}  // namespace

// Every pointer is a device pointer. dtype: 0 float32, 1 bfloat16 (x, y, dy,
// dx, h, out, dh); g, b, bias, mean, rstd and the gradients of g, b and bias
// are float32. vec selects 16-byte accesses (the caller checks the width,
// the row stride and every pointer's alignment). Each function returns
// cudaGetLastError() after its launches.

// Rows of the weight-gradient partials that layer_norm_bwd (kind 0) or
// bias_act_bwd (kind 1) writes for these shapes: the caller allocates
// float32 (slots, 2 * width) or (slots, width) for `part`.
extern "C" long long block_ops_slots(int kind, long long rows, int width, int dtype, int vec) {
  if (kind == 0) return ln_weight_blocks(rows, width, dtype, vec) * (kLnWarps / ln_shape(width).wpr);
  return act_grid(rows, width, vec ? (dtype == 1 ? 8 : 4) : 1).grid.y;
}

// y (rows, width) contiguous; x rows x_stride elements apart; mean and
// rstd (rows,). width at most 8192.
extern "C" int layer_norm_fwd(const void* x, long long x_stride, const void* g, const void* b,
                              void* y, void* mean, void* rstd, long long rows, int width, float eps,
                              int dtype, int vec, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LnShape sh = ln_shape(width);
  const unsigned blocks = (unsigned)cdiv(rows, kLnWarps / sh.wpr);
  with_type(dtype, vec, [&](auto tag, auto v) {
    using T = typename decltype(tag)::type;
    constexpr int VEC = decltype(v)::value;
    with_e(sh.e, [&](auto ec) {
      constexpr int E = decltype(ec)::value;
      layer_norm_fwd_kernel<T, VEC, E><<<blocks, kLnThreads, 0, s>>>(
          static_cast<const T*>(x), x_stride, static_cast<const float*>(g),
          static_cast<const float*>(b), static_cast<T*>(y), static_cast<float*>(mean),
          static_cast<float*>(rstd), rows, width, sh.wpr, eps);
    });
  });
  return static_cast<int>(cudaGetLastError());
}

// dx and dy (rows, width) contiguous. With part (block_ops_slots(0, ...)
// rows of 2 * width floats), also dg and db (width,).
extern "C" int layer_norm_bwd(const void* x, long long x_stride, const void* dy, const void* g,
                              const void* mean, const void* rstd, void* dx, void* part, void* dg,
                              void* db, long long rows, int width, int dtype, int vec, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LnShape sh = ln_shape(width);
  const int rpb = kLnWarps / sh.wpr;
  const bool weights = part != nullptr;
  const long long blocks = weights ? ln_weight_blocks(rows, width, dtype, vec) : cdiv(rows, rpb);
  with_type(dtype, vec, [&](auto tag, auto v) {
    using T = typename decltype(tag)::type;
    constexpr int VEC = decltype(v)::value;
    with_e(sh.e, [&](auto ec) {
      constexpr int E = decltype(ec)::value;
      with_bool(weights, [&](auto wc) {
        constexpr bool W = decltype(wc)::value;
        layer_norm_bwd_kernel<T, VEC, E, W><<<(unsigned)blocks, kLnThreads, 0, s>>>(
            static_cast<const T*>(x), x_stride, static_cast<const T*>(dy),
            static_cast<const float*>(g), static_cast<const float*>(mean),
            static_cast<const float*>(rstd), static_cast<T*>(dx), static_cast<float*>(part), rows,
            width, sh.wpr);
      });
    });
  });
  if (weights) {
    sum_slots(static_cast<const float*>(part), blocks * rpb, 2 * width, static_cast<float*>(dg),
              static_cast<float*>(db), width, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// h and out (rows, n) contiguous; bias (n,). act: 0 the exact erf GELU, 1
// QuickGELU, 2 ReLU.
extern "C" int bias_act_fwd(const void* h, const void* bias, void* out, long long rows, int n,
                            int act, int dtype, int vec, void* stream) {
  if (act < kGelu || act > kRelu) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_type(dtype, vec, [&](auto tag, auto v) {
    using T = typename decltype(tag)::type;
    constexpr int VEC = decltype(v)::value;
    const ActGrid ag = act_grid(rows, n, VEC);
    with_act(act, [&](auto ac) {
      constexpr int A = decltype(ac)::value;
      bias_act_fwd_kernel<T, VEC, A><<<ag.grid, ag.threads, 0, s>>>(
          static_cast<const T*>(h), static_cast<const float*>(bias), static_cast<T*>(out), rows, n);
    });
  });
  return static_cast<int>(cudaGetLastError());
}

// dy and dh (rows, n) contiguous. With part (block_ops_slots(1, ...) rows of
// n floats), also dbias (n,).
extern "C" int bias_act_bwd(const void* h, const void* bias, const void* dy, void* dh, void* part,
                            void* dbias, long long rows, int n, int act, int dtype, int vec,
                            void* stream) {
  if (act < kGelu || act > kRelu) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool with_bias = part != nullptr;
  long long slots = 0;
  with_type(dtype, vec, [&](auto tag, auto v) {
    using T = typename decltype(tag)::type;
    constexpr int VEC = decltype(v)::value;
    const ActGrid ag = act_grid(rows, n, VEC);
    slots = ag.grid.y;
    with_act(act, [&](auto ac) {
      constexpr int A = decltype(ac)::value;
      with_bool(with_bias, [&](auto bc) {
        constexpr bool B = decltype(bc)::value;
        bias_act_bwd_kernel<T, VEC, A, B><<<ag.grid, ag.threads, 0, s>>>(
            static_cast<const T*>(h), static_cast<const float*>(bias), static_cast<const T*>(dy),
            static_cast<T*>(dh), static_cast<float*>(part), rows, n);
      });
    });
  });
  if (with_bias) {
    sum_slots(static_cast<const float*>(part), slots, n, static_cast<float*>(dbias), nullptr, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}
