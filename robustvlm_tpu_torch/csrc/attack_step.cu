// Fused l-inf APGD/PGD iterate update on Hopper.
//
// Replaces robustvlm_tpu/ops/pallas/attack_step.py: _pallas_linf_step
// (kernel body _kernel). Semantics are _linf_step_jnp of the same file,
// bit for bit in float32:
//   z  = clip(min(max(x_adv + step*sign(g), x-eps), x+eps), 0, 1)
//   xn = x_adv + (z - x_adv)*a + (x_adv - x_old)*(1-a)
//   out = clip(min(max(xn, x-eps), x+eps), 0, 1)
//
// Bound: bytes. Four float32 reads and one write per element, 20 bytes, and
// one multiply-add chain of ~12 flops: far below the card's
// operations-per-byte line. One pass over (B, F), 16-byte loads where F is a
// multiple of 4, so each input is read once and nothing intermediate touches
// device memory. Any B and F: the ragged edge is masked (the Pallas version
// required B % 8 == 0 and F % 128 == 0).
//
// Rounding: every operation is an explicit round-to-nearest intrinsic
// (__fadd_rn, __fmul_rn, __fsub_rn), which nvcc never contracts into an FMA,
// in the evaluation order of the JAX expression. sign() is jnp.sign (NaN
// stays NaN, a zero keeps its sign) and max/min propagate NaN like XLA's,
// so a NaN gradient propagates as it does in JAX.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float jnp_sign(float g) {
  return g > 0.f ? 1.f : (g < 0.f ? -1.f : g);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float step_one(float xa, float xo, float g, float xv,
                                          float st, float eps, float a,
                                          float one_minus_a) {
  const float lo = __fsub_rn(xv, eps);
  const float hi = __fadd_rn(xv, eps);
  float z = __fadd_rn(xa, __fmul_rn(st, jnp_sign(g)));
  z = min_nan(max_nan(min_nan(max_nan(z, lo), hi), 0.f), 1.f);
  const float xn = __fadd_rn(__fadd_rn(xa, __fmul_rn(__fsub_rn(z, xa), a)),
                             __fmul_rn(__fsub_rn(xa, xo), one_minus_a));
  return min_nan(max_nan(min_nan(max_nan(xn, lo), hi), 0.f), 1.f);
}

__global__ void linf_step_scalar(const float* __restrict__ x_adv,
                                 const float* __restrict__ x_old,
                                 const float* __restrict__ grad,
                                 const float* __restrict__ x,
                                 const float* __restrict__ step, float eps,
                                 float a, float* __restrict__ out,
                                 long long total, long long f) {
  const float one_minus_a = __fsub_rn(1.f, a);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = step_one(x_adv[i], x_old[i], grad[i], x[i], step[i / f], eps, a,
                      one_minus_a);
  }
}

// F % 4 == 0 and 16-byte aligned pointers: four elements of one row a thread.
__global__ void linf_step_vec4(const float4* __restrict__ x_adv,
                               const float4* __restrict__ x_old,
                               const float4* __restrict__ grad,
                               const float4* __restrict__ x,
                               const float* __restrict__ step, float eps,
                               float a, float4* __restrict__ out,
                               long long total4, long long f4) {
  const float one_minus_a = __fsub_rn(1.f, a);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total4;
       i += (long long)gridDim.x * blockDim.x) {
    const float st = step[i / f4];
    const float4 xa = x_adv[i], xo = x_old[i], g = grad[i], xv = x[i];
    float4 r;
    r.x = step_one(xa.x, xo.x, g.x, xv.x, st, eps, a, one_minus_a);
    r.y = step_one(xa.y, xo.y, g.y, xv.y, st, eps, a, one_minus_a);
    r.z = step_one(xa.z, xo.z, g.z, xv.z, st, eps, a, one_minus_a);
    r.w = step_one(xa.w, xo.w, g.w, xv.w, st, eps, a, one_minus_a);
    out[i] = r;
  }
}

constexpr int kThreads = 256;

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // enough resident blocks to fill the card
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

// All pointers are device pointers to contiguous float32 (B, F) arrays,
// `step` is (B,). `vec4` selects the 16-byte path (the caller checks
// F % 4 == 0 and alignment). Returns cudaGetLastError() after the launch.
extern "C" int linf_step(const void* x_adv, const void* x_old, const void* grad,
                         const void* x, const void* step, float eps, float a,
                         void* out, long long b, long long f, int vec4,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = b * f;
  if (total <= 0) return 0;
  if (vec4) {
    const long long total4 = total / 4;
    linf_step_vec4<<<grid_for(total4), kThreads, 0, s>>>(
        static_cast<const float4*>(x_adv), static_cast<const float4*>(x_old),
        static_cast<const float4*>(grad), static_cast<const float4*>(x),
        static_cast<const float*>(step), eps, a, static_cast<float4*>(out),
        total4, f / 4);
  } else {
    linf_step_scalar<<<grid_for(total), kThreads, 0, s>>>(
        static_cast<const float*>(x_adv), static_cast<const float*>(x_old),
        static_cast<const float*>(grad), static_cast<const float*>(x),
        static_cast<const float*>(step), eps, a, static_cast<float*>(out),
        total, f);
  }
  return static_cast<int>(cudaGetLastError());
}
