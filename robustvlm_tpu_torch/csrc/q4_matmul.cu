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
// weight to memory.
//
// Design:
// - A block owns 32 output columns and every row of x. Its 8 warps split the
//   groups (warp w takes groups w, w + 8, ...); the 8 partial sums are added
//   in shared memory in warp order: no atomics, bitwise repeatable.
// - mma.sync m16n8k16 (bf16 operands, float32 accumulators) computes out^T:
//   the weight is the A operand (16 columns x 16 rows), x the B operand (16
//   rows x 8 batch rows), so B = 1..8 takes one batch tile; NB tiles cover
//   B <= 32 (template NB).
// - The fragments' row and column order is free as long as A, B and C agree:
//   thread (g, t) of a warp takes rows 4t..4t+3 of a 16-row k-step and
//   columns 4g..4g+3 of the block's 32 (its A rows m = g and g + 8 of two
//   16-column tiles). Its weight fragment is then four 32-bit loads, one per
//   row, a warp's load of a row being 32 contiguous bytes; x follows the
//   same row order (8 bytes per thread and half).
// - Nibbles become bf16 without a convert: 0x4300 | q is the bf16 of
//   128 + q, and subtracting 136 leaves q - 8 exactly (magic-number dequant,
//   as the JAX kernel does in float32). bf16 x times q - 8 is exact in
//   float32, so the two bodies differ from their plain versions only in the
//   order of float32 sums.
// - The 16-row k-steps of a group (8 at G = 128) are loaded before they are
//   used, 32 words a thread in flight. Each group's partial sum is folded
//   into the running sum once, in both bodies, so no mma chain spans more
//   than one group.

#include "mma_bf16.cuh"

namespace {

constexpr int kQWarps = 8;
constexpr int kQThreads = 32 * kQWarps;
constexpr int kQCols = 32;   // output columns per block
constexpr int kQAhead = 8;   // 16-row k-steps loaded ahead

__device__ __forceinline__ uint32_t ldg32(const uint8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint2 ldg64(const bf16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bits_bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// bf16x2 (q0 - 8, q1 - 8) of the biased codes in bits 0-3 and 16-19 of v.
__device__ __forceinline__ uint32_t codes_to_bf16x2(uint32_t v) {
  const uint32_t magic = (v & 0x000F000Fu) | 0x43004300u;  // 128 + q, exact
  return bf2_bits(__hsub2(bits_bf2(magic), __floats2bfloat162_rn(136.f, 136.f)));
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

template <int NB, bool SHIFT, bool OUT_BF16>
__global__ void __launch_bounds__(kQThreads)
q4_matmul_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ p,
                 const float* __restrict__ s, void* __restrict__ out, int B, int Kh, int N,
                 int ngh) {
  __shared__ float red[kQWarps][NB * 8][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col = blockIdx.x * kQCols + 4 * g;  // this thread's 4 columns
  const int K = 2 * Kh;
  const int G = Kh / ngh;
  const int nks = G / 16;

  // y[nb][mt][c]: column 4g + 2 mt + (c >> 1), batch row 8 nb + 2t + (c & 1)
  float y[NB][2][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) y[nb][mt][c] = 0.f;

  for (int grp = warp; grp < ngh; grp += kQWarps) {
    const float4 slo = *reinterpret_cast<const float4*>(s + (size_t)grp * N + col);
    const float4 shi = *reinterpret_cast<const float4*>(s + (size_t)(ngh + grp) * N + col);
    uint32_t sb_lo[4], sb_hi[4];  // shift: each column's scale as bf16x2
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sb_lo[j] = bf2_bits(__float2bfloat162_rn(comp(slo, j)));
      sb_hi[j] = bf2_bits(__float2bfloat162_rn(comp(shi, j)));
    }
    float clo[NB][2][4], chi[NB][2][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) clo[nb][mt][c] = chi[nb][mt][c] = 0.f;

    for (int k0 = 0; k0 < nks; k0 += kQAhead) {
      uint32_t w[kQAhead][4];
#pragma unroll
      for (int u = 0; u < kQAhead; ++u) {
        if (k0 + u < nks) {
          const uint8_t* src = p + (size_t)(grp * G + (k0 + u) * 16 + 4 * t) * N + col;
#pragma unroll
          for (int i = 0; i < 4; ++i) w[u][i] = ldg32(src + (size_t)i * N);
        }
      }
#pragma unroll
      for (int u = 0; u < kQAhead; ++u) {
        if (k0 + u < nks) {
          const int r = grp * G + (k0 + u) * 16 + 4 * t;  // first of the thread's 4 rows
          // A fragments: a[mt][h] rows r, r+1 and a[mt][2 + h] rows r+2, r+3
          // of column j = 2 mt + h
          uint32_t alo[2][4], ahi[2][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t l01, h01, l23, h23;
            decode_pair(w[u][0], w[u][1], j, l01, h01);
            decode_pair(w[u][2], w[u][3], j, l23, h23);
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
            const int b = nb * 8 + g;  // the B operand's column
            uint2 xl = make_uint2(0u, 0u), xh = make_uint2(0u, 0u);
            if (b < B) {
              xl = ldg64(x + (size_t)b * K + r);
              xh = ldg64(x + (size_t)b * K + Kh + r);
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma16816(clo[nb][mt], alo[mt], xl.x, xl.y);
              mma16816(chi[nb][mt], ahi[mt], xh.x, xh.y);
            }
          }
        }
      }
    }
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
  }

#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[warp][(nb * 2 + mt) * 4 + c][lane] = y[nb][mt][c];
  __syncthreads();
  for (int e = threadIdx.x; e < NB * 8 * 32; e += kQThreads) {
    const int idx = e >> 5, ln = e & 31;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kQWarps; ++w) acc += red[w][idx][ln];  // fixed order
    const int nb = idx >> 3, mt = (idx >> 2) & 1, c = idx & 3;
    const int b = nb * 8 + 2 * (ln & 3) + (c & 1);
    const int n = blockIdx.x * kQCols + 4 * (ln >> 2) + 2 * mt + (c >> 1);
    if (b < B) {
      if (OUT_BF16) {
        reinterpret_cast<bf16*>(out)[(size_t)b * N + n] = __float2bfloat16_rn(acc);
      } else {
        reinterpret_cast<float*>(out)[(size_t)b * N + n] = acc;
      }
    }
  }
}

template <int NB, bool SHIFT, bool OUT_BF16>
cudaError_t launch(const bf16* x, const uint8_t* p, const float* s, void* out, int B, int Kh,
                   int N, int ngh, cudaStream_t stream) {
  q4_matmul_kernel<NB, SHIFT, OUT_BF16>
      <<<N / kQCols, kQThreads, 0, stream>>>(x, p, s, out, B, Kh, N, ngh);
  return cudaGetLastError();
}

template <bool SHIFT, bool OUT_BF16>
cudaError_t launch_nb(const bf16* x, const uint8_t* p, const float* s, void* out, int B, int Kh,
                      int N, int ngh, cudaStream_t stream) {
  switch ((B + 7) / 8) {
    case 1: return launch<1, SHIFT, OUT_BF16>(x, p, s, out, B, Kh, N, ngh, stream);
    case 2: return launch<2, SHIFT, OUT_BF16>(x, p, s, out, B, Kh, N, ngh, stream);
    case 3: return launch<3, SHIFT, OUT_BF16>(x, p, s, out, B, Kh, N, ngh, stream);
    default: return launch<4, SHIFT, OUT_BF16>(x, p, s, out, B, Kh, N, ngh, stream);
  }
}

}  // namespace

// x: bf16 (B, 2 Kh); p: uint8 (Kh, N); s: float32 (2 ngh, N); out: (B, N),
// bf16 when out_bf16 else float32. shift != 0 selects the `_kernel` body.
// Takes 1 <= B <= 32, N a multiple of 32 and groups of a multiple of 16
// rows (G = Kh / ngh); returns cudaErrorInvalidValue otherwise.
extern "C" int q4_matmul(const void* x, const void* p, const void* s, void* out, int B, int Kh,
                         int N, int ngh, int out_bf16, int shift, void* stream) {
  if (B < 1 || B > 32 || N < kQCols || N % kQCols || ngh < 1 || Kh % ngh || (Kh / ngh) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t* pb = static_cast<const uint8_t*>(p);
  const float* sf = static_cast<const float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (shift) {
    err = out_bf16 ? launch_nb<true, true>(xb, pb, sf, out, B, Kh, N, ngh, st)
                   : launch_nb<true, false>(xb, pb, sf, out, B, Kh, N, ngh, st);
  } else {
    err = out_bf16 ? launch_nb<false, true>(xb, pb, sf, out, B, Kh, N, ngh, st)
                   : launch_nb<false, false>(xb, pb, sf, out, B, Kh, N, ngh, st);
  }
  return static_cast<int>(err);
}
