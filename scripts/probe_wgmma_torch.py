#!/usr/bin/env python3
"""Hold the wgmma and TMA building blocks of `csrc/wgmma_bf16.cuh` against
torch.matmul on one GPU, one product at a time, before any kernel uses them.

    python3 scripts/probe_wgmma_torch.py

The bf16 forward (`csrc/attn_bf16_fwd.cuh`) and the bf16 backward
(`csrc/attn_bf16_bwd.cuh`) run two kinds of product: S = Q K^T (and dP,
S^T, dP^T) with both operands from shared memory, both K-major, and O +=
P V (and dQ += dS K, dV += P^T dO, dK += dS^T Q) with A from registers and
B read MN-major (the transpose bit), through 128-byte-swizzled
shared-memory descriptors, every tile copied by TMA. This builds one small
kernel per product, shape (tile head dim D 64 and 128, tile N 32, 64 and
128, one warpgroup, one 64-row block) and mode under `build/probe/`, with
the descriptor's leading and stride byte offsets as arguments, and prints
one JSON line per case: the max abs error against the float32 product of
the same bf16 inputs, relative to the reference's largest value. The
offsets the kernels use must pass, the swapped ones fail. A ragged case (1
query row, 5 keys: the boxes' other rows are the hardware's zero fill)
checks the fill and the transaction bytes of a partial box; head dims 80
and 88 in a 128-wide tile (arrays mapped as 80 or 88 columns, read as two
boxes, the second zero-filled past the head dim; S in 5 or 6 k-steps, the
sixth at 88 over the zero fill of both operands; O = P V at N = 128 and at
wgmma's own n = 80 or 88, which the forward runs) check the fill of
columns. S is also run with A from registers, alone and, where D = N,
right after a product of its own shape with the transpose bit: the fault
that made the forward take A from shared memory. Then the host cost of
encoding the forward's three tensor maps, as every call does, and the
card's name and power limit. Exits 1 if a case the kernel relies on fails.
Needs a GPU.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r'''
#include <chrono>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

// S = Q K^T for one 64-row block, A from shared memory (kSS, as the
// forward runs it) or from registers. With kAfter, a product of S's own
// shape with the transpose bit (as O += P V is) runs first, into other
// registers, and is waited for.
template <int D, int BN, bool kSS, bool kAfter>
__global__ void __launch_bounds__(128) probe_s_kernel(const __grid_constant__ CUtensorMap qmap,
                                                      const __grid_constant__ CUtensorMap kmap,
                                                      float* out, float* sink, int lbo, int sbo,
                                                      int ksteps) {
  extern __shared__ unsigned char raw[];
  unsigned char* qs = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  unsigned char* ks = qs + 64 * D * 2;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ks + BN * D * 2);
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(bar, (64 + BN) * D * 2);
    for (int b = 0; b < D / 64; ++b) {
      tma_load_3d(qs + b * 64 * 128, &qmap, bar, 64 * b, 0, 0);
      tma_load_3d(ks + b * BN * 128, &kmap, bar, 64 * b, 0, 0);
    }
  }
  __syncthreads();
  mbar_wait(bar, 0);
  // this warp's 16 rows of Q as A fragments, from the swizzled box
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 16 + g + (i & 1) * 8, c = s * 16 + (i >> 1) * 8 + 2 * t;
      const int at = (c / 64) * 64 * 128 + r * 128 + ((((c % 64) >> 3) ^ r) & 7) * 16 + (c & 7) * 2;
      qa[s][i] = *reinterpret_cast<const uint32_t*>(qs + at);
    }
  }
  fence_regs(qa);
  if constexpr (kAfter) {
    static_assert(D == BN, "the product before has S's shape");
    float o[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) o[i] = 0.f;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      wgmma_rs<BN, 1>(o, qa[kk], wgmma_desc(smem_u32(ks) + kk * 16 * 128, BN * 128, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sink[threadIdx.x * (BN / 2) + i] = o[i];
  }
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if (kk >= ksteps) break;  // a head dim of 80 (88) in a 128-wide tile: 5 (6) k-steps
    const uint64_t b = wgmma_desc(smem_u32(ks) + (kk / 4) * BN * 128 + (kk % 4) * 32, lbo, sbo);
    if constexpr (kSS) {
      wgmma_ss<BN>(acc, wgmma_desc(smem_u32(qs) + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024), b,
                   kk > 0);
    } else {
      wgmma_rs<BN, 0>(acc, qa[kk], b, kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      out[(warp * 16 + g + (c >> 1) * 8) * BN + 8 * j + 2 * t + (c & 1)] = acc[4 * j + c];
    }
  }
}

// O = P V at N = NO: the tile's width D, or a head dim of 80 or 88 in a
// 128-wide tile (wgmma n = 80 or 88: one box and 16 or 24 columns of the next)
template <int D, int BN, int NO>
__global__ void __launch_bounds__(128) probe_pv_kernel(const bf16* p,
                                                       const __grid_constant__ CUtensorMap vmap,
                                                       float* out, int lbo, int sbo) {
  extern __shared__ unsigned char raw[];
  unsigned char* vs = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + BN * D * 2);
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(bar, BN * D * 2);
    for (int b = 0; b < D / 64; ++b) tma_load_3d(vs + b * BN * 128, &vmap, bar, 64 * b, 0, 0);
  }
  __syncthreads();
  uint32_t pa[BN / 16][4];
#pragma unroll
  for (int s = 0; s < BN / 16; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 16 + g + (i & 1) * 8, c = s * 16 + (i >> 1) * 8 + 2 * t;
      pa[s][i] = ld32(p + r * BN + c);
    }
  }
  mbar_wait(bar, 0);
  float acc[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) acc[i] = 0.f;
  fence_regs(pa);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    wgmma_rs<NO, 1>(acc, pa[kk], wgmma_desc(smem_u32(vs) + kk * 16 * 128, lbo, sbo), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < NO / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      out[(warp * 16 + g + (c >> 1) * 8) * NO + 8 * j + 2 * t + (c & 1)] = acc[4 * j + c];
    }
  }
}

// Shared memory past the tiles, so that a wrong descriptor reads garbage
// inside the block's allocation instead of faulting.
constexpr int kSlack = 64 * 1024;

template <class Kernel>
int launch(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess;
}

// `inner` is the arrays' head dim: D, or 80 or 88 in a 128-wide tile (TMA
// zero-fills the second box's columns past it)
template <int D, int BN, bool kSS, bool kAfter>
int run_s(const void* q, const void* k, float* out, float* sink, int inner, int nq, int nk,
          int lbo, int sbo, cudaStream_t s) {
  CUtensorMap qm, km;
  if (!make_map_3d(&qm, q, inner, nq, 1, 64) || !make_map_3d(&km, k, inner, nk, 1, BN)) return -1;
  const int smem = 1024 + (64 + BN) * D * 2 + 8 + kSlack;
  if (launch(probe_s_kernel<D, BN, kSS, kAfter>, smem)) return (int)cudaGetLastError();
  probe_s_kernel<D, BN, kSS, kAfter><<<1, 128, smem, s>>>(qm, km, out, sink, lbo, sbo, (inner + 15) / 16);
  return (int)cudaGetLastError();
}

template <int D, int BN>
int run_s_mode(const void* q, const void* k, float* out, float* sink, int inner, int nq, int nk,
               int lbo, int sbo, int mode, cudaStream_t s) {
  if (mode == 1) return run_s<D, BN, true, false>(q, k, out, sink, inner, nq, nk, lbo, sbo, s);
  if constexpr (BN != 32) {  // no wgmma_rs wrapper at N = 32
    if (mode == 0) return run_s<D, BN, false, false>(q, k, out, sink, inner, nq, nk, lbo, sbo, s);
    if constexpr (D == BN) {
      if (mode == 2) return run_s<D, BN, false, true>(q, k, out, sink, inner, nq, nk, lbo, sbo, s);
      if (mode == 3) return run_s<D, BN, true, true>(q, k, out, sink, inner, nq, nk, lbo, sbo, s);
    }
  }
  return -2;
}

template <int D, int BN, int NO = D>
int run_pv(const void* p, const void* v, float* out, int inner, int nk, int lbo, int sbo,
           cudaStream_t s) {
  CUtensorMap vm;
  if (!make_map_3d(&vm, v, inner, nk, 1, BN)) return -1;
  const int smem = 1024 + BN * D * 2 + 8 + kSlack;
  if (launch(probe_pv_kernel<D, BN, NO>, smem)) return (int)cudaGetLastError();
  probe_pv_kernel<D, BN, NO><<<1, 128, smem, s>>>(static_cast<const bf16*>(p), vm, out, lbo, sbo);
  return (int)cudaGetLastError();
}

}  // namespace

// mode: bit 0 = A from shared memory (else registers), bit 1 = after a
// product of the same shape with the transpose bit (D == BN only). d is the
// tile's head dim (64 or 128), inner the arrays' (d, or 80 or 88 with d = 128).
extern "C" int probe_s(const void* q, const void* k, void* out, void* sink, int d, int inner,
                       int bn, int nq, int nk, int lbo, int sbo, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* z = static_cast<float*>(sink);
  if (d == 64 && bn == 32) return run_s_mode<64, 32>(q, k, o, z, inner, nq, nk, lbo, sbo, mode, s);
  if (d == 64 && bn == 64) return run_s_mode<64, 64>(q, k, o, z, inner, nq, nk, lbo, sbo, mode, s);
  if (d == 64 && bn == 128) return run_s_mode<64, 128>(q, k, o, z, inner, nq, nk, lbo, sbo, mode, s);
  if (d == 128 && bn == 32) return run_s_mode<128, 32>(q, k, o, z, inner, nq, nk, lbo, sbo, mode, s);
  if (d == 128 && bn == 64) return run_s_mode<128, 64>(q, k, o, z, inner, nq, nk, lbo, sbo, mode, s);
  if (d == 128 && bn == 128) return run_s_mode<128, 128>(q, k, o, z, inner, nq, nk, lbo, sbo, mode, s);
  return -2;
}

// no: the product's N, d or (with d = 128, inner = 80 or 88) 80 or 88.
extern "C" int probe_pv(const void* p, const void* v, void* out, int d, int inner, int bn, int nk,
                        int lbo, int sbo, int no, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (no == 80 && d == 128) {
    if (bn == 32) return run_pv<128, 32, 80>(p, v, o, inner, nk, lbo, sbo, s);
    if (bn == 64) return run_pv<128, 64, 80>(p, v, o, inner, nk, lbo, sbo, s);
    if (bn == 128) return run_pv<128, 128, 80>(p, v, o, inner, nk, lbo, sbo, s);
    return -2;
  }
  if (no == 88 && d == 128) {
    if (bn == 32) return run_pv<128, 32, 88>(p, v, o, inner, nk, lbo, sbo, s);
    if (bn == 64) return run_pv<128, 64, 88>(p, v, o, inner, nk, lbo, sbo, s);
    if (bn == 128) return run_pv<128, 128, 88>(p, v, o, inner, nk, lbo, sbo, s);
    return -2;
  }
  if (no != d) return -2;
  if (d == 64 && bn == 32) return run_pv<64, 32>(p, v, o, inner, nk, lbo, sbo, s);
  if (d == 64 && bn == 64) return run_pv<64, 64>(p, v, o, inner, nk, lbo, sbo, s);
  if (d == 64 && bn == 128) return run_pv<64, 128>(p, v, o, inner, nk, lbo, sbo, s);
  if (d == 128 && bn == 32) return run_pv<128, 32>(p, v, o, inner, nk, lbo, sbo, s);
  if (d == 128 && bn == 64) return run_pv<128, 64>(p, v, o, inner, nk, lbo, sbo, s);
  if (d == 128 && bn == 128) return run_pv<128, 128>(p, v, o, inner, nk, lbo, sbo, s);
  return -2;
}

// Host microseconds to encode the forward's three maps (q, k, v), per call.
extern "C" double encode_us(const void* q, const void* k, const void* v, int d, int nq, int nk,
                            int bh, int iters) {
  CUtensorMap m[3];
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    if (!make_map_3d(&m[0], q, d, nq, bh, 64) || !make_map_3d(&m[1], k, d, nk, bh, 64) ||
        !make_map_3d(&m[2], v, d, nk, bh, 64)) {
      return -1.0;
    }
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / iters;
}
'''

# (lbo, sbo) in bytes: what attn_fwd_wgmma_kernel passes first, then the swap
K_OFFSETS = [(16, 1024), (1024, 16)]  # K-major: LBO unused


def v_offsets(n: int) -> list:
    """MN-major V of an n-key tile: the next 64 head-dim columns (box) n * 128
    bytes on, 8-key groups 1024 apart; then the swap."""
    return [(n * 128, 1024), (1024, n * 128)]


def main() -> int:
    import torch

    import chip_smoke as C
    from robustvlm_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    (lib, log), = _build.build_variants({"probe": SOURCE}, ROOT / "build" / "probe", "wg").values()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_s.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.probe_pv.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.encode_us.argtypes = [p, p, p, i, i, i, i, i]
    lib.encode_us.restype = ctypes.c_double
    print(json.dumps({"ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]}))
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    failed = []
    # (tile head dim, arrays' head dim): 80 and 88 are two boxes a row,
    # zero-filled past the head dim
    for d, inner in ((64, 64), (128, 128), (128, 80), (128, 88)):
        for n in (32, 64, 128):
            for nq, nk in ((64, n), (1, 5)):
                q = torch.randn(nq, inner, generator=g, device="cuda").bfloat16()
                k = torch.randn(nk, inner, generator=g, device="cuda").bfloat16()
                ref = torch.zeros(64, n, device="cuda")
                ref[:nq, :nk] = q.float() @ k.float().T
                sink = torch.empty(128 * n // 2, device="cuda")
                # (A from shared memory, after a same-shape product, lbo, sbo)
                runs = [(True, False, *o) for o in K_OFFSETS]
                if n != 32:  # A from registers: no wrapper at N = 32
                    runs += [(False, False, *K_OFFSETS[0])]
                if d == n and d == inner:
                    runs += [(True, True, *K_OFFSETS[0]), (False, True, *K_OFFSETS[0])]
                for ss, after, lbo, sbo in runs:
                    out = torch.full((64, n), float("nan"), device="cuda")
                    err = lib.probe_s(q.data_ptr(), k.data_ptr(), out.data_ptr(), sink.data_ptr(), d,
                                      inner, n, nq, nk, lbo, sbo, int(ss) + 2 * int(after), stream)
                    torch.cuda.synchronize()
                    rel = float((out - ref).abs().max() / ref.abs().max())
                    ok = err == 0 and rel <= 1e-3
                    used = ss and (lbo, sbo) == K_OFFSETS[0]
                    print(json.dumps({"product": "S = Q K^T (K-major)", "A": "shared" if ss else "registers",
                                      "after_same_shape_transposed_product": after, "D": d,
                                      "head_dim": inner, "N": n, "nq": nq, "nk": nk, "lbo": lbo,
                                      "sbo": sbo, "kernel_uses": used, "launch_err": err,
                                      "max_abs_err_rel": rel, "ok": ok}), flush=True)
                    if used and not ok:
                        failed.append(("S", d, inner, n, nq, nk, after))
            # the product's N: the tile's width, and at head dims 80 and 88 also the head dim
            for no in sorted({d, inner}):
                for nk in (n, 5):
                    pm = (torch.rand(64, n, generator=g, device="cuda")).bfloat16()
                    v = torch.randn(nk, inner, generator=g, device="cuda").bfloat16()
                    vpad = torch.zeros(n, d, device="cuda")
                    vpad[:nk, :inner] = v.float()
                    ref = pm.float() @ vpad[:, :no]
                    for lbo, sbo in v_offsets(n):
                        out = torch.full((64, no), float("nan"), device="cuda")
                        err = lib.probe_pv(pm.data_ptr(), v.data_ptr(), out.data_ptr(), d, inner, n,
                                           nk, lbo, sbo, no, stream)
                        torch.cuda.synchronize()
                        rel = float((out - ref).abs().max() / ref.abs().max())
                        ok = err == 0 and rel <= 1e-3
                        used = (lbo, sbo) == v_offsets(n)[0]
                        print(json.dumps({"product": "O = P V (V MN-major)", "D": d, "head_dim": inner,
                                          "product_N": no, "N": n, "nk": nk, "lbo": lbo, "sbo": sbo,
                                          "kernel_uses": used, "launch_err": err,
                                          "max_abs_err_rel": rel, "ok": ok}), flush=True)
                        if used and not ok:
                            failed.append(("PV", d, inner, no, n, nk))
    bh, n, d = 32, 665, 128
    q = torch.zeros(bh, n, d, device="cuda", dtype=torch.bfloat16)
    us = lib.encode_us(q.data_ptr(), q.data_ptr(), q.data_ptr(), d, n, n, bh, 10000)
    print(json.dumps({"host_us_to_encode_three_tensor_maps": us, "shape": [bh, n, d]}), flush=True)
    print(json.dumps({"failed": failed}))
    print(C.card_line())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
