#!/usr/bin/env python3
"""Measure what a warp's 16-byte shared-memory load costs on one GPU, by the
pattern of addresses its lanes read.

    python3 scripts/bench_shared_load_torch.py

The float32 attention kernels (`robustvlm_tpu_torch/csrc/fma_tile.cuh`) feed
every FMA from shared memory, so the lane layout of their micro-tiles is
chosen by this number. One block of 256 threads (8 warps, two a scheduler)
runs `ld.volatile.shared.v4.f32` in a loop, 8 independent loads a turn;
lane l reads the 16-byte chunk `pattern(l)` at a stride of 4 floats (chunks
side by side) or 132 floats (rows of a padded head-dim-128 tile). Prints one
JSON line per pattern: SM clock cycles per warp load (clock64 around the
loop over the loads made), then the card's name and power limit. The
program is built with nvcc under `build/bench/`. Needs a GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (what the lanes read, C expression of the chunk index from `lane`)
PATTERNS = [
    ("one chunk for the whole warp", "0"),
    ("row group = lane / 8: 4 chunks, 1 a lane quad", "lane / 8"),
    ("column group = lane % 8: 8 chunks, 4 a lane quad", "lane % 8"),
    ("column group on lane bits 0, 2, 3: 8 chunks, 2 a lane quad", "(lane & 1) | ((lane >> 1) & 6)"),
    ("row group on lane bits 1, 4: 4 chunks, 2 a lane quad", "((lane >> 1) & 1) + ((lane >> 3) & 2)"),
    ("lane / 2: 16 chunks, 2 a lane quad", "lane / 2"),
    ("lane % 4: 4 chunks, 4 a lane quad", "lane % 4"),
    ("lane % 2: 2 chunks, 2 a lane quad", "lane % 2"),
    ("every lane its own chunk", "lane"),
]
STRIDES = (4, 132)  # floats between chunk c and chunk c + 1
THREADS = 256
ITERS = 2000

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void loads(int pattern, int stride, int iters, float* out, long long* cycles) {
  __shared__ __align__(16) float s[8192];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) s[i] = i * 1e-3f;
  __syncthreads();
  const int lane = threadIdx.x %% 32;
  int chunk = 0;
  switch (pattern) {
%(cases)s
  }
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(s + chunk * stride);
  float acc = 0.f;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float x, y, z, w;
      asm volatile("ld.volatile.shared.v4.f32 {%%0, %%1, %%2, %%3}, [%%4];"
                   : "=f"(x), "=f"(y), "=f"(z), "=f"(w) : "r"(base + u * 16));
      acc += x;
    }
  }
  const long long t1 = clock64();
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}
int main() {
  float* out; long long* cycles;
  cudaMalloc(&out, 4096); cudaMalloc(&cycles, 8);
  for (int stride : {%(strides)s}) {
    for (int p = 0; p < %(n)d; ++p) {
      long long c = 0;
      for (int rep = 0; rep < 2; ++rep) {  // the second run is the warm one
        loads<<<1, %(threads)d>>>(p, stride, %(iters)d, out, cycles);
        cudaDeviceSynchronize();
      }
      cudaMemcpy(&c, cycles, 8, cudaMemcpyDeviceToHost);
      printf("%%d %%d %%lld\n", stride, p, c);
    }
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) { fprintf(stderr, "%%s\n", cudaGetErrorString(err)); return 1; }
  return 0;
}
"""


def main() -> int:
    import torch

    import chip_smoke as C
    from robustvlm_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    out_dir = ROOT / "build" / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    cases = "\n".join(f"    case {i}: chunk = {expr}; break;" for i, (_, expr) in enumerate(PATTERNS))
    (out_dir / "shared_load.cu").write_text(SOURCE % {
        "cases": cases, "strides": ", ".join(map(str, STRIDES)), "n": len(PATTERNS),
        "threads": THREADS, "iters": ITERS})
    exe = out_dir / "shared_load"
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o", str(exe),
                    str(out_dir / "shared_load.cu")], check=True, timeout=300)
    text = subprocess.run([str(exe)], check=True, capture_output=True, text=True, timeout=300).stdout
    warps = THREADS // 32
    for line in text.splitlines():
        stride, p, cycles = map(int, line.split())
        # the block's warps share one shared-memory pipe: cycles of it per warp load
        print(json.dumps({"pattern": PATTERNS[p][0], "chunk_index": PATTERNS[p][1],
                          "stride_floats": stride, "warps": warps,
                          "clk_per_warp_load": cycles / (ITERS * 8 * warps)}), flush=True)
    print(C.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
