#!/usr/bin/env python3
"""Sweep the float32 ViT attention forward's block shape on one GPU.

    python3 scripts/sweep_vit_attention_fp32_torch.py

The float32 forward of `robustvlm_tpu_torch/csrc/vit_attention.cu` is the
register-tiled kernel of `csrc/attn_f32_tile.cuh` launched non-causal, with
its block shape from two lines, `VitF32Tile<head dim>`: kRows query rows a
block, kTile keys per shared-memory tile, kThreads threads, kBufs cp.async
buffers. This builds one edited copy of the source per entry of VARIANTS
(each sets both head dims' lines), all nvcc processes at once, under
`build/sweep/`, holds each against the plain PyTorch version (O within
1e-5, lse 1e-5 abs + 1e-6 rel) at N = 50, 129, 257, 577 for head dim 64
and N = 129, 257 for 80, and times the forward by CUDA-graph replay at the
ViT-L/14 main path's shape (B*H = 128, N = 257, D = 64), every variant
twice in turns. One JSON line per variant: registers, spills (ptxas) and
dynamic shared memory per head dim, max errors, ms. Then SDPA's forward at
the same shape and the card's name and power limit. Needs a GPU.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPE_LINE = (r"struct VitF32Tile<(64|80)> \{ static constexpr int kRows = (\d+), "
              r"kTile = (\d+), kThreads = (\d+), kBufs = (\d+); \};")
# (kRows, kTile, kThreads, kBufs) for both head dims; None is the source as it stands
VARIANTS = [None, (32, 32, 64, 2), (64, 48, 128, 1), (64, 64, 128, 2), (32, 64, 64, 2),
            (48, 48, 128, 2), (64, 40, 128, 2), (128, 32, 256, 2), (32, 40, 64, 2), (64, 32, 256, 2)]
BH, N, D = 128, 257, 64
CASES = [(50, 64), (129, 64), (257, 64), (577, 64), (129, 80), (257, 80)]


def smem_bytes(d: int, rows: int, tile: int, bufs: int) -> int:
    """Dynamic shared memory, as `F32<D, S, kFwd>::kSmem` computes it."""
    ld = (d + 31) // 32 * 32 + 4
    return 4 * (rows * ld + bufs * 2 * tile * ld + rows * (tile + 8))


def build(variants):
    from robustvlm_tpu_torch.ops.kernels import _build, vit_attention

    src = (_build.CSRC / "vit_attention.cu").read_text()
    in_source = {int(m[0]): tuple(map(int, m[1:])) for m in re.findall(SHAPE_LINE, src)}
    if len(in_source) != 2:
        raise RuntimeError("the two VitF32Tile<...> lines were not found in vit_attention.cu")

    def edited(shape):
        def line(m):
            rows, tile, threads, bufs = shape or m.groups()[1:]
            return (f"struct VitF32Tile<{m.group(1)}> {{ static constexpr int kRows = {rows}, "
                    f"kTile = {tile}, kThreads = {threads}, kBufs = {bufs}; }};")
        return re.sub(SHAPE_LINE, line, src)

    sources = {i: edited(shape) for i, shape in enumerate(variants)}
    libs = {}
    for i, (lib, log) in _build.build_variants(sources, ROOT / "build" / "sweep", "va").items():
        lines = log.splitlines()
        report = {}
        for k, ln in enumerate(lines):
            m = re.search(r"flash_fwd_tile_kernelILi(64|80)E", ln)
            if m and "Compiling entry" in ln:
                text = " ".join(lines[k + 1:k + 4])
                d = int(m.group(1))
                rows, tile, threads, bufs = variants[i] or in_source[d]
                regs = re.search(r"Used (\d+) registers", text)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
                report[f"D={d}"] = {
                    "shape": [rows, tile, threads, bufs],
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_bytes": [int(spill.group(1)), int(spill.group(2))] if spill else None,
                    "smem_bytes": smem_bytes(d, rows, tile, bufs)}
        libs[i] = (vit_attention.bind(lib), report)
    return libs


def forward(lib, q, k, v):
    """A closure that launches one variant's float32 forward, and its outputs."""
    import torch

    bh, n, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(bh, n, device="cuda")

    def fwd():
        err = lib.vit_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                               lse.data_ptr(), bh, n, d, 0, 1.0 / d ** 0.5,
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"forward launch failed: cudaError {err}")

    return fwd, (o, lse)


def main() -> int:
    import torch
    import torch.nn.functional as Fn

    import chip_smoke as C
    from robustvlm_tpu_torch.device import use_full_fp32
    from robustvlm_tpu_torch.ops.kernels import vit_attention as A

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    use_full_fp32()
    libs = build(VARIANTS)
    data = {}
    for n, d in CASES:
        q, k, v, _ = C._qkv(n, torch.float32, seed=n + d, d=d)
        data[(n, d)] = (q, k, v, A.attention_fwd_plain(q, k, v))
    results = {}
    for i, (lib, report) in libs.items():
        errs, within = {}, True
        for (n, d), (q, k, v, ref) in data.items():
            fwd, out = forward(lib, q, k, v)
            fwd()
            torch.cuda.synchronize()
            res = C._attn_check("float32", out, ref, False)
            errs[f"{n},{d}"] = {name: e for name, (e, _) in res.items()}
            within &= all(ok for _, ok in res.values())
        results[i] = {"ptxas": report, "max_abs_err": errs, "within": within, "fwd_ms": []}
    q, k, v, _ = data[(N, D)]
    for _ in range(2):  # every variant twice, in turns
        for i, (lib, _) in libs.items():
            results[i]["fwd_ms"].append(C.time_graph_ms(forward(lib, q, k, v)[0]))
    for i, r in results.items():
        print(json.dumps({"variant": i, "shape": VARIANTS[i] or "source", **r}), flush=True)
    q4, k4, v4 = (t.view(8, BH // 8, N, D) for t in (q, k, v))
    print(json.dumps({"library": "scaled_dot_product_attention", "shape": [BH, N, D],
                      "fwd_ms": C.time_graph_ms(lambda: Fn.scaled_dot_product_attention(q4, k4, v4))}))
    print(C.card_line())
    return 0 if results[0]["within"] else 1


if __name__ == "__main__":
    sys.exit(main())
