#!/usr/bin/env python3
"""Sweep the float32 ViT attention kernels' block shapes on one GPU.

    python3 scripts/sweep_vit_attention_fp32_torch.py [--head_dim 88]

The float32 forward and backward of `robustvlm_tpu_torch/csrc/vit_attention.cu`
are the register-tiled kernels of `csrc/attn_f32_tile.cuh` launched
non-causal, each with its block shape from the nine lines `VitF32Tile<head
dim, kFwd | kDq | kDkv>`: kRows rows of the block's own side, kTile rows
of the streamed side per shared-memory tile, kThreads threads, kBufs
cp.async buffers. This builds one edited copy of the source per entry of
VARIANTS (an entry names the kernels whose lines it changes, at every head
dim), all nvcc processes at once, under `build/sweep/`, holds each
against the plain PyTorch versions (O, dQ, dK, dV within 1e-5, lse 1e-5
abs + 1e-6 rel) at N = 50, 129, 257, 577 for head dim 64 and N = 129, 257
for 80 and 88, and times the forward and the backward (dQ then dK/dV, one
launch) by CUDA-graph replay at the ViT-L/14 main path's shape (B*H =
128, N = 257, D = 64; `--head_dim 88`: ViT-g/14's, D = 88), every variant
twice in turns. At N = 257 the ragged
tail decides much: 32- or 48-row tiles cover 288 rows, 64-row tiles 320.
One JSON line per variant: registers, spills (ptxas) and dynamic shared
memory per kernel and head dim, max errors, ms. Then SDPA's forward and
backward at the same shape (by graph replay, as `chip_smoke.py` times
them) and the card's name and power limit. Exits 1 if the source as it
stands (variant 0) misses a limit. Needs a GPU.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPE_LINE = (r"struct VitF32Tile<(64|80|88), (kFwd|kDq|kDkv)> \{ static constexpr int kRows = (\d+), "
              r"kTile = (\d+), kThreads = (\d+), kBufs = (\d+); \};")
KERNELS = {"kFwd": "fwd", "kDq": "bwd_dq", "kDkv": "bwd_dkv"}
# {kind: (kRows, kTile, kThreads, kBufs)} for both head dims; {} is the source as it stands
VARIANTS = [
    {},
    {"kDq": (32, 32, 64, 2)}, {"kDq": (48, 48, 128, 2)}, {"kDq": (48, 24, 128, 2)},
    {"kDq": (48, 40, 128, 2)}, {"kDq": (48, 32, 128, 1)},
    {"kDkv": (64, 32, 256, 2)}, {"kDkv": (48, 48, 128, 2)}, {"kDkv": (32, 32, 128, 2)},
    {"kDkv": (48, 24, 128, 2)}, {"kDkv": (48, 40, 128, 2)}, {"kDkv": (48, 32, 128, 1)},
]
BH, N, D = 128, 257, 64
CASES = [(50, 64), (129, 64), (257, 64), (577, 64), (129, 80), (257, 80), (129, 88), (257, 88)]


def smem_bytes(d: int, kind: str, rows: int, tile: int, bufs: int) -> int:
    """Dynamic shared memory, as `F32<D, S, Kind>::kSmem` computes it."""
    ld = (d + 31) // 32 * 32 + 4
    own = 1 if kind == "kFwd" else 2
    stage = 2 * tile * ld + (2 * tile if kind == "kDkv" else 0)
    ps = 2 if kind == "kDkv" else 1
    return 4 * (own * rows * ld + bufs * stage + ps * rows * (tile + 8))


def build(variants):
    from robustvlm_tpu_torch.ops.kernels import _build, vit_attention

    src = (_build.CSRC / "vit_attention.cu").read_text()
    in_source = {(int(m[0]), m[1]): tuple(map(int, m[2:])) for m in re.findall(SHAPE_LINE, src)}
    if len(in_source) != 9:
        raise RuntimeError("the nine VitF32Tile<...> lines were not found in vit_attention.cu")

    def edited(change):
        def line(m):
            d, kind = m.group(1), m.group(2)
            rows, tile, threads, bufs = change.get(kind) or m.groups()[2:]
            return (f"struct VitF32Tile<{d}, {kind}> {{ static constexpr int kRows = {rows}, "
                    f"kTile = {tile}, kThreads = {threads}, kBufs = {bufs}; }};")
        return re.sub(SHAPE_LINE, line, src)

    sources = {i: edited(change) for i, change in enumerate(variants)}
    libs = {}
    for i, (lib, log) in _build.build_variants(sources, ROOT / "build" / "sweep", "va").items():
        lines = log.splitlines()
        report = {}
        for k, ln in enumerate(lines):
            m = re.search(r"flash_(fwd|bwd_dq|bwd_dkv)_tile_kernelILi(64|80|88)E", ln)
            if m and "Compiling entry" in ln:
                text = " ".join(lines[k + 1:k + 4])
                d = int(m.group(2))
                kind = next(kd for kd, name in KERNELS.items() if name == m.group(1))
                rows, tile, threads, bufs = variants[i].get(kind) or in_source[(d, kind)]
                regs = re.search(r"Used (\d+) registers", text)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
                report[f"{m.group(1)}<{d}>"] = {
                    "shape": [rows, tile, threads, bufs],
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_bytes": [int(spill.group(1)), int(spill.group(2))] if spill else None,
                    "smem_bytes": smem_bytes(d, kind, rows, tile, bufs)}
        libs[i] = (vit_attention.bind(lib), report)
    return libs


def launchers(lib, q, k, v, do):
    """Closures that launch one variant's float32 forward and backward (the
    backward from the forward's own O and lse), and their outputs."""
    import torch

    from robustvlm_tpu_torch.ops.kernels import _heads

    bh, n, d = q.shape
    o, lse = torch.empty_like(q), torch.empty(bh, n, device="cuda")
    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty(bh, n, device="cuda")
    scale = 1.0 / d ** 0.5
    st = _heads.strides((q, k, v, o, do, *grads))

    def stream():  # read at each launch: a graph capture runs on a stream of its own
        return torch.cuda.current_stream().cuda_stream

    def fwd():
        if lib.vit_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                            bh, 1, n, d, 0, scale, st, stream()):
            raise RuntimeError("forward launch failed")

    def bwd():
        if lib.vit_attn_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                            do.data_ptr(), *(g.data_ptr() for g in grads), delta.data_ptr(),
                            bh, 1, n, d, 0, scale, st, stream()):
            raise RuntimeError("backward launch failed")

    return fwd, bwd, (o, lse, *grads)


def main() -> int:
    import torch
    import torch.nn.functional as Fn

    import chip_smoke as C
    from robustvlm_tpu_torch.device import use_full_fp32
    from robustvlm_tpu_torch.ops.kernels import vit_attention as A

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--head_dim", type=int, default=D, choices=(64, 80, 88),
                    help="the head dim of the timed shape (B*H = 128, N = 257)")
    d_timed = ap.parse_args().head_dim
    use_full_fp32()
    libs = build(VARIANTS)
    data = {}
    for n, d in CASES:
        q, k, v, do = C._qkv(n, torch.float32, seed=n + d, d=d)
        o, lse = A.attention_fwd_plain(q, k, v)
        data[(n, d)] = (q, k, v, do, (o, lse, *A.attention_bwd_plain(q, k, v, o, lse, do)))
    results = {}
    for i, (lib, report) in libs.items():
        errs, within = {}, True
        for (n, d), (q, k, v, do, ref) in data.items():
            fwd, bwd, out = launchers(lib, q, k, v, do)
            fwd()
            bwd()
            torch.cuda.synchronize()
            res = C._attn_check("float32", out, ref, False)
            errs[f"{n},{d}"] = {name: e for name, (e, _) in res.items()}
            within &= all(ok for _, ok in res.values())
        results[i] = {"ptxas": report, "max_abs_err": errs, "within": within, "fwd_ms": [], "bwd_ms": []}
    q, k, v, do, _ = data[(N, d_timed)]
    for _ in range(2):  # every variant twice, in turns
        for i, (lib, _) in libs.items():
            fwd, bwd, _ = launchers(lib, q, k, v, do)
            fwd()
            results[i]["fwd_ms"].append(C.time_graph_ms(fwd))
            results[i]["bwd_ms"].append(C.time_graph_ms(bwd))
    for i, r in results.items():
        print(json.dumps({"variant": i, "change": VARIANTS[i] or "source", **r}), flush=True)
    q4, k4, v4, do4 = (t.view(8, BH // 8, N, d_timed) for t in (q, k, v, do))
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
    print(json.dumps({"library": "scaled_dot_product_attention", "shape": [BH, N, d_timed],
                      "fwd_ms": C.time_graph_ms(lambda: Fn.scaled_dot_product_attention(q4, k4, v4)),
                      "bwd": C.time_graph_fwd_bwd_ms(Fn.scaled_dot_product_attention, (ql, kl, vl), do4)}))
    print(C.card_line())
    return 0 if results[0]["within"] else 1


if __name__ == "__main__":
    sys.exit(main())
