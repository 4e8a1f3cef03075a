#!/usr/bin/env python3
"""Sweep the float32 flash kernels' block shape at head dim 128 on one GPU.

    python3 scripts/sweep_flash_fp32_torch.py

The float32 kernels of `robustvlm_tpu_torch/csrc/flash_attention.cu` give
each block `kRows` query rows (keys in dK/dV), split each dot product over
`kTpr` threads and stage `kTile` rows of the other side at a time
(`F32Shape<128, fwd or bwd>`). This builds one variant of the source per
(kRows, kTpr, kTile), the same shape for the forward and the backward, all
nvcc processes at once, under `build/sweep/`, checks each against the plain
PyTorch version and prints one JSON line per variant: forward and backward
ms at the LLaVA-1.5-7B LM layer as `chip_smoke.py` checks it (B*H = 32,
N = 665, D = 128, causal), each variant timed twice in turns, max abs
errors and the compiler's register and spill report. Then the card's name
and power limit. Needs a GPU.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = [(64, 4, 32), (32, 4, 32), (16, 4, 32), (32, 2, 32), (32, 4, 16)]  # (kRows, kTpr, kTile)
SHAPE_LINE = (r"struct F32Shape<128, (true|false)> \{ static constexpr int kRows = \d+, "
              r"kTpr = \d+, kTile = \d+; \};")


def build(variants):
    from robustvlm_tpu_torch.ops.kernels import _build, flash_attention

    src = (_build.CSRC / "flash_attention.cu").read_text()
    if not re.search(SHAPE_LINE, src):
        raise RuntimeError("F32Shape<128, ...> lines not found in flash_attention.cu")
    sources = {
        (rows, tpr, tile): re.sub(SHAPE_LINE, lambda m: f"struct F32Shape<128, {m.group(1)}> {{ "
                                  f"static constexpr int kRows = {rows}, kTpr = {tpr}, "
                                  f"kTile = {tile}; }};", src)
        for rows, tpr, tile in variants}
    libs = {}
    for key, (lib, log) in _build.build_variants(sources, ROOT / "build" / "sweep", "fa").items():
        lines = log.splitlines()
        report = {}
        for i, ln in enumerate(lines):
            m = re.search(r"flash_(fwd|bwd_dq|bwd_dkv)_fma_kernelILi128", ln)
            if m and "Compiling entry" in ln:
                rest = lines[i + 1:i + 4]
                report[m.group(1)] = " / ".join(x.strip() for x in rest if "spill" in x or "Used" in x)
        libs[key] = (flash_attention.bind(lib), report)
    return libs


def main() -> int:
    import torch

    import chip_smoke as C
    from robustvlm_tpu_torch.device import use_full_fp32
    from robustvlm_tpu_torch.ops.kernels import flash_attention as F

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    use_full_fp32()
    bh, n, _, d = C._flash_llava_shape()
    libs = build(VARIANTS)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(bh, n, d, generator=g, device="cuda") * 0.5 for _ in range(4))
    o_ref, lse_ref = F.flash_fwd_plain(q, k, v, causal=True)
    grads_ref = F.flash_bwd_plain(q, k, v, o_ref, lse_ref, do, causal=True)
    stream = torch.cuda.current_stream().cuda_stream
    dims = F._dims(q, k, True)
    results = {key: {"fwd_ms": [], "bwd_ms": []} for key in libs}
    for _ in range(2):  # every variant twice, in turns
        for key, (lib, report) in libs.items():
            o, lse = torch.empty_like(q), torch.empty(bh, n, device="cuda")
            dq, dk, dv = (torch.empty_like(q) for _ in range(3))
            delta = torch.empty(bh, n, device="cuda")

            def fwd():
                return lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                          lse.data_ptr(), None, *dims, stream)

            def bwd():
                return lib.flash_attn_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o_ref.data_ptr(),
                                          lse_ref.data_ptr(), do.data_ptr(), None, dq.data_ptr(),
                                          dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), *dims, stream)

            if fwd() or bwd():
                raise RuntimeError(f"launch failed for kRows, kTpr, kTile = {key}")
            torch.cuda.synchronize()
            r = results[key]
            r["max_abs_err"] = {
                "o": float((o - o_ref).abs().max()), "lse": float((lse - lse_ref).abs().max()),
                "grads": max(float((a - b).abs().max()) for a, b in zip((dq, dk, dv), grads_ref))}
            r["fwd_ms"].append(C.time_ms(fwd, 20))
            r["bwd_ms"].append(C.time_ms(bwd, 20))
            r["ptxas"] = report
    for (rows, tpr, tile), r in results.items():
        print(json.dumps({"kRows": rows, "kTpr": tpr, "kTile": tile, **r}), flush=True)
    print(C.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
