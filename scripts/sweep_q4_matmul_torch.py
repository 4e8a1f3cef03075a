#!/usr/bin/env python3
"""Sweep the q4_matmul kernel's block shape at the LLaVA-1.5-7B decode step's
weights on one GPU.

    python3 scripts/sweep_q4_matmul_torch.py

`robustvlm_tpu_torch/csrc/q4_matmul.cu` gives each block `kQWarps` warps
that split a strip's groups, each warp loading `kQAhead` 16-row k-steps
ahead. This builds one variant of the source per (kQWarps, kQAhead), all
nvcc processes at once, under `build/sweep/`, checks each against the plain
PyTorch version (the limits of `chip_smoke.py`) and prints one JSON line per
variant and body: the device time of each 7B (K, N) at batches 1, 4 and 32
(CUDA-graph replay, each launch reading its weight from device memory, as
`chip_smoke.py` times it), the batch-1 decode step's 225 launches summed
against their byte bound, and the compiler's register and spill report;
every variant timed twice in turns. Then the card's name and power limit.
Needs a GPU.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = [(8, 8), (4, 8), (8, 4), (4, 16)]  # (kQWarps, kQAhead); the first is the source's


def build(variants):
    from robustvlm_tpu_torch.ops.kernels import _build, q4_matmul

    src = (_build.CSRC / "q4_matmul.cu").read_text()
    pats = {"kQWarps": r"constexpr int kQWarps = \d+;", "kQAhead": r"constexpr int kQAhead = \d+;"}
    for name, pat in pats.items():
        if not re.search(pat, src):
            raise RuntimeError(f"{name} not found in q4_matmul.cu")
    sources = {}
    for warps, ahead in variants:
        v = re.sub(pats["kQWarps"], f"constexpr int kQWarps = {warps};", src)
        sources[warps, ahead] = re.sub(pats["kQAhead"], f"constexpr int kQAhead = {ahead};", v)
    libs = {}
    for key, (lib, log) in _build.build_variants(sources, ROOT / "build" / "sweep", "q4").items():
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers", log)})
        spills = sorted({int(m) for m in re.findall(r"(\d+) bytes spill stores", log)})
        libs[key] = (q4_matmul.bind(lib), {"registers": regs, "spill_store_bytes": spills})
    return libs


def main() -> int:
    import torch

    import chip_smoke as S
    from robustvlm_tpu_torch.device import resolve_device
    from robustvlm_tpu_torch.ops.kernels import q4_matmul as Q
    from robustvlm_tpu_torch.ops.quant import quantize_q4

    dev = resolve_device("cuda")
    peaks = S.peaks_for(torch.cuda.get_device_name(0))
    libs = build(VARIANTS)
    gen = torch.Generator(device=dev).manual_seed(4)
    weights = {}
    for k, n, _ in S.Q4_SHAPES:
        w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
        qw = quantize_q4(w, group_size=S.Q4_GROUP)
        weights[k, n] = S._rotating(lambda: (qw.p.clone(), qw.s.clone()), qw.p.numel() + qw.s.numel() * 4)
    xs = {(b, k): (torch.randn(b, k, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
          for b in S.Q4_BATCHES for k in (4096, 11008)}

    def call(lib, x, p, s, group):
        out = torch.empty(x.shape[0], p.shape[1], dtype=x.dtype, device=x.device)
        err = lib.q4_matmul(x.data_ptr(), p.data_ptr(), s.data_ptr(), out.data_ptr(), x.shape[0],
                            p.shape[0], p.shape[1], s.shape[0] // 2, 1, int(not group),
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"q4_matmul launch failed: cudaError {err}")
        return out

    results = {}
    for turn in range(2):
        for key, (lib, report) in libs.items():
            for group in (True, False):
                ms, ok, step, bound = {}, True, 0.0, 0.0
                for k, n, count in S.Q4_SHAPES:
                    copies = weights[k, n]
                    for b in S.Q4_BATCHES:
                        x = xs[b, k]
                        got = call(lib, x, *copies[0], group)
                        ok &= S._q4_within(got, Q.q4_matmul_reference(x, *copies[0], group=group),
                                           "bfloat16")[1]
                        it = iter(range(10**9))
                        ms[f"{b}x{k}x{n}"] = t = S.time_graph_ms(
                            lambda: call(lib, x, *copies[next(it) % len(copies)], group))
                        if b == 1:
                            p, s = copies[0]
                            n_bytes = 2 * k + p.numel() + s.numel() * 4 + 2 * n
                            step += count * t
                            bound += count * S.bound_ms(n_bytes, 2 * k * n, "bfloat16", peaks)[0]
                results.setdefault((key, group), []).append(
                    {"ms": ms, "step_ms": step, "step_bound_ms": bound, "ok": bool(ok)})
    for ((warps, ahead), group), runs in results.items():
        print(json.dumps({"script": "scripts/sweep_q4_matmul_torch.py", "kQWarps": warps,
                          "kQAhead": ahead, "body": "group" if group else "shift",
                          "ok": all(r["ok"] for r in runs),
                          "step_ms_b1": [r["step_ms"] for r in runs],
                          "step_bound_ms_b1": runs[0]["step_bound_ms"],
                          "ms_per_shape": [r["ms"] for r in runs], **libs[warps, ahead][1]}))
    print(S.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
