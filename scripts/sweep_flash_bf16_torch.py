#!/usr/bin/env python3
"""Sweep the bf16 flash forward's key tile and stage count on one GPU.

    python3 scripts/sweep_flash_bf16_torch.py

`flash_fwd_wgmma_kernel` in `robustvlm_tpu_torch/csrc/flash_attention.cu`
takes its shape from two lines, `Bf16Fwd<head dim>`: kN keys per tile (the
N of S = Q K^T) and kStages stages of the TMA ring. This builds one edited
copy of the source per entry of VARIANTS (an entry names only the lines it
changes), all nvcc processes at once, under `build/sweep/`, holds every
variant's forward against the plain PyTorch version at every bf16 case of
`chip_smoke.py` (O within 2e-2 of its largest value, lse 1e-5 abs + 1e-6
rel; a case that misses names its first wrong rows), and times it by
CUDA-graph replay at the LLaVA-1.5-7B LM layer (32, 665, 128, causal) and
the CLIP text tower (96, 77, 64, causal), every variant twice in turns.
One JSON line per variant: registers, spills (ptxas) and dynamic shared
memory per head dim, max errors, ms. Then SDPA's forward at both shapes and
the card's name and power limit. Exits 1 if the source as it stands
(variant 0) misses a case. Needs a GPU.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPE_LINE = r"struct Bf16Fwd<(64|128)> \{ static constexpr int kN = (\d+), kStages = (\d+); \};"
# {head dim: (kN, kStages)}; {} is the source as it stands
VARIANTS = [
    {},
    {64: (64, 3), 128: (64, 3)},
    {64: (128, 2), 128: (128, 2)},
    {64: (64, 4), 128: (64, 1)},
    {64: (128, 3), 128: (128, 1)},
    {64: (64, 1), 128: (64, 4)},
]
LLAVA = "llava_lm (32, 665, 128)"
CLIP = "clip_text (96, 77, 64)"


def smem_bytes(d: int, n: int, stages: int) -> int:
    """Dynamic shared memory of the kernel, as `WgFwd<D>::kSmem` computes it."""
    return 1024 + 64 * d * 2 + stages * 2 * n * d * 2 + 8 * (stages + 1)


def build(variants):
    from robustvlm_tpu_torch.ops.kernels import _build, flash_attention

    src = (_build.CSRC / "flash_attention.cu").read_text()
    in_source = {int(m[0]): (int(m[1]), int(m[2])) for m in re.findall(SHAPE_LINE, src)}
    if len(in_source) != 2:
        raise RuntimeError("the two Bf16Fwd<...> lines were not found in flash_attention.cu")

    def edited(change):
        def line(m):
            n, stages = change.get(int(m.group(1)), (m.group(2), m.group(3)))
            return (f"struct Bf16Fwd<{m.group(1)}> {{ static constexpr int kN = {n}, "
                    f"kStages = {stages}; }};")
        return re.sub(SHAPE_LINE, line, src)

    sources = {i: edited(change) for i, change in enumerate(variants)}
    libs = {}
    for i, (lib, log) in _build.build_variants(sources, ROOT / "build" / "sweep", "fb").items():
        shapes = {**in_source, **variants[i]}
        lines = log.splitlines()
        report = {}
        for k, ln in enumerate(lines):
            m = re.search(r"flash_fwd_wgmma_kernelILi(64|128)E", ln)
            if m and "Compiling entry" in ln:
                text = " ".join(lines[k + 1:k + 4])
                d = int(m.group(1))
                n, stages = shapes[d]
                regs = re.search(r"Used (\d+) registers", text)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
                report[f"D={d}"] = {
                    "kN": n, "kStages": stages,
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_bytes": [int(spill.group(1)), int(spill.group(2))] if spill else None,
                    "smem_bytes": smem_bytes(d, n, stages)}
        libs[i] = (flash_attention.bind(lib), report)
    return libs


def forward(lib, q, k, v, causal, slopes=None):
    """A closure that launches one variant's forward on these tensors, and
    its outputs."""
    import torch

    from robustvlm_tpu_torch.ops.kernels import flash_attention as F

    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], device="cuda")
    dims = F._dims(q, k, causal)
    sl = None if slopes is None else slopes.data_ptr()

    def fwd():
        err = lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                 lse.data_ptr(), sl, *dims, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"forward launch failed: cudaError {err}")

    return fwd, (o, lse)


def check(lib) -> dict:
    """Every bf16 case of chip_smoke.py: {case: max errors, within, first
    wrong (head, row) pairs}."""
    import torch

    import chip_smoke as C
    from robustvlm_tpu_torch.ops.kernels import flash_attention as F

    out = {}
    for label, bh, nq, nk, d, causal, alibi, extreme in C._flash_cases():
        (q, k, v, _), slopes = C._flash_inputs(bh, nq, nk, d, torch.bfloat16, nq + nk, extreme, alibi)
        fwd, (o, lse) = forward(lib, q, k, v, causal, slopes)
        fwd()
        torch.cuda.synchronize()
        o_ref, lse_ref = F.flash_fwd_plain(q, k, v, causal=causal, slopes=slopes)
        res = C._attn_check("bfloat16", (o, lse), (o_ref, lse_ref), extreme)
        row_err = torch.maximum((o.float() - o_ref.float()).abs().amax(-1) / o_ref.float().abs().max(),
                                (lse - lse_ref).abs())
        bad = torch.nonzero(row_err > 2e-2)[:6].tolist()
        out[label] = {"max_abs_err": {n: e for n, (e, _) in res.items()},
                      "within": all(ok for _, ok in res.values()), "first_wrong_head_row": bad}
    return out


def main() -> int:
    import torch
    import torch.nn.functional as Fn

    import chip_smoke as C

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    libs = build(VARIANTS)
    bh, n, _, d = C._flash_llava_shape()
    shapes = {LLAVA: (bh, n, d), CLIP: C.CLIP_TEXT_SHAPE}
    data = {label: C._flash_inputs(b, m, m, e, torch.bfloat16, seed=1)[0][:3]
            for label, (b, m, e) in shapes.items()}
    results = {i: {"ptxas": report, "cases": check(lib), **{label: [] for label in shapes}}
               for i, (lib, report) in libs.items()}
    for _ in range(2):  # every variant twice, in turns
        for i, (lib, _) in libs.items():
            for label, (q, k, v) in data.items():
                results[i][label].append(C.time_graph_ms(forward(lib, q, k, v, True)[0]))
    for i, r in results.items():
        ok = all(c["within"] for c in r["cases"].values())
        wrong = {c: v for c, v in r["cases"].items() if not v["within"]}
        print(json.dumps({"variant": i, "change": {str(k): v for k, v in VARIANTS[i].items()},
                          "ptxas": r["ptxas"], "all_cases_within": ok, "wrong_cases": wrong,
                          "worst_o_err": max(c["max_abs_err"]["o"] for c in r["cases"].values()),
                          "fwd_ms": {label: r[label] for label in shapes}}), flush=True)
    for label, (q, k, v) in data.items():
        b, m, e = shapes[label]
        q4, k4, v4 = (t.view(1, b, m, e) for t in (q, k, v))
        ms = C.time_graph_ms(lambda: Fn.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
        print(json.dumps({"library": "scaled_dot_product_attention", "shape": label, "fwd_ms": ms}))
    print(C.card_line())
    return 0 if all(c["within"] for c in results[0]["cases"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
