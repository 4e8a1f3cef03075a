#!/usr/bin/env python3
"""Sweep the bf16 attention forward's tile shape on one GPU, for the flash
attention or (with --vit) the ViT attention.

    python3 scripts/sweep_flash_bf16_torch.py [--vit]

`attn_fwd_wgmma_kernel` (`robustvlm_tpu_torch/csrc/attn_bf16_fwd.cuh`) takes
its shape from one line per head dim of its table set in
`robustvlm_tpu_torch/csrc/attention.cu`: `Bf16Fwd<64|80|128>` for the
flash launches, `VitBf16Fwd<64|80|88>` for the ViT's (--vit). A line holds
kN keys per tile (the N of S = Q K^T) and kStages stages of the TMA ring (a
block is one warpgroup of 64 query rows). This builds one edited copy of the source per entry of
the target's variants (an entry names only the lines it changes), all nvcc
processes at once, under `build/sweep/`, holds every variant's forward
against the plain PyTorch version at every bf16 case of `chip_smoke.py`
(flash: `_flash_cases`; ViT: `ATTN_CASES`; O within 2e-2 of its largest
value, lse 1e-5 abs + 1e-6 rel; a case that misses names its first wrong
rows), and times it by CUDA-graph replay, every variant twice in turns:
flash at the LLaVA-1.5-7B LM layer (32, 665, 128, causal) and the CLIP text
tower (96, 77, 64, causal); ViT at ViT-L/14 (128, 257, 64), the shape that
chooses its lines, ViT-L/14-336 (128, 577, 64), head dim 80 (128, 257,
80) and ViT-g/14's head dim 88 (128, 257, 88). One JSON line per variant: registers, spills (ptxas) and dynamic
shared memory per head dim, max errors, ms. Then SDPA's forward at every
timed shape and the card's name and power limit. Exits 1 if the source as
it stands (variant 0) misses a case. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# {head dim: (kN, kStages)}; {} is the source as it stands
TARGETS = {
    "flash": {
        "struct": "Bf16Fwd", "dims": (64, 80, 128), "tables": 0,
        "variants": [
            {},
            {64: (64, 3), 128: (64, 3)},
            {64: (128, 2), 128: (128, 2)},
            {64: (64, 4), 128: (64, 1)},
            {64: (128, 3), 128: (128, 1)},
            {64: (64, 1), 128: (64, 4)},
        ],
    },
    "vit": {
        "struct": "VitBf16Fwd", "dims": (64, 80, 88), "tables": 1,
        "variants": [
            {},
            {64: (32, 2), 80: (32, 2), 88: (32, 2)},
            {64: (32, 3), 80: (32, 3), 88: (32, 3)},
            {64: (64, 3), 80: (64, 3), 88: (64, 3)},
            {64: (128, 2), 80: (128, 2), 88: (128, 2)},
        ],
    },
}


def shape_line(struct: str) -> str:
    return rf"struct {struct}<(\d+)> \{{ static constexpr int kN = (\d+), kStages = (\d+); \}};"


def smem_bytes(d: int, n: int, stages: int) -> int:
    """Dynamic shared memory of the kernel, as `WgFwd<D, S>::kSmem` computes it."""
    dt = 64 if d <= 64 else 128
    return 1024 + 64 * dt * 2 + stages * 2 * n * dt * 2 + 8 * (stages + 1)


def build(target: dict):
    from robustvlm_tpu_torch.ops.kernels import _build, flash_attention

    src = (_build.CSRC / "attention.cu").read_text()
    pat = shape_line(target["struct"])
    in_source = {int(m[0]): tuple(map(int, m[1:])) for m in re.findall(pat, src)}
    if set(in_source) != set(target["dims"]):
        raise RuntimeError(f"the {target['struct']}<...> lines were not found in attention.cu")

    def edited(change):
        def line(m):
            n, stages = change.get(int(m.group(1)), (m.group(2), m.group(3)))
            return (f"struct {target['struct']}<{m.group(1)}> {{ static constexpr int kN = {n}, "
                    f"kStages = {stages}; }};")
        return re.sub(pat, line, src)

    variants = target["variants"]
    sources = {i: edited(change) for i, change in enumerate(variants)}
    mangled = f"{len(target['struct'])}{target['struct']}ILi"  # this set's kernels only
    libs = {}
    for i, (lib, log) in _build.build_variants(sources, ROOT / "build" / "sweep", "fb").items():
        shapes = {**in_source, **variants[i]}
        lines = log.splitlines()
        report = {}
        for k, ln in enumerate(lines):
            m = re.search(r"attn_fwd_wgmma_kernelILi(\d+)E", ln)
            if m and "Compiling entry" in ln and mangled in ln:
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


def forward(lib, q, k, v, causal, slopes=None, vit=False):
    """A closure that launches one variant's forward on these tensors (with
    the ViT's table set when vit), and its outputs."""
    import torch

    from robustvlm_tpu_torch.ops.kernels import _heads
    from robustvlm_tpu_torch.ops.kernels import flash_attention as F

    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], device="cuda")
    sl = None if slopes is None else slopes.data_ptr()
    args = (sl, *F._dims(q, k, causal, TARGETS["vit" if vit else "flash"]["tables"]),
            _heads.strides((q, k, v, o)))

    def fwd():
        err = lib.attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                           *args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"forward launch failed: cudaError {err}")

    return fwd, (o, lse)


def check(lib, vit: bool) -> dict:
    """Every bf16 case of chip_smoke.py: {case: max errors, within, first
    wrong (head, row) pairs}."""
    import torch

    import chip_smoke as C
    from robustvlm_tpu_torch.ops.kernels import flash_attention as F
    from robustvlm_tpu_torch.ops.kernels import vit_attention as A

    out = {}
    if vit:
        cases = [(f"n{n}_d{d}" + ("_extreme" if ex else ""), n, d, ex) for n, d, ex in C.ATTN_CASES]
    else:
        cases = [(c[0], c) for c in C._flash_cases()]
    for case in cases:
        if vit:
            label, n, d, extreme = case
            q, k, v, _ = C._qkv(n, torch.bfloat16, seed=n + d, extreme=extreme, d=d)
            fwd, (o, lse) = forward(lib, q, k, v, False, vit=True)
            ref = A.attention_fwd_plain(q, k, v)
        else:
            label, (_, bh, nq, nk, d, causal, alibi, extreme) = case
            (q, k, v, _), slopes = C._flash_inputs(bh, nq, nk, d, torch.bfloat16, nq + nk, extreme,
                                                   alibi)
            fwd, (o, lse) = forward(lib, q, k, v, causal, slopes)
            ref = F.flash_fwd_plain(q, k, v, causal=causal, slopes=slopes)
        fwd()
        torch.cuda.synchronize()
        o_ref, lse_ref = ref
        res = C._attn_check("bfloat16", (o, lse), (o_ref, lse_ref), extreme, ("o", "lse"))
        row_err = torch.maximum((o.float() - o_ref.float()).abs().amax(-1) / o_ref.float().abs().max(),
                                (lse - lse_ref).abs())
        bad = torch.nonzero(row_err > 2e-2)[:6].tolist()
        out[label] = {"max_abs_err": {n: e for n, (e, _) in res.items()},
                      "within": all(ok for _, ok in res.values()), "first_wrong_head_row": bad}
    return out


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as Fn

    import chip_smoke as C

    ap = argparse.ArgumentParser()
    ap.add_argument("--vit", action="store_true", help="sweep the ViT forward's VitBf16Fwd lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    target = TARGETS["vit" if args.vit else "flash"]
    libs = build(target)
    if args.vit:
        shapes = {"vit_l14 (128, 257, 64)": (128, 257, 64), "vit_l14_336 (128, 577, 64)": (128, 577, 64),
                  "d80 (128, 257, 80)": (128, 257, 80), "d88 (128, 257, 88)": (128, 257, 88)}
        data = {label: C._qkv(n, torch.bfloat16, seed=1, d=d)[:3] for label, (_, n, d) in shapes.items()}
        causal = False
    else:
        bh, n, _, d = C._flash_llava_shape()
        shapes = {f"llava_lm ({bh}, {n}, {d})": (bh, n, d), "clip_text (96, 77, 64)": C.CLIP_TEXT_SHAPE}
        data = {label: C._flash_inputs(b, m, m, e, torch.bfloat16, seed=1)[0][:3]
                for label, (b, m, e) in shapes.items()}
        causal = True
    results = {i: {"ptxas": report, "cases": check(lib, args.vit), **{label: [] for label in shapes}}
               for i, (lib, report) in libs.items()}
    for _ in range(2):  # every variant twice, in turns
        for i, (lib, _) in libs.items():
            for label, (q, k, v) in data.items():
                results[i][label].append(
                    C.time_graph_ms(forward(lib, q, k, v, causal, vit=args.vit)[0]))
    for i, r in results.items():
        ok = all(c["within"] for c in r["cases"].values())
        wrong = {c: v for c, v in r["cases"].items() if not v["within"]}
        print(json.dumps({"target": target["struct"], "variant": i,
                          "change": {str(k): v for k, v in target["variants"][i].items()},
                          "ptxas": r["ptxas"], "all_cases_within": ok, "wrong_cases": wrong,
                          "worst_o_err": max(c["max_abs_err"]["o"] for c in r["cases"].values()),
                          "fwd_ms": {label: r[label] for label in shapes}}), flush=True)
    for label, (q, k, v) in data.items():
        b, m, e = shapes[label]
        q4, k4, v4 = (t.view(1, b, m, e) for t in (q, k, v))
        ms = C.time_graph_ms(lambda: Fn.scaled_dot_product_attention(q4, k4, v4, is_causal=causal))
        print(json.dumps({"library": "scaled_dot_product_attention", "shape": label, "fwd_ms": ms}))
    print(C.card_line())
    return 0 if all(c["within"] for c in results[0]["cases"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
