#!/usr/bin/env python3
"""Sweep the bf16 attention backward's tile shape on one GPU.

    python3 scripts/sweep_attention_bf16_bwd_torch.py

The bf16 backward of `robustvlm_tpu_torch/csrc/attention.cu` is the wgmma +
TMA pair of `csrc/attn_bf16_bwd.cuh`, each launch with its tile shape from
one line of its table set: `Bf16Bwd<64|128>` for the flash launches,
`VitBf16Bwd<64|80|88>` for the ViT's, each (kN keys a tile in dQ, kM
queries a tile in dK/dV, kStages TMA stages). This builds one edited copy
of the source per entry of VARIANTS (an entry names the head dims whose
lines it changes, in every table set that has them), all nvcc processes at
once, under `build/sweep/`, holds every variant's backward against the
plain PyTorch version at every bf16 case of `chip_smoke.py` (the flash
cases and the ViT cases; each gradient within 2e-2 of its largest value;
the backward given the plain forward's O and lse) and bitwise repeatable,
and times it by CUDA-graph replay at the LLaVA-1.5-7B LM layer (32, 665,
128, causal), at ViT-L/14 (128, 257, 64), at head dim 80 (128, 257, 80)
and at ViT-g/14 (128, 257, 88), every variant twice in turns. One JSON line per variant: registers, spills (ptxas) and dynamic shared
memory per kernel and head dim, max errors (a case that misses names its
worst tensor), ms. Then SDPA's backward at each shape by graph replay (as
`chip_smoke.py` times it) and the card's name and power limit. Exits 1 if
the source as it stands (variant 0) misses a case. Needs a GPU.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the lines of each table set, by the struct its kernels carry in their names
LINES = {"Bf16Bwd": r"struct Bf16Bwd<(64|128)> \{ static constexpr int kN = (\d+), kM = (\d+), kStages = (\d+); \};",
         "VitBf16Bwd": r"struct VitBf16Bwd<(64|80|88)> \{ static constexpr int kN = (\d+), kM = (\d+), kStages = (\d+); \};"}
# {head dim: (kN, kM, kStages)}; {} is the source as it stands
VARIANTS = [
    {},
    {64: (64, 64, 2)},
    {64: (32, 32, 2)},
    {128: (64, 32, 2), 80: (64, 32, 2), 88: (64, 32, 2)},
    {64: (64, 64, 3), 128: (64, 64, 3), 80: (64, 64, 3), 88: (64, 64, 3)},
    {128: (128, 64, 2), 80: (128, 64, 2), 88: (128, 64, 2)},
]
FLASH, VIT = "flash (32, 665, 128) causal", "vit (128, 257, 64)"
VIT80, VIT88 = "vit (128, 257, 80)", "vit (128, 257, 88)"


def smem_bytes(d: int, n: int, m: int, stages: int) -> dict:
    """Dynamic shared memory of the two kernels, as `WgBwd<D, S>` computes it."""
    dt = 64 if d <= 64 else 128
    own = 2 * 64 * dt * 2
    tail = 8 * (stages + 1)
    return {"dq": 1024 + own + stages * 2 * n * dt * 2 + 4 * 64 + tail,
            "dkv": 1024 + own + stages * 2 * m * dt * 2 + 4 * 2 * m * stages + tail}


def build(variants):
    """{variant: (bound library, ptxas report)}, one edited attention.cu each."""
    from robustvlm_tpu_torch.ops.kernels import _build, flash_attention

    src = (_build.CSRC / "attention.cu").read_text()
    in_source = {}
    for struct, pattern in LINES.items():
        found = re.findall(pattern, src)
        if len(found) != pattern.count("|") + 1:
            raise RuntimeError(f"the {struct}<...> lines were not found in attention.cu")
        in_source[struct] = {int(m[0]): tuple(map(int, m[1:])) for m in found}

    def edited(change):
        def line(m):
            n, mm, st = change.get(int(m.group(1))) or m.groups()[1:]
            struct = m.group(0).split("<")[0]
            return f"{struct}<{m.group(1)}> {{ static constexpr int kN = {n}, kM = {mm}, kStages = {st}; }};"
        out = src
        for pattern in LINES.values():
            out = re.sub(pattern, line, out)
        return out

    built = _build.build_variants({i: edited(change) for i, change in enumerate(variants)},
                                  ROOT / "build" / "sweep", "bb")
    libs = {}
    for i, (lib, log) in built.items():
        lines = log.splitlines()
        report = {}
        for k, ln in enumerate(lines):
            m = re.search(r"attn_bwd_(dq|dkv)_wgmma_kernelILi(\d+)E", ln)
            struct = next((s for s in LINES if f"{len(s)}{s}ILi" in ln), None)
            d = int(m.group(2)) if m else None
            if m and "Compiling entry" in ln and struct and d in in_source[struct]:
                text = " ".join(lines[k + 1:k + 4])
                shape = variants[i].get(d) or in_source[struct][d]
                regs = re.search(r"Used (\d+) registers", text)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
                report[f"{struct}: {m.group(1)}<{d}>"] = {
                    "shape": list(shape),
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_bytes": [int(spill.group(1)), int(spill.group(2))] if spill else None,
                    "smem_bytes": smem_bytes(d, *shape)[m.group(1)]}
        libs[i] = (flash_attention.bind(lib), report)
    return libs


def main() -> int:
    import torch
    import torch.nn.functional as Fn

    import chip_smoke as C
    from robustvlm_tpu_torch.ops.kernels import _heads
    from robustvlm_tpu_torch.ops.kernels import flash_attention as F
    from robustvlm_tpu_torch.ops.kernels import vit_attention as A

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    libs = build(VARIANTS)

    def stream():  # read at each launch: a graph capture runs on a stream of its own
        return torch.cuda.current_stream().cuda_stream

    # every bf16 case of chip_smoke.py: (label, table set, inputs, extreme, reference)
    cases = []
    for label, bh, nq, nk, d, causal, alibi, extreme in C._flash_cases():
        (q, k, v, do), slopes = C._flash_inputs(bh, nq, nk, d, torch.bfloat16, nq + nk, extreme, alibi)
        o, lse = F.flash_fwd_plain(q, k, v, causal=causal, slopes=slopes)
        ref = F.flash_bwd_plain(q, k, v, o, lse, do, causal=causal, slopes=slopes)
        cases.append((f"flash {label}", F.FLASH.tables, (q, k, v, o, lse, do, slopes, causal),
                      extreme, ref))
    for n, d, extreme in C.ATTN_CASES:
        q, k, v, do = C._qkv(n, torch.bfloat16, seed=n + d, extreme=extreme, d=d)
        o, lse = A.attention_fwd_plain(q, k, v)
        cases.append((f"vit n={n} d={d}{' extreme' if extreme else ''}", A.VIT.tables,
                      (q, k, v, o, lse, do, None, False), extreme, A.attention_bwd_plain(q, k, v, o, lse, do)))

    def launcher(lib, tables, args):
        q, k, v, o, lse, do, slopes, causal = args
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty(q.shape[:2], device="cuda")
        ptrs = [t.data_ptr() for t in (q, k, v, o, lse, do)]
        outs = [t.data_ptr() for t in (*grads, delta)]
        keep = (grads, delta)  # the launch writes them: they live as long as fn
        st = _heads.strides((q, k, v, o, do, *grads))
        dims = F._dims(q, k, causal, tables)
        sl = None if slopes is None else slopes.data_ptr()

        def fn(keep=keep):
            if lib.attn_bwd(*ptrs, sl, *outs, *dims, st, stream()):
                raise RuntimeError(f"backward launch failed (tables {tables})")
        return fn, grads

    def kernel_us(fn, calls: int = 5) -> dict:
        """Device us per call of the dQ and the dK/dV kernel (torch.profiler)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = {"dq": 0.0, "dkv": 0.0}
        for e in prof.events():
            for kind in us:
                if f"attn_bwd_{kind}_wgmma_kernel" in e.name:
                    us[kind] += e.device_time_total / calls
        return us

    results = {}
    for i, (lib, report) in libs.items():
        errs, within, repeatable = {}, True, True
        for label, tables, args, extreme, ref in cases:
            fn, grads = launcher(lib, tables, args)
            fn()
            first = [g.clone() for g in grads]
            fn()
            torch.cuda.synchronize()
            res = C._attn_check("bfloat16", grads, ref, extreme, C.ATTN_OUTPUTS[2:])
            errs[label] = {o: e for o, (e, _) in res.items()}
            ok = all(w for _, w in res.values())
            if not ok:
                errs[label]["missed"] = [o for o, (_, w) in res.items() if not w]
            within &= ok
            repeatable &= all(torch.equal(a, b) for a, b in zip(first, grads))
        results[i] = {"within": within, "bitwise_repeatable": repeatable}
        if i == 0:
            checked_ok = within and repeatable
        print(json.dumps({"variant": i, "change": VARIANTS[i] or "source", "ptxas": report,
                          **results[i], "max_abs_err": errs}), flush=True)
    timing = {FLASH: next(c for c in cases if c[0] == "flash llava_lm"),
              VIT: next(c for c in cases if c[0] == "vit n=257 d=64"),
              VIT80: next(c for c in cases if c[0] == "vit n=257 d=80"),
              VIT88: next(c for c in cases if c[0] == "vit n=257 d=88")}
    for i, (lib, _) in libs.items():
        results[i] = {"ms": {key: [] for key in timing},
                      "kernel_us": {key: kernel_us(launcher(lib, tables, args)[0])
                                    for key, (_, tables, args, _, _) in timing.items()}}
    for _ in range(2):  # every variant twice, in turns
        for i, (lib, _) in libs.items():
            for key, (_, tables, args, _, _) in timing.items():
                results[i]["ms"][key].append(C.time_graph_ms(launcher(lib, tables, args)[0]))
    for i, r in results.items():
        print(json.dumps({"variant": i, "change": VARIANTS[i] or "source", **r}), flush=True)
    library = {}
    for key, (_, tables, args, _, _) in timing.items():
        q, k, v, _, _, do, _, causal = args
        bh, n, d = q.shape
        shape = (1, bh, n, d) if tables == F.FLASH.tables else (8, bh // 8, n, d)
        q4, k4, v4, do4 = (t.reshape(shape) for t in (q, k, v, do))
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
        library[key] = C.time_graph_fwd_bwd_ms(
            lambda a, b, c, causal=causal: Fn.scaled_dot_product_attention(a, b, c, is_causal=causal),
            (ql, kl, vl), do4)
    print(json.dumps({"library": "scaled_dot_product_attention backward", **library}))
    print(C.card_line())
    return 0 if checked_ok else 1


if __name__ == "__main__":
    sys.exit(main())
