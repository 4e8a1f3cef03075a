#!/usr/bin/env python3
"""Sweep the float32 attention kernels' threads per row on one GPU.

    python3 scripts/sweep_vit_attention_fp32_torch.py

The float32 kernels of `robustvlm_tpu_torch/csrc/vit_attention.cu` split each
score's dot product over `kTpr` threads (summed with warp shuffles) and
update the online softmax every `kChunk` keys. This builds one variant of
the source per (kTpr, kChunk), all nvcc processes at once, under
`build/sweep/`, checks each against the plain PyTorch version and prints
one JSON line per variant: forward and backward ms at the ViT-L/14 main
path's shape (B*H = 128, N = 257, D = 64), max abs errors, and the
compiler's spill report. Then the card's name and power limit. Needs a GPU.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = [(4, 16), (2, 16), (1, 16), (2, 32), (1, 32)]  # (kTpr, kChunk)
BH, N, D = 128, 257, 64


def build(variants):
    from robustvlm_tpu_torch.ops.kernels import _build, vit_attention

    src = (_build.CSRC / "vit_attention.cu").read_text()
    sources = {}
    for tpr, chunk in variants:
        s = re.sub(r"constexpr int kTpr = \d+;", f"constexpr int kTpr = {tpr};", src)
        sources[(tpr, chunk)] = re.sub(r"constexpr int kChunk = \d+;",
                                       f"constexpr int kChunk = {chunk};", s)
    libs = {}
    for key, (lib, log) in _build.build_variants(sources, ROOT / "build" / "sweep", "va").items():
        lines = log.splitlines()
        spills = {}
        for i, ln in enumerate(lines):
            m = re.search(r"(fwd|bwd_dq|bwd_dkv)_fma_kernelILi64", ln)
            if m and "Compiling entry" in ln:
                spills[m.group(1)] = next(x.strip() for x in lines[i + 1:] if "spill" in x)
        libs[key] = (vit_attention.bind(lib), spills)
    return libs


def main() -> int:
    import torch

    import chip_smoke as C
    from robustvlm_tpu_torch.device import use_full_fp32
    from robustvlm_tpu_torch.ops.kernels import vit_attention as A

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    use_full_fp32()
    libs = build(VARIANTS)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(BH, N, D, generator=g, device="cuda") * 0.5 for _ in range(4))
    o_ref, lse_ref = A.attention_fwd_plain(q, k, v)
    stream = torch.cuda.current_stream().cuda_stream
    scale = 1.0 / D ** 0.5
    for (tpr, chunk), (lib, spills) in libs.items():
        o, lse = torch.empty_like(q), torch.empty(BH, N, device="cuda")
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        delta = torch.empty(BH, N, device="cuda")

        def fwd():
            return lib.vit_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                    lse.data_ptr(), BH, N, D, 0, scale, stream)

        def bwd():
            return lib.vit_attn_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                    lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                    dv.data_ptr(), delta.data_ptr(), BH, N, D, 0, scale, stream)

        if fwd() or bwd():
            raise RuntimeError(f"launch failed for kTpr, kChunk = {tpr}, {chunk}")
        torch.cuda.synchronize()
        refs = A.attention_bwd_plain(q, k, v, o, lse, do)
        err = {"o": float((o - o_ref).abs().max()), "lse": float((lse - lse_ref).abs().max()),
               "grads": max(float((a - b).abs().max()) for a, b in zip((dq, dk, dv), refs))}
        print(json.dumps({"kTpr": tpr, "kChunk": chunk, "fwd_ms": C.time_ms(fwd, 50),
                          "bwd_ms": C.time_ms(bwd, 50), "max_abs_err": err,
                          "ptxas": spills}), flush=True)
    print(C.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
