#!/usr/bin/env python3
"""Where the time of one LLaVA APGD iteration goes, for the PyTorch/CUDA port.

    python3 scripts/profile_llava_torch.py [--iters 5] [--layers 32]
    python3 scripts/profile_llava_torch.py --other OTHER_ROOT [--pairs 10]

Runs `apgd_attack` on the LLaVA-1.5-7B adapter (random weights from seed 0,
bf16, batch 1, the captioning prompt teacher-forced at max_post_len 64, 336
px) as `run_evaluation --attack apgd` drives it. Prints one JSON line: ms
per iteration without the profiler (mean of --iters, after a warm-up), then
under `torch.profiler` the device time per iteration, the device's busy
share and the device time by group (flash kernels, ViT attention kernels,
the l-inf step, matrix products, everything else) with the top kernels by
name. The full table goes to chiprun_out/profile_llava_torch.json. Needs a
GPU; raises without one.

With --other, it profiles nothing: it builds another checkout's attention
source beside this one's (as `compare_attention_torch.py` does) and times
the same attack with either side's library bound in turn, in pairs
(other-this, this-other, ...) in this one process, so that both sides
share the model, the allocator and the host's state. One JSON line: ms an
iteration per side and run, the means, and the per-pair difference other -
this with its standard deviation.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MATMUL = ("gemm", "cutlass", "xmma", "sm90_", "cublas", "nvjet")


def group(name: str) -> str:
    """A kernel's group by its demangled name. Both attention entry points
    launch the kernels of attn_f32_tile.cuh, attn_bf16_fwd.cuh and
    attn_bf16_bwd.cuh (through attention.cu): the ViT table set's template
    arguments (VitF32Tile, VitBf16Fwd, VitBf16Bwd) tell its launches apart."""
    low = name.lower()
    if any(k in name for k in ("VitF32Tile", "VitBf16Fwd", "VitBf16Bwd")):
        return "vit_kernels"
    if ("flash_" in name and "_kernel" in name) or "attn_fwd_" in name or "attn_bwd_" in name:
        return "flash_kernels"
    if "linf_step" in name:
        return "linf_step"
    if any(k in low for k in MATMUL):
        return "matmul"
    return "other"


def main(argv=None) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import card_line
    from robustvlm_tpu_torch.attacks.apgd import apgd_attack
    from robustvlm_tpu_torch.device import resolve_device, use_full_fp32
    from robustvlm_tpu_torch.models.llava.convert import init_random_state
    from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS, Llava
    from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel, WordTokenizer

    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--layers", type=int, default=32, help="LM layers (32 = LLaVA-1.5-7B)")
    p.add_argument("--other", help="another checkout whose attention kernels to time in turns")
    p.add_argument("--pairs", type=int, default=10)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    use_full_fp32()

    cfg = LLAVA_CONFIGS["llava-1.5-7b"]
    cfg = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama, n_layers=args.layers))
    model = Llava.from_state(cfg, init_random_state(cfg, 0, dev, torch.bfloat16))
    adapter = LlavaEvalModel(model, WordTokenizer(), compute_dtype=torch.bfloat16)
    adapter.set_inputs([adapter.get_caption_prompt("a man riding a wave on top of a surfboard")])
    size = cfg.vision.image_size
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 3, size, size).astype(np.float32)).to(dev)

    def attack(n_iter):
        apgd_attack(adapter, x, None, criterion=lambda o, y: o, eps=2.0 / 255.0,
                    n_iter=n_iter, norm="linf")
        torch.cuda.synchronize()

    attack(2)  # warm-up: kernel build, allocator, cuBLAS heuristics
    if args.other:
        return compare(Path(args.other).resolve(), args.pairs, args.iters, attack)
    t0 = time.perf_counter()
    attack(args.iters)
    ms_per_iter = (time.perf_counter() - t0) * 1e3 / args.iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        attack(args.iters)
        wall = time.perf_counter() - t0

    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0 and getattr(evt, "device_type", None) is not None and "CUDA" in str(evt.device_type):
            rows.append({"name": evt.key, "device_ms": dev_us / 1e3, "count": evt.count,
                         "group": group(evt.key)})
    rows.sort(key=lambda r: -r["device_ms"])
    total = sum(r["device_ms"] for r in rows)
    by_group = {}
    for r in rows:
        by_group[r["group"]] = by_group.get(r["group"], 0.0) + r["device_ms"]
    summary = {
        "script": "scripts/profile_llava_torch.py", "device": torch.cuda.get_device_name(0),
        "card": card_line(), "model": cfg.name, "lm_layers": args.layers, "dtype": "bfloat16",
        "batch": 1, "iters": args.iters, "ms_per_iter": ms_per_iter,
        "profiled_wall_ms": wall * 1e3, "device_ms": total,
        "device_busy_share": total / (wall * 1e3),
        # iters pixel gradients plus the first point's, the last iteration
        # forward only: iters + 1 evaluations in all
        "device_ms_per_iter": total / args.iters,
        "device_ms_by_group": by_group,
        "top": rows[:15],
    }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_llava_torch.json").write_text(json.dumps({**summary, "all": rows}, indent=1))
    print(json.dumps(summary))
    return 0


def compare(other: Path, pairs: int, iters: int, attack) -> int:
    """ms an iteration of `attack` with the other checkout's attention
    library and this one's bound in turn (the shared front's `_lib` rebound)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import compare_attention_torch as CA
    from chip_smoke import card_line

    def run(side: str, label: str) -> float:
        t0 = time.perf_counter()
        attack(iters)
        return (time.perf_counter() - t0) * 1e3 / iters

    turns = CA.in_turns(CA.libraries(other), pairs, run)
    print(json.dumps({"script": "scripts/profile_llava_torch.py --other", "card": card_line(),
                      "iters": iters, "ms_per_iter": turns.pop("values"), **turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
