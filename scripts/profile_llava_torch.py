#!/usr/bin/env python3
"""Where the time of one LLaVA APGD iteration goes, for the PyTorch/CUDA port.

    python3 scripts/profile_llava_torch.py [--iters 5] [--layers 32]

Runs `apgd_attack` on the LLaVA-1.5-7B adapter (random weights from seed 0,
bf16, batch 1, the captioning prompt teacher-forced at max_post_len 64, 336
px) as `run_evaluation --attack apgd` drives it. Prints one JSON line: ms
per iteration without the profiler (mean of --iters, after a warm-up), then
under `torch.profiler` the device time per iteration, the device's busy
share and the device time by group (flash kernels, ViT attention kernels,
the l-inf step, matrix products, everything else) with the top kernels by
name. The full table goes to chiprun_out/profile_llava_torch.json. Needs a
GPU; raises without one.
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
    low = name.lower()
    if "flash_" in name and "_kernel" in name:
        return "flash_kernels"
    if any(k in name for k in ("fwd_mma_kernel", "bwd_dq_mma_kernel", "bwd_dkv_mma_kernel")):
        return "vit_kernels"
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


if __name__ == "__main__":
    sys.exit(main())
