#!/usr/bin/env python3
"""Where the time of one BLIP-2 (blip2-opt-2.7b) APGD iteration goes, for the
PyTorch/CUDA port.

    python3 scripts/profile_blip2_torch.py [--iters 5] [--remat]

Runs `apgd_attack` on the BLIP-2 adapter at full width (EVA ViT-g/14 39
layers, the Q-Former, OPT-2.7B 32 layers; random weights from seed 0, bf16,
batch 1, 224 px, a caption teacher-forced, the adapter's 64 text tokens) as
`run_evaluation --model blip2 --attack apgd` drives it; `--remat` gives the
adapter `remat=True`. Prints one JSON line: ms per iteration without the
profiler (mean of --iters, after a warm-up) and the peak memory above the
held weights, then under `torch.profiler` the device time per iteration,
the kernels per iteration, the device's busy share and the device time by
group (cuBLAS matrix products, the l-inf step, everything else: softmax,
LayerNorm, GELU and other elementwise work, reductions, copies; BLIP-2
launches no attention kernel of the port) with the top kernels by name. The
full table goes to chiprun_out/profile_blip2_torch[_remat].json. Needs a
GPU; raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def main(argv=None) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import LLAVA_IMAGES, card_line
    from profile_llava_torch import group
    from robustvlm_tpu_torch.attacks.apgd import apgd_attack
    from robustvlm_tpu_torch.device import resolve_device, use_full_fp32
    from robustvlm_tpu_torch.models.blip2 import BLIP2_CONFIGS, Blip2, init_random_state
    from robustvlm_tpu_torch.vlm_eval.eval_models import Blip2EvalModel, WordTokenizer

    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--remat", action="store_true")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    use_full_fp32()

    cfg = BLIP2_CONFIGS["blip2-opt-2.7b"]
    model = Blip2.from_state(cfg, init_random_state(cfg, 0, dev, torch.bfloat16))
    adapter = Blip2EvalModel(model, WordTokenizer(), compute_dtype=torch.bfloat16, remat=args.remat)
    adapter.set_inputs([adapter.get_caption_prompt(LLAVA_IMAGES[0][0])])
    size = cfg.vision.image_size
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 3, size, size).astype(np.float32)).to(dev)

    def attack(n_iter):
        apgd_attack(adapter, x, None, criterion=lambda o, y: o, eps=2.0 / 255.0, n_iter=n_iter, norm="linf")
        torch.cuda.synchronize()

    attack(2)  # warm-up: kernel build, allocator, cuBLAS heuristics
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    attack(args.iters)
    ms_per_iter = (time.perf_counter() - t0) * 1e3 / args.iters
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
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
            rows.append({"name": evt.key, "device_ms": dev_us / 1e3, "count": evt.count, "group": group(evt.key)})
    rows.sort(key=lambda r: -r["device_ms"])
    total = sum(r["device_ms"] for r in rows)
    by_group, kernels = {}, 0
    for r in rows:
        by_group[r["group"]] = by_group.get(r["group"], 0.0) + r["device_ms"]
        kernels += r["count"]
    summary = {
        "script": "scripts/profile_blip2_torch.py", "device": torch.cuda.get_device_name(0), "card": card_line(),
        "model": cfg.name, "dtype": "bfloat16", "batch": 1, "remat": args.remat,
        "text_tokens": int(adapter.bound_args[1].shape[1]), "iters": args.iters, "ms_per_iter": ms_per_iter,
        "peak_above_weights_gib": peak, "weights_gib": held / 2**30,
        "profiled_wall_ms": wall * 1e3, "device_ms": total, "device_busy_share": total / (wall * 1e3),
        # iters pixel gradients plus the first point's, the last iteration
        # forward only: iters + 1 evaluations in all
        "device_ms_per_iter": total / args.iters, "kernels_per_iter": kernels / args.iters,
        "device_ms_per_iter_by_group": {k: v / args.iters for k, v in by_group.items()},
        "top": rows[:15],
    }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = "profile_blip2_torch" + ("_remat" if args.remat else "")
    (out / f"{name}.json").write_text(json.dumps({**summary, "all": rows}, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
