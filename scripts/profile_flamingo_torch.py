#!/usr/bin/env python3
"""Where the time of one OpenFlamingo-9B APGD iteration goes, for the
PyTorch/CUDA port.

    python3 scripts/profile_flamingo_torch.py [--iters 5]

Runs `apgd_attack` on the OpenFlamingo-9B adapter at full width (random
weights from seed 0, bf16, both gates of every cross-attention block opened
to 0.5 as `chip_smoke.py`'s OpenFlamingo phases open them, batch 1, 224 px,
the 0-shot captioning prompt with 2 text-only demos teacher-forced) as
`run_evaluation --model open_flamingo --attack apgd` drives it. Prints one
JSON line: ms per iteration without the profiler (mean of --iters, after a
warm-up), then under `torch.profiler` the device time per iteration, the
kernels per iteration, the device's busy share and the device time by group
(cuBLAS matrix products, the flash kernels (MPT-7B with ALiBi), the ViT
attention kernels, the l-inf step, everything else: elementwise work,
reductions, copies) with the top kernels by name. The full table goes to
chiprun_out/profile_flamingo_torch.json. Needs a GPU; raises without one.
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

    from chip_smoke import FLAMINGO_IMAGES, _flamingo_cut, card_line, flamingo_prompt, open_gates_
    from profile_llava_torch import group
    from robustvlm_tpu_torch.attacks.apgd import apgd_attack
    from robustvlm_tpu_torch.device import resolve_device, use_full_fp32
    from robustvlm_tpu_torch.models.flamingo.convert import init_random_state
    from robustvlm_tpu_torch.models.flamingo.model import Flamingo
    from robustvlm_tpu_torch.vlm_eval.eval_models import FlamingoEvalModel, WordTokenizer

    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=5)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    use_full_fp32()

    cfg = _flamingo_cut(32, 24)  # the whole of OpenFlamingo-9B
    model = Flamingo.from_state(cfg, init_random_state(cfg, 0, dev, torch.bfloat16))
    with torch.no_grad():
        open_gates_(model)
    adapter = FlamingoEvalModel(model, WordTokenizer(), compute_dtype=torch.bfloat16)
    adapter.set_inputs([flamingo_prompt(adapter, FLAMINGO_IMAGES[0][0])])
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
    by_group, kernels = {}, 0
    for r in rows:
        by_group[r["group"]] = by_group.get(r["group"], 0.0) + r["device_ms"]
        kernels += r["count"]
    summary = {
        "script": "scripts/profile_flamingo_torch.py", "device": torch.cuda.get_device_name(0),
        "card": card_line(), "model": "openflamingo-9b", "dtype": "bfloat16", "batch": 1,
        "prompt_tokens": int(adapter._lang.shape[1]), "iters": args.iters,
        "ms_per_iter": ms_per_iter, "profiled_wall_ms": wall * 1e3, "device_ms": total,
        "device_busy_share": total / (wall * 1e3),
        # iters pixel gradients plus the first point's, the last iteration
        # forward only: iters + 1 evaluations in all
        "device_ms_per_iter": total / args.iters,
        "kernels_per_iter": kernels / args.iters,
        "device_ms_per_iter_by_group": {k: v / args.iters for k, v in by_group.items()},
        "top": rows[:15],
    }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_flamingo_torch.json").write_text(json.dumps({**summary, "all": rows}, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
