#!/usr/bin/env python3
"""Where the time of one TeCoA/FARE training step goes, for the PyTorch/CUDA
port.

    python3 scripts/profile_train_torch.py [--config fare4|tecoa2|both] [--steps 2]

Builds the training step as `robustvlm_tpu_torch.train.driver` does, from
`chip_smoke.py`'s `train[fare4]` / `train[tecoa2]` flags (ViT-L/14 full
width, random weights, batch 32 in 4 chunks of 8), runs one warm-up step,
then:
- the stages of one step on the host clock, timed by wrapping the step's
  own methods so that each ends with a synchronize: the frozen embedding,
  the inner attack, the outer forwards and the backward into the weights,
  summed over the chunks; the optimizer update; the rest (the division of
  the gradients by the chunk count, the metrics);
- `--steps` steps under `torch.profiler`: wall and device ms a step, the
  device's busy share, device time by group (the port's CUDA kernels,
  matrix products, the optimizer's multi-tensor kernels, everything else)
  and the top kernels; peak memory.
One JSON line a configuration; the full kernel table goes to
chiprun_out/profile_train_torch.json. Needs a GPU; raises without one.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def group(name: str) -> str:
    import profile_apgd_torch as P

    if "multi_tensor" in name or "adam" in name.lower():
        return "optimizer"
    return P.group(name)


def profile_config(name: str, steps: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as S
    import profile_apgd_torch as P
    from robustvlm_tpu_torch.attacks.apgd import fold_in
    from robustvlm_tpu_torch.data.loaders import SyntheticClassificationDataset
    from robustvlm_tpu_torch.device import resolve_device, use_full_fp32
    from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS
    from robustvlm_tpu_torch.train import driver
    from robustvlm_tpu_torch.train.trainer import TrainStep

    dev = resolve_device("cuda")
    use_full_fp32()
    args = driver.build_parser().parse_args(
        S.TRAIN_COMMON + S.TRAIN_RUNS[name] + ["--output_dir", tempfile.mkdtemp()])
    cfg = driver.train_config(args)
    model = CLIP(CLIP_CONFIGS[args.clip_model_name], device=dev).init_random_(0)
    step = TrainStep(cfg, model, copy.deepcopy(model), driver.text_embedding_for(args, model, dev))
    x, y = SyntheticClassificationDataset(n=args.batch_size, size=model.cfg.image_size).arrays()
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    torch.cuda.reset_peak_memory_stats()
    step(x, y, fold_in(1, 0))  # warm-up: kernel build, allocator, cuBLAS heuristics
    torch.cuda.synchronize()

    # one step's stages on the host clock: the step's own methods, wrapped
    # on the instance so that each call ends with a synchronize
    owners = {"frozen_embedding": step, "inner_attack": step, "outer_loss": step, "chunk_grads": step,
              "step": step.optimizer}
    ms = dict.fromkeys(owners, 0.0)

    def timed(attr, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ms[attr] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    for attr, owner in owners.items():
        setattr(owner, attr, timed(attr, getattr(owner, attr)))
    t0 = time.perf_counter()
    step(x, y, fold_in(1, 1))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    for attr, owner in owners.items():
        delattr(owner, attr)
    # chunk_grads holds the other three and the backward into the weights
    stages = {"frozen_embedding": ms["frozen_embedding"], "inner_attack": ms["inner_attack"],
              "outer_forward": ms["outer_loss"],
              "outer_backward": ms["chunk_grads"] - ms["frozen_embedding"] - ms["inner_attack"]
              - ms["outer_loss"],
              "optimizer": ms["step"], "rest": step_ms - ms["chunk_grads"] - ms["step"]}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(steps):
            step(x, y, fold_in(1, s + 2))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = P.device_rows(prof)
    for r in rows:
        r["group"] = group(r["name"])
    total = sum(r["device_ms"] for r in rows)
    by_group = {}
    for r in rows:
        by_group[r["group"]] = by_group.get(r["group"], 0.0) + r["device_ms"] / steps
    return {"config": name, "argv": S.TRAIN_RUNS[name], "batch": args.batch_size,
            "grad_accum": cfg.grad_accum, "stage_ms": stages, "step_ms": step_ms,
            "steps_profiled": steps, "wall_ms_per_step": wall / steps,
            "device_ms_per_step": total / steps, "device_busy_share": total / wall,
            "device_ms_per_step_by_group": by_group,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "top": rows[:12], "all": rows}


def main(argv=None) -> int:
    import chip_smoke as S

    p = argparse.ArgumentParser()
    p.add_argument("--config", default="both", choices=["fare4", "tecoa2", "both"])
    p.add_argument("--steps", type=int, default=2)
    args = p.parse_args(argv)
    names = ["fare4", "tecoa2"] if args.config == "both" else [args.config]
    results = []
    for name in names:
        res = profile_config(name, args.steps)
        results.append(res)
        print(json.dumps({"script": "scripts/profile_train_torch.py", "card": S.card_line(),
                          **{k: v for k, v in res.items() if k != "all"}}), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_train_torch.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
