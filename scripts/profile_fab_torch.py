#!/usr/bin/env python3
"""Where the time of one FAB-T iteration and one Square query goes, for the
PyTorch/CUDA port.

    python3 scripts/profile_fab_torch.py [--iters 5]

Builds the robustbench CLI's classifier (`robustbench.build_classifier`:
CLIP ViT-L/14, random weights, bf16, the std template over ImageNet's 1000
classes) on 8 synthetic 224 px images labelled with its own predictions,
then prints one JSON line:
- ms per FAB-T iteration (one target) by wall clock, best of 2 runs, and
  its parts timed alone by CUDA events: the forward and pixel backward of
  f_y - f_t, one `projection_hyperplane_box` per norm at (8, 150528), and
  the forward that checks the new point;
- the same iterations under `torch.profiler`: device ms by group (the
  port's kernels, matrix products, everything else), kernels an iteration,
  the device's busy share, and the host operations that took the most CPU
  time;
- ms per Square query (l-inf, every example active) by wall clock.
The full profile goes to chiprun_out/profile_fab_torch.json. Needs a GPU
(`--device cpu --model test-tiny` runs it small on the CPU).
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

    from profile_apgd_torch import device_rows
    from robustvlm_tpu_torch.attacks.fab import projection_hyperplane_box, fab_attack
    from robustvlm_tpu_torch.attacks.square import square_attack_linf
    from robustvlm_tpu_torch.data.loaders import SyntheticClassificationDataset
    from robustvlm_tpu_torch.device import resolve_device, use_full_fp32
    from robustvlm_tpu_torch.eval import robustbench

    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--model", default="ViT-L-14")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    use_full_fp32()
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cli = robustbench.build_parser().parse_args(
        ["--device", args.device, "--clip_model_name", args.model, "--template", "std",
         "--dataset", "synthetic", "--compute_dtype", "bfloat16"])
    _, logits_fn, size = robustbench.build_classifier(cli, dev)
    x_np, _ = SyntheticClassificationDataset(n=8, size=size).arrays()
    x = torch.from_numpy(x_np).to(dev)
    with torch.no_grad():
        logits = logits_fn(x)
    y = logits.argmax(-1)
    target = torch.argsort(logits, dim=-1, stable=True)[:, -2]
    eps = 2.0 / 255.0

    def fab(n_iter):
        fab_attack(logits_fn, x, y, n_iter=n_iter, eps=eps, targeted=True, n_target_classes=1)
        sync()

    def wall_ms(fn, *a):
        t0 = time.perf_counter()
        fn(*a)
        return (time.perf_counter() - t0) * 1e3

    def event_ms(fn, reps: int = 5) -> float:
        if not cuda:
            return wall_ms(lambda: [fn() for _ in range(reps)]) / reps
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    fab(1)  # warm-up: kernel build, allocator, cuBLAS heuristics
    fab_ms = min(wall_ms(fab, args.iters) for _ in range(2)) / args.iters

    def fwd_bwd():
        xg = x.detach().requires_grad_(True)
        lg = logits_fn(xg)
        diff = lg.gather(1, y[:, None])[:, 0] - lg.gather(1, target[:, None])[:, 0]
        torch.autograd.grad(diff.sum(), xg)

    def fwd():
        with torch.no_grad():
            logits_fn(x)

    npr = np.random.RandomState(0)
    u = x.reshape(8, -1)
    w = torch.from_numpy(npr.randn(*u.shape).astype(np.float32)).to(dev)
    b = (w * u).sum(1) - torch.from_numpy(np.abs(npr.randn(8)).astype(np.float32) * 50).to(dev)
    parts = {"fwd_bwd_ms": event_ms(fwd_bwd), "fwd_ms": event_ms(fwd)}
    for norm in ("linf", "l2", "l1"):
        parts[f"projection_{norm}_ms"] = event_ms(lambda: projection_hyperplane_box(u, w, b, norm))

    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        wall = wall_ms(fab, args.iters)
    rows = device_rows(prof)
    device = sum(r["device_ms"] for r in rows)
    by_group = {}
    for r in rows:
        by_group[r["group"]] = by_group.get(r["group"], 0.0) + r["device_ms"] / args.iters
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()),
                  key=lambda r: -r[1])[:12]

    def square(n):
        square_attack_linf(logits_fn, x, y, eps=eps, n_queries=n)
        sync()

    square(2)
    # the margin of every example stays >= 0 only while it is not fooled,
    # so time a short run from the start: every example is active
    n_sq = 20
    square_ms = min(wall_ms(square, n_sq) for _ in range(2)) / n_sq

    from chip_smoke import card_line

    summary = {
        "script": "scripts/profile_fab_torch.py", "model": args.model, "dtype": "bfloat16", "batch": 8,
        "card": card_line() if cuda else "cpu", "iters": args.iters,
        "fab_t_ms_per_iter": fab_ms, "parts": parts,
        "profiled_wall_ms_per_iter": wall / args.iters, "device_ms_per_iter": device / args.iters,
        "device_busy_share": device / wall if wall else None,
        "kernels_per_iter": sum(r["count"] for r in rows) / args.iters,
        "device_ms_per_iter_by_group": by_group,
        "top_host_ms": [{"name": n, "self_cpu_ms": t, "count": c} for n, t, c in host],
        "square_ms_per_query": square_ms,
    }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_fab_torch.json").write_text(json.dumps({**summary, "all": rows}, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
