#!/usr/bin/env python3
"""Where the time of one APGD iteration goes, for the PyTorch/CUDA port.

    python3 scripts/profile_apgd_torch.py [--iters 5] [--dtype bfloat16]
    python3 scripts/profile_apgd_torch.py --other OTHER_ROOT [--pairs 6]

Runs `apgd_attack` at CLIP ViT-L/14 (random weights, batch 8, 224 px) under
`torch.profiler` and prints one JSON line: wall and device time per
iteration, the device's busy share, and device time by group (the port's
CUDA kernels, matrix products, everything else) with the top kernels by
name. The full table goes to chiprun_out/profile_apgd_torch.json. Needs a
GPU; raises without one.

With --other, it builds another checkout's attention source beside this
one's (as `compare_attention_torch.py` does) and runs the same attack with
either side's libraries bound in turn, in this one process: first in pairs
without the profiler (other-this, this-other, ...; ms an evaluation), then
once a side under the profiler (device ms an evaluation, busy share, and
the host-side events that took the most CPU time, by name). One JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the port's kernels that a CLIP attack launches: the attention kernels of
# attention.cu (the ViT's, and the text tower's flash forward) and the l-inf step
OURS = ("flash_fwd_tile_kernel", "flash_bwd_dq_tile_kernel", "flash_bwd_dkv_tile_kernel",
        "attn_fwd_wgmma_kernel", "attn_bwd_dq_wgmma_kernel", "attn_bwd_dkv_wgmma_kernel", "linf_step")
MATMUL = ("gemm", "cutlass", "xmma", "sm90_", "cublas", "nvjet")


def group(name: str) -> str:
    low = name.lower()
    if any(k in name for k in OURS):
        return "port_kernels"
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
    from robustvlm_tpu_torch.eval.classifier import make_zero_shot_classifier
    from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS
    from robustvlm_tpu_torch.models.clip.model import cast_matrices_
    from robustvlm_tpu_torch.ops.losses import ce_loss

    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--other", help="another checkout whose attention kernels to time in turns")
    p.add_argument("--pairs", type=int, default=6)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    use_full_fp32()
    dtype = getattr(torch, args.dtype)

    cfg = CLIP_CONFIGS["ViT-L-14"]
    # the CLI's layout (`phase_timed`, `bench_torch.py`): matrices in dtype,
    # 1-D parameters in float32
    model = cast_matrices_(CLIP(cfg, device=dev).init_random_(0), dtype)
    gen = torch.Generator(device=dev).manual_seed(1)
    temb = torch.randn(cfg.embed_dim, 1000, generator=gen, device=dev)
    logits_fn = make_zero_shot_classifier(model, temb / temb.norm(dim=0, keepdim=True),
                                          compute_dtype=dtype)
    npr = np.random.RandomState(0)
    x = torch.from_numpy(npr.rand(8, 3, 224, 224).astype(np.float32)).to(dev)
    y = torch.from_numpy(npr.randint(0, 1000, 8)).to(dev)

    def attack(n_iter):
        apgd_attack(logits_fn, x, y, criterion=lambda o, t: ce_loss(o, t, reduction="none"),
                    eps=2.0 / 255.0, n_iter=n_iter, norm="linf")
        torch.cuda.synchronize()

    attack(2)  # warm-up: kernel build, allocator, cuBLAS heuristics
    if args.other:
        return compare(Path(args.other).resolve(), args.pairs, args.iters, args.dtype, attack)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        attack(args.iters)
        wall = time.perf_counter() - t0

    rows = device_rows(prof)
    total = sum(r["device_ms"] for r in rows)
    by_group = {}
    for r in rows:
        by_group[r["group"]] = by_group.get(r["group"], 0.0) + r["device_ms"]
    # n_iter + 1 model evaluations, the last one forward only
    evals = args.iters + 1
    summary = {
        "script": "scripts/profile_apgd_torch.py", "device": torch.cuda.get_device_name(0),
        "card": card_line(),
        "dtype": args.dtype, "batch": 8, "iters": args.iters, "wall_ms": wall * 1e3,
        "wall_ms_per_eval": wall * 1e3 / evals, "device_ms": total,
        "device_busy_share": total / (wall * 1e3),
        "device_ms_by_group": by_group,
        "top": rows[:12],
    }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_apgd_torch.json").write_text(json.dumps({**summary, "all": rows}, indent=1))
    print(json.dumps(summary))
    return 0


def device_rows(prof) -> list:
    """The profiled kernels by device time, largest first."""
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0 and getattr(evt, "device_type", None) is not None and "CUDA" in str(evt.device_type):
            rows.append({"name": evt.key, "device_ms": dev_us / 1e3, "count": evt.count,
                         "group": group(evt.key)})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def compare(other: Path, pairs: int, iters: int, dtype: str, attack) -> int:
    """`attack` with the other checkout's attention library and this one's
    bound in turn (the shared front's `_lib` rebound)."""
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT / "scripts"))
    import compare_attention_torch as CA
    from chip_smoke import card_line

    libs = CA.libraries(other)
    evals = iters + 1

    def run(side: str, label: str) -> float:
        t0 = time.perf_counter()
        attack(iters)
        return (time.perf_counter() - t0) * 1e3 / evals

    turns = CA.in_turns(libs, pairs, run)
    profiled = {}
    for side in ("other", "this"):
        CA.bind(libs, side)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            attack(iters)
            wall = time.perf_counter() - t0
        device = sum(r["device_ms"] for r in device_rows(prof))
        host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()),
                      key=lambda r: -r[1])[:15]
        profiled[side] = {"wall_ms_per_eval": wall * 1e3 / evals, "device_ms_per_eval": device / evals,
                          "device_busy_share": device / (wall * 1e3),
                          "top_host_ms": [{"name": n, "self_cpu_ms": t, "count": c} for n, t, c in host]}
    print(json.dumps({
        "script": "scripts/profile_apgd_torch.py --other", "card": card_line(),
        "dtype": dtype, "iters": iters, "ms_per_eval": turns.pop("values"), **turns,
        "profiled": profiled}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
