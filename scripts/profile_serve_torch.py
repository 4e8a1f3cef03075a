#!/usr/bin/env python3
"""Where the time of a LLaVA-1.5-7B int4 decode step goes, for the
PyTorch/CUDA port's serving worker.

    python3 scripts/profile_serve_torch.py [--steps 16] [--batches 1,4]

Builds the worker's adapter as `serve.model_worker` does with
`--model llava --model_size 7b --quantize-decode --quantize-bits 4`
(random weights from seed 0, float32 draws quantized in place, bf16
compute), prefills a caption prompt for one seeded image repeated to the
batch, then runs `--steps` greedy decode steps (`generation.greedy_generate`
after the prefill): first without the profiler (ms per step, synchronized),
then under `torch.profiler`. Prints one JSON line per batch: ms per step,
device ms per step, the device's busy share, device ms per step by group
(the q4_matmul kernel, cuBLAS products, everything else), kernels launched
per step and the top kernels by name. The full tables go to
chiprun_out/profile_serve_torch.json. Needs a GPU; raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MATMUL = ("gemm", "cutlass", "xmma", "sm90_", "cublas", "nvjet", "gemv")


def group(name: str) -> str:
    if "q4_matmul_kernel" in name:
        return "q4_matmul"
    if any(k in name.lower() for k in MATMUL):
        return "matmul"
    return "other"


def main(argv=None) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import SERVE_ARGV, card_line
    from robustvlm_tpu_torch.device import use_full_fp32
    from robustvlm_tpu_torch.models.generation import greedy_generate
    from robustvlm_tpu_torch.serve import model_worker as MW

    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--batches", default="1,4")
    args = p.parse_args(argv)
    use_full_fp32()
    adapter = MW.build_worker(MW.build_parser().parse_args(SERVE_ARGV)).model
    size = adapter.cfg.vision.image_size
    x1 = torch.from_numpy(np.random.RandomState(0).rand(1, 3, size, size).astype(np.float32)).cuda()
    prompt = adapter.get_caption_prompt()
    eos, pad = -1, adapter.tok.pad_token_id  # eos -1: every step decodes

    def decode(batch):
        """A prefilled generation's decode steps, ready to run."""
        pf, df, toks, n_pad = adapter._decode_fns(x1.expand(batch, -1, -1, -1), [prompt] * batch,
                                                  args.steps)
        with torch.no_grad():
            ar = torch.arange(toks.shape[1], device=toks.device)[None, :]
            done = pf(toks, ar >= n_pad[:, None], torch.clamp(ar - n_pad[:, None], min=0))
        torch.cuda.synchronize()
        return lambda: greedy_generate(lambda *a: done, df, toks, n_pad, max_new_tokens=args.steps,
                                       eos_id=eos, pad_id=pad)

    results = []
    for batch in (int(b) for b in args.batches.split(",")):
        decode(batch)()  # warm-up
        run = decode(batch)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms_per_step = (time.perf_counter() - t0) * 1e3 / args.steps
        run = decode(batch)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = []
        for evt in prof.key_averages():
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "self_cuda_time_total", 0.0)
            if dev_us > 0 and "CUDA" in str(getattr(evt, "device_type", "")):
                rows.append({"name": evt.key, "device_ms_per_step": dev_us / 1e3 / args.steps,
                             "launches_per_step": evt.count / args.steps, "group": group(evt.key)})
        rows.sort(key=lambda r: -r["device_ms_per_step"])
        total = sum(r["device_ms_per_step"] for r in rows)
        by_group, launches = {}, {}
        for r in rows:
            by_group[r["group"]] = by_group.get(r["group"], 0.0) + r["device_ms_per_step"]
            launches[r["group"]] = launches.get(r["group"], 0.0) + r["launches_per_step"]
        summary = {
            "script": "scripts/profile_serve_torch.py", "device": torch.cuda.get_device_name(0),
            "card": card_line(), "model": "llava-1.5-7b", "weights": "int4 LM, group 128",
            "compute_dtype": "bfloat16", "batch": batch, "steps": args.steps,
            "ms_per_step": ms_per_step, "profiled_ms_per_step": wall * 1e3 / args.steps,
            "device_ms_per_step": total, "device_busy_share": total * args.steps / (wall * 1e3),
            "device_ms_per_step_by_group": by_group, "kernels_per_step_by_group": launches,
            "kernels_per_step": sum(launches.values()), "top": rows[:12],
        }
        results.append({**summary, "all": rows})
        print(json.dumps(summary), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_serve_torch.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
