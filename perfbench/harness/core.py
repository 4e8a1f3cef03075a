"""One run of one cell: set-up, the measured window, the check, the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's file names its configuration, traffic and entry. The entry's
`Cell` drives the program: `setup()` (weights from the seed, warm-up of the
cell's own shapes), `unit(i)` (one attack chunk, caption group or training
step, ended by a synchronize; returns the work it did), `release()` (drops
the program's state once the window has closed), `check()` (the numbers
compared with the plain reference, each with its limit) and `layer_ctx()`
(what the per-layer readers take).

The window starts after set-up and ends when the unit in flight at
`--seconds` ends: a rate is all the work over all the time of the window.
`setup_s` runs from the process's start to the window's. `peak_gib` is the
device's peak allocation over the window, read before the reference runs.
With `--trace 1` one traced stretch inside the window gives the per-layer
metrics and the breakdown; the end-to-end metrics come from `--trace 0`.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

from harness import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "robustvlm_tpu")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="run one benchmark cell once")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_env(root=registry.ROOT) -> None:
    """Every build and kernel cache at a fixed directory inside the
    checkout (the port's nvcc builds are in build/kernels already), and no
    JAX from the libraries the port may load."""
    build = root / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton_cache"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ.setdefault("USE_TF", "0")


def loaded_forbidden() -> List[str]:
    """Top-level names of JAX or the JAX package in sys.modules, compared
    whole (robustvlm_tpu_torch is the port, not robustvlm_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card(device_count: int) -> Dict:
    """The card's name and power limit (nvidia-smi) and the device count."""
    import subprocess

    import torch

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             check=True, capture_output=True, text=True, timeout=60).stdout
        line = smi.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        line = f"nvidia-smi unavailable: {e}"
    return {"card": torch.cuda.get_device_name(0), "nvidia_smi": line, "device_count": device_count}


class Run:
    """What an entry's Cell is given: the cell's files and the run's flags."""

    def __init__(self, wl: Dict, cfg: Dict, tr: Dict, seed: int, device, trace: bool):
        from harness.trace import Tracer

        self.config = cfg
        self.traffic = tr
        self.seed = seed
        self.device = device
        self.counts = registry.counts(wl["config"])
        self.tracer = Tracer(trace, device)


def window(cell_obj, seconds: float, device) -> Dict:
    """Units back to back until the one in flight at `seconds` ends."""
    import torch

    work, ends = 0.0, []
    t0 = time.perf_counter()
    while True:
        work += cell_obj.unit(len(ends))
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    unit_s = [b - a for a, b in zip([0.0] + ends, ends)]
    return {"work": work, "units": len(ends), "unit_s": unit_s, "window_s": time.perf_counter() - t0}


def reading(name: str, value: float, limit: float) -> Dict:
    return {"name": name, "value": value, "limit": limit, "ok": bool(value <= limit)}


def execute(cell: str, seed: int, seconds: float, trace: bool, device, t_start: float,
            cfg: Optional[Dict] = None, tr: Optional[Dict] = None) -> Dict:
    """Set-up, window, check and metrics of one run on `device`; returns the
    result line (also the CPU tests' entry: `cfg` and `tr` override the
    cell's files with small sizes)."""
    import torch

    from harness import trace as T

    wl = registry.workload(cell)
    bench = registry.benchmark()
    e2e_names, layer_names = registry.cell_metrics(bench, cell)
    units_of = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    run = Run(wl, registry.config(wl["config"]) if cfg is None else cfg,
              registry.traffic(wl["traffic"]) if tr is None else tr, seed, device, trace)
    cell_obj = registry.entry(wl["entry"]).Cell(run)
    cell_obj.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    print(f"[perfbench] {cell} seed {seed}: set-up {setup_s:.3f} s; window of {seconds} s",
          file=sys.stderr, flush=True)
    win = window(cell_obj, seconds, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    layer_ctx = cell_obj.layer_ctx() if trace else None
    cell_obj.release()
    checks = cell_obj.check(wl["limits"])
    correct = all(c["ok"] for c in checks)

    values = {"setup_s": setup_s, "peak_gib": peak / 2 ** 30,
              cell_obj.rate_metric: win["work"] / win["window_s"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": int(wl.get("chips", 1)), "memory_peak_bytes": int(peak)}
    line: Dict = {"correct": correct, "attempted": int(cell_obj.attempted), "failed": int(cell_obj.failed)}
    if trace:
        summary = run.tracer.reduce() if device.type == "cuda" else None
        ctx = dict(layer_ctx, trace=summary)
        metrics = {}
        for name in layer_names:
            v = registry.metric(name).read(ctx)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units_of[name]}
        line["metrics"] = metrics
        if summary is not None:
            dev_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            line["breakdown"] = T.breakdown(summary)
    else:
        line["metrics"] = {n: {"value": float(values[n]), "unit": units_of[n]}
                           for n in e2e_names if n in values}
    line["device"] = dev_info
    line["window"] = {"units": win["units"], "unit_s": win["unit_s"], "work": win["work"],
                      "seconds": win["window_s"]}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    for c in checks:
        print(f"[check] {c['name']} = {c['value']:.6g} (limit {c['limit']:.6g}) "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    return line


def main(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cache_env()
    import torch

    wl = registry.workload(args.workload)
    chips = int(wl.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[perfbench] {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(registry.ROOT))
    import robustvlm_tpu_torch  # noqa: F401  (the program: without it, no run and no result)

    c = card(torch.cuda.device_count())
    print(f"[perfbench] card: {c['nvidia_smi']}; devices: {c['device_count']}", flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line = execute(args.workload, args.seed, args.seconds, bool(args.trace), device, t_start)
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"[perfbench] sys.modules holds {', '.join(forbidden)}: the port may not load JAX",
              file=sys.stderr)
        return 3
    for m in line["metrics"].values():
        if not math.isfinite(m["value"]):
            print(f"[perfbench] a metric is not finite: {line['metrics']}", file=sys.stderr)
            return 4
    print(json.dumps(line), flush=True)
    return 0
