"""Helpers shared by the port's bench scripts (`scripts/bench_*_torch.py`,
`scripts/perf_sweep_torch.py`): the card's name and power limit, the
kernels' launch counts, device timing and the JSON line printer.

Nothing here is a measurement by itself; every script that prints a number
names what it timed and how.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def emit(obj: dict) -> dict:
    """Print one JSON line (flushed) and return the object."""
    print(json.dumps(obj), flush=True)
    return obj


def card() -> Optional[Dict[str, str]]:
    """{'name', 'power_limit'} of the first card (`device.card_line`), or
    None where nvidia-smi is absent (the CPU)."""
    from robustvlm_tpu_torch.device import card_line

    try:
        line = card_line()
    except (OSError, subprocess.SubprocessError):
        return None
    name, _, power = line.partition(",")
    return {"name": name.strip(), "power_limit": power.strip()}


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from robustvlm_tpu_torch.ops import kernels

    kernels.reset_launches()


def launches() -> Dict[str, int]:
    """The port kernels launched since the last reset, by counter name (the
    counters that stayed 0 left out)."""
    from robustvlm_tpu_torch.ops import kernels

    return {k: v for k, v in kernels.launches().items() if v}


def sync(device) -> None:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize()


def timed_s(fn: Callable[[], object], device) -> float:
    """Wall seconds of `fn()` ended by a synchronize of the device."""
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return time.perf_counter() - t0


def events_ms(fn: Callable[[], object], device, iters: int = 1) -> float:
    """Milliseconds of `iters` back-to-back calls of `fn`: CUDA events on a
    card, the host's clock on the CPU."""
    import torch

    if getattr(device, "type", str(device)) != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def peak_gib(device) -> Optional[float]:
    import torch

    if getattr(device, "type", str(device)) != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2**30


def reset_peak(device) -> None:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.reset_peak_memory_stats()
