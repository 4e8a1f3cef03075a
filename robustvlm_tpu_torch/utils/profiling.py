"""Throughput and tracing for the training loop.

Counterpart of `robustvlm_tpu/utils/profiling.py`:
- `trace(dir)` records a `torch.profiler` trace (CPU and, on a GPU, CUDA
  activity) of the enclosed region into `dir/trace.json`;
- `annotate(name)` names a region inside such a trace
  (`torch.profiler.record_function`, JAX's `TraceAnnotation`);
- `StepTimer` gives examples per second over a rolling window of steps,
  synchronizing the GPU before it reads the clock, so the rate counts
  finished device work, not enqueued work.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def annotate(name: str):
    """A named region inside a profiler trace, as a context manager."""
    return torch.profiler.record_function(name)


def sync() -> None:
    """Wait for the GPU's queued work (nothing to wait for on the CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Examples per second over a rolling window of `window` steps."""

    def __init__(self, batch_size: int, window: int = 50):
        self.batch_size = batch_size
        self.window = window
        self._t0: Optional[float] = None
        self._steps = 0
        self.rate = 0.0

    def start(self) -> None:
        sync()
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self, n: int = 1) -> Optional[float]:
        """Count n steps; returns the rate when a window completes, else None."""
        if self._t0 is None:
            self.start()
        self._steps += n
        if self._steps >= self.window:
            sync()
            self.rate = self.batch_size * self._steps / (time.perf_counter() - self._t0)
            self.start()
            return self.rate
        return None
