"""The device trace of a `--trace 1` run, and its reduction.

`Tracer` opens one `torch.profiler` window (CPU and CUDA activities) inside
the measured window, around a stretch of the timed path that the entry
chooses (a number of model calls of an attack, or whole training steps),
with a synchronize at each end. `reduce_events` turns the profiler's events
into what the per-layer readers take: the CUDA operations with their
device times, the busy time (the union of their intervals) and the window's
length, the kernels by name, and the idle gaps named by the innermost host
operation that was running when each began.

A window in which the profiler recorded no CUDA operation fails the run:
it has no idle share to report.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

MATMUL = ("gemm", "cutlass", "xmma", "sm90_", "cublas", "nvjet")
# the port's CUDA kernels (csrc/): the attention kernels and the l-inf step
PORT_KERNELS = ("flash_fwd_tile_kernel", "flash_bwd_dq_tile_kernel", "flash_bwd_dkv_tile_kernel",
                "attn_fwd_wgmma_kernel", "attn_bwd_dq_wgmma_kernel", "attn_bwd_dkv_wgmma_kernel",
                "linf_step", "q4_matmul")


def group(name: str) -> str:
    """port_kernels, matmul or other (the grouping of the port's profile scripts)."""
    if any(k in name for k in PORT_KERNELS):
        return "port_kernels"
    low = name.lower()
    if any(k in low for k in MATMUL):
        return "matmul"
    return "other"


def is_copy(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


class Tracer:
    """One profiler window. `enabled` False makes every call a no-op."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled and device.type == "cuda"
        self.device = device
        self.prof = None
        self.state = "idle"   # idle -> open -> closed
        self.window_s = None
        self.summary: Optional[Dict] = None

    def start(self) -> None:
        if not self.enabled or self.state != "idle":
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        self.state = "open"

    def stop(self) -> None:
        if self.state != "open":
            return
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        self.state = "closed"

    @property
    def open(self) -> bool:
        return self.state == "open"

    def reduce(self) -> Dict:
        if self.state != "closed":
            raise RuntimeError("the traced window never closed: the run was too short to reach it")
        if self.summary is None:
            self.summary = reduce_events(self.prof.events(), self.window_s)
        return self.summary


def reduce_events(events, window_s: float) -> Dict:
    """{ops: [(name, start_us, end_us)], busy_s, window_s, kernels: count,
    by_name: {name: seconds}, groups: {group: seconds}, gaps: [(host op,
    seconds)] longest first}."""
    dev, host = [], []
    for e in events:
        kind = str(getattr(e, "device_type", ""))
        tr = e.time_range
        if "CUDA" in kind:
            dev.append((e.name, float(tr.start), float(tr.end)))
        elif "CPU" in kind:
            host.append((e.name, float(tr.start), float(tr.end)))
    if not dev:
        raise RuntimeError("the profiler recorded no CUDA operation in the traced window")
    dev.sort(key=lambda r: r[1])
    busy_us, cur_s, cur_e, gaps = 0.0, None, None, []
    for _, s, e in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name: Dict[str, float] = {}
    groups: Dict[str, float] = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        g = "copy" if is_copy(name) else group(name)
        groups[g] = groups.get(g, 0.0) + (e - s) * 1e-6
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [(_host_at(host, g0), (g1 - g0) * 1e-6) for g0, g1 in gaps[:10]]
    return {
        "ops": dev,
        "busy_s": min(busy_us * 1e-6, window_s),
        "window_s": window_s,
        "kernels": sum(1 for name, _, _ in dev if not is_copy(name)),
        "by_name": by_name,
        "groups": groups,
        "gaps": named,
    }


def _host_at(host: List, t: float) -> str:
    """The innermost host event running at time t (the shortest that
    contains it), or 'python' where none is."""
    best, span = "python", None
    for name, s, e in host:
        if s <= t <= e and (span is None or e - s < span):
            best, span = name, e - s
    return best


def breakdown(summary: Dict) -> Dict:
    """The result line's breakdown: the ten device operations that took the
    most time, and the ten longest idle gaps by what the host was doing."""
    top = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n[:160], s] for n, s in summary["gaps"]]}
