"""Spans of the program's phases, and the operator's trace.

Counterpart of `robustvlm_tpu/utils/profiling.py` (`trace`; JAX's
`TraceAnnotation` becomes `span`):

- `span(name)` names a phase of the program. It records only while a
  `torch.profiler` window is open; otherwise it is one shared no-op context
  (no allocation, no clock read, no CUDA call). Recording, it keeps its
  name, an id, its parent's id and its root's id (the root is the request:
  an attack chunk, a caption group, a training step), the host clock at
  open and close, and on a CUDA device two timing events on the current
  stream (none while a CUDA graph is being captured). It also opens a
  profiler range of function scope, so the span is a CPU event on the
  profiler's timeline, on the kernels' clock, and puts nothing on the
  device's timeline (a `record_function` range would add a CUDA-typed
  user annotation there).
- `spans()` is the log: each span's host and device milliseconds, its self
  times (less its children's) and whether it is `complete` (opened and
  closed inside one profiler window). The events are read there, after one
  synchronize; the hot path never waits on them. The log keeps at most
  `MAX_SPANS` spans and counts the rest in `dropped()`; `reset()` clears it.
- `trace(dir)` records a `torch.profiler` trace (CPU and, on a GPU, CUDA
  activity) of the enclosed region into `dir/trace.json`, the spans among
  its CPU events, and the spans recorded in it into `dir/spans.json`.

Span names in the port: `apgd.attack` > `apgd.iter` > `apgd.forward`,
`apgd.backward`, `apgd.update` (attacks/apgd.py); `train.step` >
`train.frozen_embedding`, `train.inner_attack`, `train.outer`,
`train.optimizer` (train/trainer.py); `ensemble.group` >
`ensemble.attack`, `ensemble.caption`, `ensemble.score`
(vlm_eval/ensemble.py).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 1 << 16

# a range of function scope: a CPU event only (absent from some builds: the
# span then keeps its clocks and opens no range)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_OFF = contextlib.nullcontext()  # stateless, so one instance serves every span while off


class _Log:
    def __init__(self):
        self.ids = itertools.count(1)
        self.closed: List["_Span"] = []
        self.dropped = 0
        self.events: Dict[int, list] = {}  # device index -> free timing events
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def event(self, device: int):
        pool = self.events.setdefault(device, [])
        return pool.pop() if pool else torch.cuda.Event(enable_timing=True)


_LOG = _Log()


def _cuda_device() -> Optional[int]:
    """The current CUDA device where CUDA work can be in flight and no graph
    is being captured, else None."""
    if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
        return None
    return torch.cuda.current_device()


class _Span:
    __slots__ = ("name", "id", "parent", "root", "t0", "t1", "device", "ev0", "ev1", "range",
                 "complete", "device_ms")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _LOG.stack()
        self.id = next(_LOG.ids)
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else None
        self.root = up.root if up is not None else self.id
        stack.append(self)
        self.range = _RANGE(self.name) if _RANGE is not None else None
        if self.range is not None:
            self.range.__enter__()
        self.device = _cuda_device()
        self.ev0 = self.ev1 = self.device_ms = None
        if self.device is not None:
            self.ev0 = _LOG.event(self.device)
            self.ev0.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.ev0 is not None:
            if _cuda_device() == self.device:
                self.ev1 = _LOG.event(self.device)
                self.ev1.record()
            else:  # closed inside a capture or on another device: no device interval
                _LOG.events[self.device].append(self.ev0)
                self.ev0 = None
        if self.range is not None:
            self.range.__exit__(None, None, None)
        self.complete = bool(_autograd_profiler._is_profiler_enabled)
        _LOG.stack().remove(self)
        if len(_LOG.closed) < MAX_SPANS:
            _LOG.closed.append(self)
        else:
            _LOG.dropped += 1
            for ev in (self.ev0, self.ev1):
                if ev is not None:
                    _LOG.events[self.device].append(ev)
        return False


def span(name: str):
    """A context manager naming a phase of the program in the profiler's
    trace and in `spans()`; a shared no-op while no profiler window is open."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def _resolve() -> None:
    """Read the device interval of every closed span whose events are
    pending, after one synchronize a device, and return the events to
    their pools."""
    pending = [s for s in _LOG.closed if s.ev1 is not None]
    for d in {s.device for s in pending}:
        torch.cuda.synchronize(d)
    for s in pending:
        s.device_ms = s.ev0.elapsed_time(s.ev1)
        _LOG.events[s.device].extend((s.ev0, s.ev1))
        s.ev0 = s.ev1 = None


def spans() -> List[dict]:
    """The log, by id: name, id, parent, root, complete, host_ms, device_ms
    (None without a CUDA interval) and the self times, host_self_ms and
    device_self_ms (less the children's)."""
    _resolve()
    out = {}
    for s in sorted(_LOG.closed, key=lambda s: s.id):
        out[s.id] = {"name": s.name, "id": s.id, "parent": s.parent, "root": s.root,
                     "complete": s.complete, "host_ms": (s.t1 - s.t0) * 1e-6, "device_ms": s.device_ms}
    kids: Dict[int, List[dict]] = {}
    for e in out.values():
        if e["parent"] in out:
            kids.setdefault(e["parent"], []).append(e)
    for e in out.values():
        ch = kids.get(e["id"], [])
        e["host_self_ms"] = e["host_ms"] - sum(c["host_ms"] for c in ch)
        e["device_self_ms"] = (None if e["device_ms"] is None else
                               e["device_ms"] - sum(c["device_ms"] or 0.0 for c in ch))
    return list(out.values())


def dropped() -> int:
    """Spans closed while the log was full (not kept)."""
    return _LOG.dropped


def reset() -> None:
    """Clear the log (the spans still open stay open and are logged when they close)."""
    _resolve()
    _LOG.closed.clear()
    _LOG.dropped = 0


@contextlib.contextmanager
def trace(log_dir: str):
    """A profiler window around the enclosed region, written to
    `log_dir/trace.json` and its spans to `log_dir/spans.json`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    first = next(_LOG.ids)  # ids from here on are this window's
    with profile(activities=acts) as prof:
        yield prof
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
    mine = [s for s in spans() if s["id"] > first]
    (Path(log_dir) / "spans.json").write_text(json.dumps({"spans": mine, "dropped": dropped()}))
