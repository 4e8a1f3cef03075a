"""A wrapper around the model function an attack calls.

It counts the calls of the current unit, opens and closes the tracer at
the traffic file's chosen calls of the window's first unit, and keeps the
latest call that takes a pixel gradient: its input, its output and the
gradient that reaches the input (through an identity node on the input,
whose backward keeps what passes). The attack sees the same values, and
every other attribute is the wrapped object's (an eval-model adapter).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


class _Tap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, box):
        ctx.box = box
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.box["grad"] = g
        return g, None


class Probe:
    def __init__(self, fn: Callable, tracer, first_call: int, n_calls: int):
        self.fn = fn
        self.tracer = tracer
        self.first_call = first_call
        self.n_calls = n_calls
        self.unit: Optional[int] = None
        self.calls = 0
        self.traced_calls = 0
        self.last: dict = {}

    def begin_unit(self, unit: int) -> None:
        self.unit = unit
        self.calls = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.unit == 0:
            if self.calls == self.first_call:
                self.tracer.start()
            elif self.calls == self.first_call + self.n_calls:
                self.tracer.stop()
            if self.tracer.open:
                self.traced_calls += 1
        self.calls += 1
        if not x.requires_grad:
            return self.fn(x)
        box = {"x": x.detach()}
        out = self.fn(_Tap.apply(x, box))
        box["out"] = out.detach()
        self.last = box
        return out

    def __getattr__(self, name):
        # everything else of the wrapped adapter (set_inputs, get_outputs, ...)
        fn = self.__dict__.get("fn")
        if fn is None:
            raise AttributeError(name)
        return getattr(fn, name)

    def close(self) -> None:
        """Close a window the unit ended inside of."""
        self.tracer.stop()
