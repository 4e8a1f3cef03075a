"""Random weights made on the device from the seed, in a few large calls.

A weight is described by (shape, dtype, init): init is ("normal", std),
("ones",), ("zeros",) or ("fill", value). The normal weights of one dtype
are drawn by one `torch.randn` for each billion elements into a flat
buffer, in the dtype they are served in, and each weight is a view of it,
scaled in place. The same (specs, seed) give the same tensors on the same
device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from harness.traffic import fold, generator

Spec = Tuple[tuple, torch.dtype, tuple]


@torch.no_grad()
def make(specs: Dict[str, Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    by_dtype: Dict[torch.dtype, list] = {}
    for name, (shape, dtype, init) in specs.items():
        if init[0] == "normal":
            by_dtype.setdefault(dtype, []).append(name)
        elif init[0] == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif init[0] == "fill":
            out[name] = torch.full(shape, float(init[1]), dtype=dtype, device=device)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
    draw = 0
    for dtype, names in sorted(by_dtype.items(), key=lambda kv: str(kv[0])):
        for chunk in _chunks(names, specs):
            sizes = [_numel(specs[n][0]) for n in chunk]
            flat = torch.randn(sum(sizes), generator=generator(fold(seed, 1000 + draw), device),
                               device=device, dtype=dtype)
            draw += 1
            for name, part in zip(chunk, torch.split(flat, sizes)):
                shape, _, init = specs[name]
                out[name] = part.view(shape).mul_(init[1])
    return {name: out[name] for name in specs}


def _chunks(names, specs, limit: int = 1 << 30):
    """`names` in order, cut where a chunk would pass `limit` elements."""
    chunk, n = [], 0
    for name in names:
        k = _numel(specs[name][0])
        if chunk and n + k > limit:
            yield chunk
            chunk, n = [], 0
        chunk.append(name)
        n += k
    if chunk:
        yield chunk


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def meta_shapes(module_factory) -> Dict[str, tuple]:
    """{name: shape} of a module's state, built on the meta device."""
    with torch.device("meta"):
        module = module_factory()
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
