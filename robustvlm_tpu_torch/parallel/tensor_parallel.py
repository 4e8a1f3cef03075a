"""Megatron tensor parallelism over the mesh's `model` axis.

The compute split that JAX's rules ask of XLA (`robustvlm_tpu/parallel/
mesh.py`: head and ffn columns on `model`, the out and down projections'
rows on `model`), written out: a block whose parameters `shard_params`
splits holds this rank's heads and ffn columns and computes on them.

- `TensorParallel` is what a split module carries in its `tp` attribute
  (None on a whole module): the `model` group, its size and this rank's
  index on it.
- The products and collectives are Megatron's regions on the `model` group,
  each rounding to the activation dtype once where the unsplit product
  rounds, so that a bf16 split model differs from the unsplit one only by
  the order of float32 sums:
  * `column_parallel(x, w, tp)`: x @ w on this rank's columns of w; its
    backward sums every rank's partial gradient of x in float32 (Megatron's
    identity-forward, all-reduce-backward region on the product's input),
    so the gradient that reaches the replicated activations (the pixels, in
    the end) is the sum over every rank's heads;
  * `row_parallel(x, w, tp)`: x @ w on this rank's rows of w, each partial
    kept in float32 (a bf16 product on the card accumulates and writes
    float32: `torch.mm(..., out_dtype=torch.float32)`), summed over `model`
    and rounded once, before the product's replicated bias, which is then
    added once;
  * `gather_from_model` (all-gather of the last dim forward, this rank's
    slice backward) for the LM head's vocabulary-split logits, so the argmax
    and the cross-entropy see the whole vocabulary;
  * `split_to_model` (this rank's slice forward, all-gather backward) for a
    replicated bias read on split columns.
- `head_columns` is the map from a rank to the columns of a fused [q|k|v]
  matrix that hold its heads: `[r*W/m, (r+1)*W/m)` of each of q, k and v.
  The parameter is a DTensor with `_StridedShard(dim, split_factor=3)` on
  `model`: that placement's global view is the unsplit [q|k|v] layout.
- `local(p)` is the tensor a forward multiplies by: a DTensor's local shard
  (differentiable: its gradient lands on the DTensor), any other tensor or
  quantized leaf as it is.
- `full_value(t)` is a DTensor's unsplit global value as a plain tensor
  (gathered with a manual reorder where the placement is strided, which not
  every torch version can redistribute); any other value as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The `model` group of a split module: `size` ranks, this one `rank`."""

    group: Any
    size: int
    rank: int


def _all_reduce_f32(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=tp.group)
    return y.to(x.dtype)


def _all_gather_last(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x, group=tp.group)
    return torch.cat(parts, dim=-1)


def _slice_last(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    n = x.shape[-1] // tp.size
    return x[..., tp.rank * n:(tp.rank + 1) * n].contiguous()


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) with a float32 result: a bf16/fp16 product on
    the card writes its float32 accumulator, elsewhere the product is cast."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = (x2 @ w).float()
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).transpose(0, 1) @ g.reshape(-1, g.shape[-1])


class _ColumnParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, tp):
        ctx.save_for_backward(x, w)
        ctx.tp = tp
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _all_reduce_f32(_mm_f32(g, w.transpose(0, 1)), ctx.tp).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = _weight_grad(x, g)
        return gx, gw, None


class _RowParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, tp):
        ctx.save_for_backward(x, w)
        return _all_reduce_f32(_mm_f32(x, w), tp).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g @ w.transpose(0, 1) if ctx.needs_input_grad[0] else None
        gw = _weight_grad(x, g) if ctx.needs_input_grad[1] else None
        return gx, gw, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_gather_last(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _slice_last(g, ctx.tp), None


class _SplitToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _slice_last(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, ctx.tp), None


def column_parallel(x: torch.Tensor, w: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """x @ w on this rank's columns of w; x's gradient summed over `model`."""
    return _ColumnParallel.apply(x, w, tp)


def row_parallel(x: torch.Tensor, w: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum over `model` of x @ w (this rank's rows of w), in x's dtype."""
    return _RowParallel.apply(x, w, tp)


def gather_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _GatherFromModel.apply(x, tp)


def split_to_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _SplitToModel.apply(x, tp)


def local(p):
    """The local shard of a DTensor (differentiable), anything else as is."""
    from torch.distributed.tensor import DTensor

    return p.to_local() if isinstance(p, DTensor) else p


def head_columns(width: int, size: int, rank: int, parts: int = 3) -> torch.Tensor:
    """Indices of rank `rank`'s columns of a fused matrix of `parts` blocks
    of `width` columns each ([q|k|v]): its 1/size of every block."""
    n = width // size
    return torch.cat([torch.arange(i * width + rank * n, i * width + (rank + 1) * n)
                      for i in range(parts)])


def full_value(t):
    """A DTensor's global value as a plain tensor (collective over its
    mesh); anything else as is. A `_StridedShard` placement is gathered as
    the plain `Shard` of the same dim and its blocks put back in order."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    if not isinstance(t, DTensor):
        return t
    strided = [(i, p) for i, p in enumerate(t.placements) if isinstance(p, _StridedShard)]
    if not strided:
        return t.full_tensor()
    (i, sp), = strided
    placements = list(t.placements)
    placements[i] = Shard(sp.dim)
    flat = DTensor.from_local(t.to_local(), t.device_mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride()).full_tensor()
    # the Shard view reads [block 0 | ... | block sf-1] per rank, ranks in
    # order; the global view is each block's ranks in order
    m, sf, d = t.device_mesh.size(i), sp.split_factor, sp.dim
    shape = flat.shape
    n = shape[d] // (m * sf)
    y = flat.reshape(*shape[:d], m, sf, n, *shape[d + 1:]).transpose(d, d + 1)
    return y.reshape(shape).contiguous()
