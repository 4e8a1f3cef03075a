"""Head layouts of the attention kernels, and the autograd Functions that
hand them views in place of copies.

The bf16 kernels (`csrc/attn_bf16_fwd.cuh`, `csrc/attn_bf16_bwd.cuh`)
address every (B, H, N, D) operand through its strides: a head's view into a
fused (B, N, 3W) q|k|v projection, or into a token-major (B, N, H, D) array,
costs nothing to pass. They write O, dQ, dK and dV where their strides say,
so O is allocated token-major (the caller's merge of the heads is then a
view) and the gradient of a fused projection is one (B, N, 3W) tensor whose
column blocks the backward fills. The float32 kernels take contiguous
operands only: the wrappers copy for them, as for any view the bf16 kernels
cannot take (`layout_problem`), and count such calls.

`Attention` and `PackedAttention` take the module's (fwd, bwd) pair:
fwd(q, k, v, o=None) -> (o, lse), bwd(q, k, v, o, lse, do, grads=None) ->
(dq, dk, dv), writing into o and grads when given. Both run on the CPU too,
through the plain versions, which see the same contiguous (B*H, N, D)
operands as before the kernels took views: the same bits.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch


def layout_problem(t: torch.Tensor) -> Optional[str]:
    """Why the kernels cannot take t, a (..., N, D) operand, as it lies, or
    None. bf16: the head dim contiguous, every other stride whole 16 bytes
    (TMA's rule); float32: contiguous. Both: a 16-byte aligned base."""
    if t.dtype == torch.float32:
        if not t.is_contiguous():
            return "the float32 kernels take contiguous tensors"
    elif t.stride(-1) != 1:
        return "the bf16 kernels take views whose head dim is contiguous (last stride 1)"
    elif any(s * t.element_size() % 16 for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1):
        return "the bf16 kernels take strides of whole 16 bytes (multiples of 8 elements)"
    if t.data_ptr() % 16:
        return "the kernels take 16-byte aligned tensors"
    return None


def launchable(ts: Sequence[torch.Tensor]) -> Tuple[list, bool]:
    """ts, each replaced by a contiguous copy where the kernels cannot take
    it, and whether any was."""
    out = [t if layout_problem(t) is None else t.clone(memory_format=torch.contiguous_format)
           for t in ts]
    return out, any(a is not b for a, b in zip(out, ts))


def outputs(outs: Sequence[Optional[torch.Tensor]], likes: Sequence[torch.Tensor]) -> list:
    """The arrays a kernel writes: each given output where the kernel can
    write it as it lies, else a fresh one (`finish` copies it over)."""
    return [empty_out(like) if o is None or layout_problem(o) else o for o, like in zip(outs, likes)]


def finish(outs, dsts, copied: bool, counters: dict, key: str) -> list:
    """The outputs after a launch into dsts: fresh arrays where outs gave
    none, else outs, copied into where the kernel could not write them; a
    copy either way counts once in counters[key]."""
    for o, d in zip(outs, dsts):
        if o is not None and o is not d:
            o.copy_(d)
            copied = True
    counters[key] += copied
    return [d if o is None else o for o, d in zip(outs, dsts)]


def bhnd(t: torch.Tensor) -> torch.Tensor:
    """A (B*H, N, D) array as (B*H, 1, N, D); a (B, H, N, D) view as it is."""
    return t if t.dim() == 4 else t.unsqueeze(1)


def empty_out(like: torch.Tensor) -> torch.Tensor:
    """An output of like's shape: token-major (a (B, H, N, D) view of (B,
    N, H, D)) for a bf16 (B, H, N, D) operand, contiguous otherwise."""
    if like.dim() == 4 and like.dtype != torch.float32:
        b, h, n, d = like.shape
        return torch.empty((b, n, h, d), dtype=like.dtype, device=like.device).transpose(1, 2)
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


def _bhn(t: torch.Tensor) -> list:
    """t's element strides (batch, head, row), a dimension of size 1 given
    the stride a contiguous array would have there (any stride addresses
    its one index; this one is what TMA and the float32 kernels take)."""
    t = bhnd(t)
    st = list(t.stride())
    for i in (2, 1, 0):
        if t.shape[i] == 1:
            st[i] = st[i + 1] * t.shape[i + 1]
    return st[:3]


def strides(ts: Sequence[torch.Tensor]):
    """The element strides (batch, head, row) of each (B, H, N, D) operand,
    in turn, as the C interface's long long array."""
    flat = [s for t in ts for s in _bhn(t)]
    return (ctypes.c_longlong * len(flat))(*flat)


def flat(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) -> contiguous (B*H, N, D): what the plain versions take."""
    return t.reshape(-1, *t.shape[-2:]).contiguous()


def heads_of(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, W) -> its (B, H, N, W / H) view (a copy only where x's strides
    allow none)."""
    b, n, w = x.shape
    return x.reshape(b, n, heads, w // heads).transpose(1, 2)


def qkv_views(qkv: torch.Tensor, heads: int):
    """(B, N, 3W) fused projection [q | k | v] -> three (B, H, N, W / H)
    views of it."""
    w = qkv.shape[-1] // 3
    return tuple(heads_of(qkv[..., i * w:(i + 1) * w], heads) for i in range(3))


class Attention(torch.autograd.Function):
    """(B, H, N, D) q, k, v (views welcome) -> O, (B, H, N, D), token-major
    on bf16 kernels; differentiable in q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, ops):
        o, lse = ops[0](q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ops = ops
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*ctx.ops[1](q, k, v, o, lse, do.to(q.dtype)), None)


class PackedAttention(torch.autograd.Function):
    """Self-attention over a fused (B, N, 3W) q|k|v projection -> (B, N, W),
    the heads merged; differentiable in the projection, whose gradient is
    one (B, N, 3W) tensor that the backward writes block by block."""

    @staticmethod
    def forward(ctx, qkv, heads, ops):
        b, n, w3 = qkv.shape
        out = qkv.new_empty((b, n, w3 // 3))
        _, lse = ops[0](*qkv_views(qkv, heads), heads_of(out, heads))
        ctx.save_for_backward(qkv, out, lse)
        ctx.heads, ctx.ops = heads, ops
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        h = ctx.heads
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        ctx.ops[1](*qkv_views(qkv, h), heads_of(out, h), lse, heads_of(dout.to(qkv.dtype), h),
                   qkv_views(dqkv, h))
        return dqkv, None, None
