"""Non-causal ViT self-attention, forward and backward: CUDA kernels and
their plain versions.

Counterpart of `robustvlm_tpu/ops/pallas/vit_attention.py`. The kernels in
`csrc/attention.cu` replace `_vit_attn_fwd` (`_fwd_kernel`) and
`_vit_attn_bwd` (`_bwd_kernel`); `attention_fwd_plain` and
`attention_bwd_plain` compute the same functions in PyTorch:

- forward: q scaled in its own dtype before Q K^T, float32 scores and
  softmax, P cast to v's dtype before P V, float32 sums; returns O and
  lse = m + log l (float32);
- backward: P = exp(S - lse) from the saved (q, k, v, o, lse),
  delta = rowsum(dO * O), dS = P (dP - delta) scale cast to q's dtype,
  then dQ = dS K, dK = dS^T Q, dV = P^T dO.

`vit_attention` is differentiable in (q, k, v), `vit_attention_qkv` in a
fused (B, N, 3W) q|k|v projection, each through one `torch.autograd.Function`
(`_heads.py`). The bf16 kernels read the heads through their strides and
write O token-major, so neither form copies heads apart or back together
(`_heads.py` says how). CPU tensors take the plain versions; CUDA tensors
launch the kernels or raise. The JAX package leaves its kernel off by
default (`use_flash_default()`); the port launches its kernels for every
CUDA tensor. These are the flash kernels with causal off and no slopes,
launched through `flash_attention`'s CUDA front with the ViT's own tile
shapes (`VIT`).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from robustvlm_tpu_torch.ops.kernels import _heads, flash_attention

# launches of the CUDA kernels (not of the plain versions); one backward
# launch is the dQ kernel followed by the dK/dV kernel. `_copied` counts the
# launches for which the wrapper copied an operand the kernels cannot take as
# it lies (`_heads.layout_problem`: float32, or strides the bf16 kernels do
# not take); 0 on the bf16 main path.
LAUNCHES = {"vit_attention_fwd": 0, "vit_attention_bwd": 0, "vit_attention_copied": 0}

HEAD_DIMS = (64, 80, 88)  # head dims the CUDA kernels are built for (CLIP ViT towers)
# the ViT table set of csrc/attention.cu's C interface
VIT = flash_attention.Entry("vit_attention", 1, HEAD_DIMS, LAUNCHES)


# ------------------------------------------------------------- plain versions
def attention_fwd_plain(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, N, D) x3 -> O (BH, N, D) in q's dtype, lse (BH, N) float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def attention_bwd_plain(q, k, v, o, lse, do):
    """dQ, dK, dV from the forward's residuals and dO, all (BH, N, D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_fwd(q, k, v, o=None):
    """Forward on (B, H, N, D) or (B*H, N, D): the plain version for CPU
    tensors (on contiguous (B*H, N, D) copies), the kernel for CUDA tensors.
    Returns (O, lse); O written into o when given."""
    if q.device.type != "cpu":
        return flash_attention.flash_fwd_cuda(q, k, v, o, entry=VIT)
    out, lse = attention_fwd_plain(*map(_heads.flat, (q, k, v)))
    out = out.view(q.shape)
    return (out if o is None else o.copy_(out)), lse


def attention_bwd(q, k, v, o, lse, do, grads=None):
    """dQ, dK, dV, as attention_fwd; written into grads when given."""
    if q.device.type != "cpu":
        return flash_attention.flash_bwd_cuda(q, k, v, o, lse, do, grads, entry=VIT)
    got = attention_bwd_plain(*map(_heads.flat, (q, k, v, o)), lse, _heads.flat(do))
    got = [g.view(t.shape) for g, t in zip(got, (q, k, v))]
    return tuple(got) if grads is None else tuple(d.copy_(g) for d, g in zip(grads, got))


_OPS = (attention_fwd, attention_bwd)


def _check_device(t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vit_attention: unsupported device {t.device}")


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact non-causal self-attention over (B, H, N, D) -> (B, H, N, D),
    differentiable in (q, k, v). Views of the heads are taken as they lie;
    O comes back as a view of a token-major (B, N, H, D) array in bf16, so
    `o.transpose(1, 2).reshape(b, n, h * d)` is free."""
    _check_device(q)
    return _heads.Attention.apply(q, k, v, _OPS)


def vit_attention_qkv(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """`vit_attention` over a fused (B, N, 3W) projection [q | k | v] of
    `heads` heads -> (B, N, W), the heads merged; differentiable in qkv. In
    bf16 the kernels read the heads out of qkv and write dQ, dK and dV into
    one (B, N, 3W) gradient: no split, merge or `cat` copies."""
    _check_device(qkv)
    return _heads.PackedAttention.apply(qkv, heads, _OPS)
