"""Non-causal ViT self-attention, forward and backward: CUDA kernels and
their plain versions.

Counterpart of `robustvlm_tpu/ops/pallas/vit_attention.py`. The kernels in
`csrc/vit_attention.cu` replace `_vit_attn_fwd` (`_fwd_kernel`) and
`_vit_attn_bwd` (`_bwd_kernel`); `attention_fwd_plain` and
`attention_bwd_plain` compute the same functions in PyTorch:

- forward: q scaled in its own dtype before Q K^T, float32 scores and
  softmax, P cast to v's dtype before P V, float32 sums; returns O and
  lse = m + log l (float32);
- backward: P = exp(S - lse) from the saved (q, k, v, o, lse),
  delta = rowsum(dO * O), dS = P (dP - delta) scale cast to q's dtype,
  then dQ = dS K, dK = dS^T Q, dV = P^T dO.

`vit_attention` is differentiable in (q, k, v) through one
`torch.autograd.Function`. CPU tensors take the plain versions; CUDA
tensors launch the kernels or raise. The JAX package leaves its kernel off
by default (`use_flash_default()`); the port launches its kernels for every
CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from robustvlm_tpu_torch.ops.kernels import _build

# launches of the CUDA kernels (not of the plain versions); one backward
# launch is the dQ kernel followed by the dK/dV kernel
LAUNCHES = {"vit_attention_fwd": 0, "vit_attention_bwd": 0}

HEAD_DIMS = (64, 80)  # head dims the CUDA kernels are built for (CLIP ViT towers)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


# ----------------------------------------------------------------- CUDA path
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("vit_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from vit_attention.cu."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vit_attn_fwd.argtypes = [p, p, p, p, p, i, i, i, i, f, p]
    lib.vit_attn_fwd.restype = ctypes.c_int
    lib.vit_attn_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, f, p]
    lib.vit_attn_bwd.restype = ctypes.c_int
    return lib


def _check_cuda(*ts: torch.Tensor) -> None:
    ref = ts[0]
    if ref.dtype not in _DTYPES:
        raise TypeError(f"vit_attention: the kernel takes float32 or bfloat16, got {ref.dtype}")
    if ref.dim() != 3:
        raise ValueError(f"vit_attention: expected (B*H, N, D), got {tuple(ref.shape)}")
    if ref.shape[-1] not in HEAD_DIMS:
        raise ValueError(
            f"vit_attention: head dim {ref.shape[-1]} not built; kernels cover {HEAD_DIMS}"
        )
    for t in ts:
        if t.device != ref.device or t.dtype != ref.dtype or t.shape != ref.shape:
            raise ValueError("vit_attention: q, k, v (and o, dO) must share device, dtype and shape")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("vit_attention: the kernel takes contiguous, 16-byte aligned tensors")


def attention_fwd_cuda(q, k, v):
    _check_cuda(q, k, v)
    bh, n, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vit_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            bh, n, d, _DTYPES[q.dtype], 1.0 / math.sqrt(d), stream,
        )
    _build.check_launch(err, "vit_attention forward")
    LAUNCHES["vit_attention_fwd"] += 1
    return o, lse


def attention_bwd_cuda(q, k, v, o, lse, do):
    _check_cuda(q, k, v, o, do)
    bh, n, d = q.shape
    if lse.shape != (bh, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("vit_attention backward: lse must be contiguous float32 (B*H, N)")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vit_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            delta.data_ptr(), bh, n, d, _DTYPES[q.dtype], 1.0 / math.sqrt(d), stream,
        )
    _build.check_launch(err, "vit_attention backward")
    LAUNCHES["vit_attention_bwd"] += 1
    return dq, dk, dv


def attention_fwd(q, k, v):
    """Forward on (BH, N, D): the plain version for CPU tensors, the kernel
    for CUDA tensors."""
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v)
    return attention_fwd_cuda(q, k, v)


def attention_bwd(q, k, v, o, lse, do):
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do)
    return attention_bwd_cuda(q, k, v, o, lse, do)


class _VitAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return attention_bwd(q, k, v, o, lse, do.to(q.dtype).contiguous())


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact non-causal self-attention over (B, H, N, D) -> (B, H, N, D),
    differentiable in (q, k, v)."""
    b, h, n, d = q.shape
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vit_attention: unsupported device {q.device}")
    flat = [t.reshape(b * h, n, d).contiguous() for t in (q, k, v)]
    return _VitAttention.apply(*flat).reshape(b, h, n, d)
