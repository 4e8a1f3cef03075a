"""Flash attention (causal or not, optional ALiBi), forward and backward:
CUDA kernels and their plain versions.

Counterpart of `robustvlm_tpu/ops/pallas/flash_attention.py`. The kernels in
`csrc/flash_attention.cu` replace `_flash_fwd` (`_fwd_kernel`) and the two
pallas_calls of `_flash_bwd` (`_bwd_dq_kernel`, `_bwd_dkv_kernel`);
`flash_fwd_plain` and `flash_bwd_plain` compute the same functions in
PyTorch:

- forward: q scaled in its own dtype before Q K^T, float32 scores; ALiBi
  subtracts slope * (row - col); masked scores (causal: col > row + nk - nq)
  are -1e30 before the row max and take P = 0; P cast to v's dtype before
  P V; a row with no visible key gives O = 0 and lse = -1e30 (l = 0
  guarded); lse = m + log l in float32;
- backward: S = Q K^T in float32 times scale (q not pre-scaled), P =
  exp(S - lse) and 0 where masked, delta = rowsum(dO * O) in float32, dS =
  P (dP - delta) scale, cast to k's dtype for dQ and q's for dK; P cast to
  dO's dtype for dV.

Causal attention with nq != nk (queries at the end of a longer key
sequence) stays on the kernels: they take the diagonal offset nk - nq,
where the JAX function sends that case to its reference.

`flash_attention` is differentiable in (q, k, v) through one
`torch.autograd.Function`; ALiBi slopes get no gradient. CPU tensors take
the plain versions; CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from robustvlm_tpu_torch.ops.kernels import _build

# launches of the CUDA kernels (not of the plain versions); one backward
# launch is the dQ kernel followed by the dK/dV kernel
LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}

HEAD_DIMS = (64, 128)  # CLIP text towers and LLaMA-7B
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30


# ------------------------------------------------------------- plain versions
def _visible(nq: int, nk: int, causal: bool, device) -> Optional[torch.Tensor]:
    """(nq, nk) bool: key j visible from query i, or None for all."""
    if not causal:
        return None
    i = torch.arange(nq, device=device)[:, None]
    j = torch.arange(nk, device=device)[None, :]
    return j <= i + (nk - nq)


def _scores_bias(s: torch.Tensor, slopes: Optional[torch.Tensor]) -> torch.Tensor:
    """s - slope * (i - j) per (BH, nq, nk) head; raw query index i."""
    if slopes is None:
        return s
    nq, nk = s.shape[-2:]
    i = torch.arange(nq, device=s.device)[:, None]
    j = torch.arange(nk, device=s.device)[None, :]
    return s - slopes.float()[:, None, None] * (i - j).float()


def flash_fwd_plain(q, k, v, *, causal: bool = False,
                    slopes: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (BH, Nq, D), k/v (BH, Nk, D), slopes (BH,) or None -> O (BH, Nq, D)
    in q's dtype, lse (BH, Nq) float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    s = _scores_bias(torch.matmul(qs.float(), k.float().transpose(-1, -2)), slopes)
    vis = _visible(q.shape[1], k.shape[1], causal, q.device)
    if vis is not None:
        s = torch.where(vis, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if vis is not None:
        p = torch.where(vis, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def flash_bwd_plain(q, k, v, o, lse, do, *, causal: bool = False,
                    slopes: Optional[torch.Tensor] = None):
    """dQ (as q), dK, dV (as k, v) from the forward's residuals and dO."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores_bias(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, slopes)
    p = torch.exp(s - lse.unsqueeze(-1))
    vis = _visible(q.shape[1], k.shape[1], causal, q.device)
    if vis is not None:
        p = torch.where(vis, p, 0.0)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------- CUDA path
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("flash_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from flash_attention.cu."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attn_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, f, p]
    lib.flash_attn_fwd.restype = ctypes.c_int
    lib.flash_attn_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p]
    lib.flash_attn_bwd.restype = ctypes.c_int
    return lib


def _check_cuda(q, k, v, *q_like, slopes=None) -> None:
    """Raise on what the kernels do not take. `q_like` are the tensors of
    q's shape (o, dO)."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: the kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"flash_attention: expected (B*H, N, D), got {tuple(q.shape)}, {tuple(k.shape)}")
    bh, nq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not built; kernels cover {HEAD_DIMS}")
    if nq == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention: empty sequence")
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    for t, shape in [(t, q.shape) for t in (q, *q_like)] + [(k, k.shape), (v, k.shape)]:
        if t.device != q.device or t.dtype != q.dtype or t.shape != shape:
            raise ValueError("flash_attention: q, k, v (and o, dO) must share device and dtype, "
                             "k and v one shape")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention: the kernel takes contiguous, 16-byte aligned tensors")
    if slopes is not None and (slopes.shape != (bh,) or slopes.dtype != torch.float32
                               or slopes.device != q.device or not slopes.is_contiguous()):
        raise ValueError("flash_attention: ALiBi slopes must be contiguous float32 (B*H,) on q's device")


def _dims(q, k, causal: bool):
    """(bh, nq, nk, d, dtype, causal, q_off, scale) of the C interface."""
    bh, nq, d = q.shape
    nk = k.shape[1]
    return (bh, nq, nk, d, _DTYPES[q.dtype], int(causal), nk - nq if causal else 0,
            1.0 / math.sqrt(d))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_fwd_cuda(q, k, v, *, causal: bool = False, slopes=None):
    _check_cuda(q, k, v, slopes=slopes)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            _ptr(slopes), *_dims(q, k, causal), stream,
        )
    _build.check_launch(err, "flash_attention forward")
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def flash_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = False, slopes=None):
    _check_cuda(q, k, v, o, do, slopes=slopes)
    if lse.shape != q.shape[:2] or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention backward: lse must be contiguous float32 (B*H, Nq)")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), _ptr(slopes), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            delta.data_ptr(), *_dims(q, k, causal), stream,
        )
    _build.check_launch(err, "flash_attention backward")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def flash_fwd(q, k, v, *, causal: bool = False, slopes=None):
    """Forward on (BH, N, D): the plain version for CPU tensors, the kernel
    for CUDA tensors."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, slopes=slopes)
    return flash_fwd_cuda(q, k, v, causal=causal, slopes=slopes)


def flash_bwd(q, k, v, o, lse, do, *, causal: bool = False, slopes=None):
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal=causal, slopes=slopes)
    return flash_bwd_cuda(q, k, v, o, lse, do, causal=causal, slopes=slopes)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, slopes, causal):
        o, lse = flash_fwd(q, k, v, causal=causal, slopes=slopes)
        ctx.save_for_backward(q, k, v, o, lse, slopes)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, slopes = ctx.saved_tensors
        grads = flash_bwd(q, k, v, o, lse, do.to(q.dtype).contiguous(),
                          causal=ctx.causal, slopes=slopes)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over (B, H, Nq, D) x (B, H, Nk, D) -> (B, H, Nq, D),
    differentiable in (q, k, v). `alibi_slopes` (H,) adds the bias
    -slope * (i - j); causal masks key j > i + Nk - Nq."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    qf = q.reshape(b * h, nq, d).contiguous()
    kf, vf = (t.reshape(b * h, nk, d).contiguous() for t in (k, v))
    slopes = None
    if alibi_slopes is not None:  # per head, tiled over the batch
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).repeat(b).contiguous()
    return _FlashAttention.apply(qf, kf, vf, slopes, causal).reshape(b, h, nq, d)
