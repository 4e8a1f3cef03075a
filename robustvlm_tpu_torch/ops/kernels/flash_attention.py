"""Flash attention (causal or not, optional ALiBi), forward and backward:
CUDA kernels and their plain versions.

Counterpart of `robustvlm_tpu/ops/pallas/flash_attention.py`. The kernels in
`csrc/attention.cu` replace `_flash_fwd` (`_fwd_kernel`) and the two
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

`flash_attention` is differentiable in (q, k, v), `flash_attention_qkv` in
a fused (B, N, 3W) q|k|v projection, each through one
`torch.autograd.Function` (`_heads.py`); ALiBi slopes get no gradient. The
bf16 kernels read the heads through their strides and write O token-major,
so neither form copies heads apart or back together. CPU tensors take the
plain versions; CUDA tensors launch the kernels or raise.

The CUDA front here (`flash_fwd_cuda`, `flash_bwd_cuda`) is also
`vit_attention`'s: one library, one C interface, whose table set (the tile
shapes tuned for each JAX function's traffic) and head dims, error prefix
and launch counters come from the calling module's `Entry`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from robustvlm_tpu_torch.ops.kernels import _build, _heads

# launches of the CUDA kernels (not of the plain versions); one backward
# launch is the dQ kernel followed by the dK/dV kernel. The `_alibi` counts
# are the launches of them with ALiBi slopes (MPT), among the others;
# `_copied` those for which the wrapper copied an operand the kernels cannot
# take as it lies (`_heads.layout_problem`), 0 on the bf16 main path.
LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
            "flash_attention_fwd_alibi": 0, "flash_attention_bwd_alibi": 0,
            "flash_attention_copied": 0}

HEAD_DIMS = (64, 80, 128)  # CLIP text towers, OPT-2.7B (BLIP-2) and LLaMA-7B
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30


class Entry(NamedTuple):
    """A public function over `csrc/attention.cu`: its name prefixes its
    errors and its launch counters' keys; `tables` selects its tile shapes
    in the C interface (0 = flash, 1 = ViT), built at `head_dims`."""

    name: str
    tables: int
    head_dims: Tuple[int, ...]
    launches: Dict[str, int]


FLASH = Entry("flash_attention", 0, HEAD_DIMS, LAUNCHES)


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
    return bind(_build.load("attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from attention.cu."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    st = ctypes.POINTER(ctypes.c_longlong)
    lib.attn_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, i, st, p]
    lib.attn_fwd.restype = ctypes.c_int
    lib.attn_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, i, st, p]
    lib.attn_bwd.restype = ctypes.c_int
    return lib


def _check_cuda(q, k, v, *q_like, slopes=None, entry: Entry = FLASH) -> None:
    """Raise on what entry's kernels do not take. `q_like` are the tensors
    of q's shape (o, dO, dQ); (B, H, N, D) views or (B*H, N, D) arrays, laid
    out as `_heads.layout_problem` allows."""
    name = entry.name
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() not in (3, 4) or k.dim() != q.dim():
        raise ValueError(f"{name}: expected (B, H, N, D) or (B*H, N, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    nq, d = q.shape[-2:]
    if d not in entry.head_dims:
        raise ValueError(f"{name}: head dim {d} not built; kernels cover {entry.head_dims}")
    if nq == 0 or k.shape[-2] == 0:
        raise ValueError(f"{name}: empty sequence")
    if k.shape[:-2] != q.shape[:-2] or k.shape[-1] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    for t, shape in [(t, q.shape) for t in (q, *q_like)] + [(t, k.shape) for t in (k, v)]:
        if t.device != q.device or t.dtype != q.dtype or t.shape != shape:
            raise ValueError(f"{name}: q, k, v (and o, dO) must share device and dtype, "
                             "k and v one shape")
        problem = _heads.layout_problem(t)
        if problem:
            raise ValueError(f"{name}: {problem}")
    bh = q.shape[:-2].numel()
    if slopes is not None and (slopes.shape != (bh,) or slopes.dtype != torch.float32
                               or slopes.device != q.device or not slopes.is_contiguous()):
        raise ValueError(f"{name}: ALiBi slopes must be contiguous float32 (B*H,) on q's device")


def _dims(q, k, causal: bool, tables: int):
    """(batch, heads, nq, nk, d, dtype, causal, q_off, scale, tables) of the C interface."""
    b, h, nq, d = _heads.bhnd(q).shape
    nk = k.shape[-2]
    return (b, h, nq, nk, d, _DTYPES[q.dtype], int(causal), nk - nq if causal else 0,
            1.0 / math.sqrt(d), tables)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _count(entry: Entry, kind: str, slopes) -> None:
    entry.launches[f"{entry.name}_{kind}"] += 1
    if slopes is not None:
        entry.launches[f"{entry.name}_{kind}_alibi"] += 1


def flash_fwd_cuda(q, k, v, o=None, *, causal: bool = False, slopes=None, entry: Entry = FLASH):
    """O and lse by entry's kernel. q (B, H, Nq, D), k and v (B, H, Nk, D):
    views, or (B*H, N, D) arrays; O written into o, or into a new array
    (token-major in bf16); lse (B*H, Nq) float32."""
    (q, k, v), copied = _heads.launchable((q, k, v))
    (dst,) = _heads.outputs([o], [q])
    _check_cuda(q, k, v, dst, slopes=slopes, entry=entry)
    lse = torch.empty((q.shape[:-2].numel(), q.shape[-2]), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dst.data_ptr(), lse.data_ptr(),
            _ptr(slopes), *_dims(q, k, causal, entry.tables), _heads.strides((q, k, v, dst)), stream,
        )
    _build.check_launch(err, f"{entry.name} forward")
    _count(entry, "fwd", slopes)
    return _heads.finish([o], [dst], copied, entry.launches, f"{entry.name}_copied")[0], lse


def flash_bwd_cuda(q, k, v, o, lse, do, grads=None, *, causal: bool = False, slopes=None,
                   entry: Entry = FLASH):
    """dQ (as q), dK, dV (as k, v) by entry's kernels; written into grads
    (three outputs) when given."""
    (q, k, v, o, do), copied = _heads.launchable((q, k, v, o, do))
    outs = list(grads) if grads is not None else [None] * 3
    dsts = _heads.outputs(outs, (q, k, v))
    dq, dk, dv = dsts
    _check_cuda(q, k, v, o, do, dq, slopes=slopes, entry=entry)
    _check_cuda(q, dk, dv, entry=entry)
    if (lse.shape != (q.shape[:-2].numel(), q.shape[-2]) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"{entry.name} backward: lse must be contiguous float32 (B*H, Nq)")
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), _ptr(slopes), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            delta.data_ptr(), *_dims(q, k, causal, entry.tables),
            _heads.strides((q, k, v, o, do, dq, dk, dv)), stream,
        )
    _build.check_launch(err, f"{entry.name} backward")
    _count(entry, "bwd", slopes)
    return tuple(_heads.finish(outs, dsts, copied, entry.launches, f"{entry.name}_copied"))


def flash_fwd(q, k, v, o=None, *, causal: bool = False, slopes=None):
    """Forward on (B, H, N, D) or (B*H, N, D): the plain version for CPU
    tensors (on contiguous (B*H, N, D) copies), the kernel for CUDA tensors.
    Returns (O, lse); O written into o when given."""
    if q.device.type != "cpu":
        return flash_fwd_cuda(q, k, v, o, causal=causal, slopes=slopes)
    out, lse = flash_fwd_plain(*map(_heads.flat, (q, k, v)), causal=causal, slopes=slopes)
    out = out.view(q.shape)
    return (out if o is None else o.copy_(out)), lse


def flash_bwd(q, k, v, o, lse, do, grads=None, *, causal: bool = False, slopes=None):
    """dQ, dK, dV, as flash_fwd; written into grads when given."""
    if q.device.type != "cpu":
        return flash_bwd_cuda(q, k, v, o, lse, do, grads, causal=causal, slopes=slopes)
    got = flash_bwd_plain(*map(_heads.flat, (q, k, v, o)), lse, _heads.flat(do),
                          causal=causal, slopes=slopes)
    got = [g.view(t.shape) for g, t in zip(got, (q, k, v))]
    return tuple(got) if grads is None else tuple(d.copy_(g) for d, g in zip(grads, got))


def _ops(b: int, h: int, device, causal: bool, alibi_slopes: Optional[torch.Tensor]):
    """The (fwd, bwd) pair of `_heads`' Functions, with the mask and the
    slopes (per head, tiled over the batch) bound."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {device}")
    slopes = None
    if alibi_slopes is not None:
        if alibi_slopes.numel() != h:
            raise ValueError(f"flash_attention: {alibi_slopes.numel()} alibi_slopes for {h} heads")
        slopes = alibi_slopes.to(device=device, dtype=torch.float32).repeat(b).contiguous()
    return (functools.partial(flash_fwd, causal=causal, slopes=slopes),
            functools.partial(flash_bwd, causal=causal, slopes=slopes))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over (B, H, Nq, D) x (B, H, Nk, D) -> (B, H, Nq, D),
    differentiable in (q, k, v). `alibi_slopes` (H,) adds the bias
    -slope * (i - j); causal masks key j > i + Nk - Nq. Views of the heads
    are taken as they lie; O comes back as a view of a token-major (B, Nq,
    H, D) array in bf16, so the caller's merge of the heads is free."""
    b, h = q.shape[:2]
    return _heads.Attention.apply(q, k, v, _ops(b, h, q.device, causal, alibi_slopes))


def flash_attention_qkv(qkv: torch.Tensor, heads: int, *, causal: bool = False,
                        alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`flash_attention` over a fused (B, N, 3W) projection [q | k | v] of
    `heads` heads -> (B, N, W), the heads merged; differentiable in qkv. In
    bf16 the kernels read the heads out of qkv and write dQ, dK and dV into
    one (B, N, 3W) gradient."""
    return _heads.PackedAttention.apply(
        qkv, heads, _ops(qkv.shape[0], heads, qkv.device, causal, alibi_slopes))
