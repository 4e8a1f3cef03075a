"""The transformer block's LayerNorm and bias + activation, forward and
backward: one-pass CUDA kernels and their plain versions (the CLIP towers,
BLIP-2's EVA tower, its Q-Former and OPT; OpenFlamingo's MPT, Perceiver and
cross-attention LayerNorms).

No Pallas kernel is replaced: the JAX package leaves both chains to XLA,
which fuses them. PyTorch runs them eagerly as chains of elementwise
kernels, each moving a float32 copy of the activation; the kernels in
`csrc/block_ops.cu` are bound by bytes and move each byte once (the source
says how). What they compute:

- `layer_norm(x, g, b, eps)`: LayerNorm over the last dim with float32
  statistics (biased variance), the output in x's dtype; `b=None` is the
  bias-free form (MPT's), which the kernels run with a zero bias (x_hat g +
  0 is x_hat g in float32) and no bias gradient. The backward reads
  x, dy and g and the forward's per-row float32 mean and rstd, and writes
  dx = rstd (dy g - mean(dy g) - x_hat mean(dy g x_hat)); dg = sum dy x_hat
  and db = sum dy only when g or b requires grad, summed in a fixed order.
- `bias_act(h, bias, act)`: z = h + bias rounded to h's dtype, then the
  activation `act` names (`ACTS`: QuickGELU, the exact erf GELU or ReLU; the
  CLIP block's flag True or False is QuickGELU or GELU), evaluated in
  float32 and rounded once. It saves h only; the backward recomputes z and
  writes dh = dy act'(z) (ReLU's: dy where z > 0, else +0), and sums
  dh over rows for the bias when it requires grad.

CPU tensors take the plain versions, the block's arithmetic op for op with
autograd through it (`layer_norm_plain`, `bias_act_plain`). CUDA tensors go
through one `torch.autograd.Function` each (`LayerNormFn`, `BiasActFn`),
which launches the kernels or raises. The Functions run on CPU tensors too,
with the analytic plain backwards (`layer_norm_bwd_plain`,
`bias_act_bwd_plain`): the tests hold those against autograd through the
plain versions, and the kernels against them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from robustvlm_tpu_torch.ops.kernels import _build

# launches of the CUDA kernels (not of the plain versions); one backward
# launch is the main kernel followed, when a weight gradient is asked for,
# by the reduction of its partial sums
LAUNCHES = {"layer_norm_fwd": 0, "layer_norm_bwd": 0, "bias_act_fwd": 0, "bias_act_bwd": 0}

MAX_WIDTH = 8192  # LayerNorm rows the kernels hold in registers (8 warps of 32 values a lane)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ACTS = {"gelu": 0, "quick_gelu": 1, "relu": 2}  # the activations, by the C interface's codes


# ------------------------------------------------------------- plain versions
def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def layer_norm_plain(x: torch.Tensor, g: torch.Tensor, b: Optional[torch.Tensor],
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics regardless of activation dtype; no
    bias added when b is None."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * g.float()
    return (y if b is None else y + b.float()).to(x.dtype)


def act_name(act) -> str:
    """The name in `ACTS` of `act`: a name, or the CLIP block's flag (True
    QuickGELU, False the exact GELU)."""
    if isinstance(act, bool):
        return "quick_gelu" if act else "gelu"
    if act not in ACTS:
        raise ValueError(f"bias_act: unknown activation {act!r}; one of {sorted(ACTS)}")
    return act


def bias_act_plain(h: torch.Tensor, bias: torch.Tensor, act) -> torch.Tensor:
    """The activation of `h + bias` with the bias cast to h's dtype first;
    QuickGELU, the exact (erf) GELU or ReLU (`act_name`)."""
    fn = {"quick_gelu": quick_gelu, "gelu": F.gelu, "relu": F.relu}[act_name(act)]
    return fn(h + bias.to(h.dtype))


def _acc(dtype) -> torch.dtype:
    """The plain backwards' arithmetic: float64 stays float64, the rest is
    float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def layer_norm_fwd_plain(x, g, b, eps: float):
    """y (`layer_norm_plain`), and the per-row mean and rstd over the last
    dim (x's leading shape, float32)."""
    xf = x.float()
    rstd = torch.rsqrt(xf.var(dim=-1, unbiased=False) + eps)
    return layer_norm_plain(x, g, b, eps), xf.mean(dim=-1), rstd


def layer_norm_bwd_plain(x, g, mean, rstd, dy, weights: bool):
    """dx in x's dtype and, with `weights`, dg and db (None without), from x,
    g, the forward's mean and rstd and dy, analytically."""
    acc = _acc(x.dtype)
    xh = (x.to(acc) - mean.to(acc).unsqueeze(-1)) * rstd.to(acc).unsqueeze(-1)
    dyf = dy.to(acc)
    wd = dyf * g.to(acc)
    dx = rstd.to(acc).unsqueeze(-1) * (wd - wd.mean(dim=-1, keepdim=True)
                                       - xh * (wd * xh).mean(dim=-1, keepdim=True))
    if not weights:
        return dx.to(x.dtype), None, None
    w = x.shape[-1]
    return dx.to(x.dtype), (dyf * xh).reshape(-1, w).sum(0), dyf.reshape(-1, w).sum(0)


def bias_act_bwd_plain(h, bias, dy, act, with_bias: bool):
    """dh in h's dtype and, with `with_bias`, the bias gradient (the sum of dh
    over rows; None without), analytically."""
    acc = _acc(h.dtype)
    z = (h + bias.to(h.dtype)).to(acc)
    name = act_name(act)
    if name == "relu":  # a select, as autograd's: +0 where z <= 0
        dh = torch.where(z > 0, dy.to(acc), 0.0).to(h.dtype)
    else:
        if name == "quick_gelu":
            s = torch.sigmoid(1.702 * z)
            grad = s * (1 + 1.702 * z * (1 - s))
        else:
            grad = 0.5 * (1 + torch.erf(z * math.sqrt(0.5))) + z * torch.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
        dh = (dy.to(acc) * grad).to(h.dtype)
    return dh, (dh.to(acc).reshape(-1, h.shape[-1]).sum(0) if with_bias else None)


# ----------------------------------------------------------------- CUDA path
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("block_ops"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from block_ops.cu."""
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.block_ops_slots.argtypes = [i, ll, i, i, i]
    lib.block_ops_slots.restype = ll
    lib.layer_norm_fwd.argtypes = [p, ll, p, p, p, p, p, ll, i, f, i, i, p]
    lib.layer_norm_fwd.restype = i
    lib.layer_norm_bwd.argtypes = [p, ll, p, p, p, p, p, p, p, p, ll, i, i, i, p]
    lib.layer_norm_bwd.restype = i
    lib.bias_act_fwd.argtypes = [p, p, p, ll, i, i, i, i, p]
    lib.bias_act_fwd.restype = i
    lib.bias_act_bwd.argtypes = [p, p, p, p, p, p, ll, i, i, i, i, p]
    lib.bias_act_bwd.restype = i
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, x: torch.Tensor, vectors) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {x.dtype}")
    w = x.shape[-1]
    for v in vectors:
        if v.device != x.device or v.numel() != w:
            raise ValueError(f"{name}: a ({w},) parameter on {x.device} is needed, got "
                             f"{tuple(v.shape)} on {v.device}")


def _vec(width: int, stride: int, tensors) -> int:
    """1 when every row can be read and written in 16-byte words (tensors[0]
    holds the rows)."""
    per = 16 // tensors[0].element_size()
    return int(width % per == 0 and stride % per == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _f32(v: torch.Tensor) -> torch.Tensor:
    return v.detach().to(torch.float32).contiguous()


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as (rows, width) with unit column stride, a view where the leading
    dims collapse into one row stride (x[:, 0] of a (B, N, W) tensor is one)."""
    w = x.shape[-1]
    if x.stride(-1) == 1:
        try:
            return x.view(-1, w)
        except RuntimeError:
            pass
    return x.contiguous().view(-1, w)


# float32 zeros by (width, device): the bias a bias-free LayerNorm hands the
# forward kernel
_ZERO_BIAS = {}


def _zero_bias(width: int, device: torch.device) -> torch.Tensor:
    z = _ZERO_BIAS.get((width, device))
    if z is None:
        z = _ZERO_BIAS[(width, device)] = torch.zeros(width, dtype=torch.float32, device=device)
    return z


def layer_norm_fwd_cuda(x, g, b, eps: float):
    if b is None:
        b = _zero_bias(x.shape[-1], x.device)
    _check("layer_norm", x, (g, b))
    w = x.shape[-1]
    if w > MAX_WIDTH:
        raise ValueError(f"layer_norm: width {w} is past the kernel's {MAX_WIDTH}")
    x2, g32, b32 = _rows(x), _f32(g), _f32(b)
    rows = x2.shape[0]
    y = torch.empty((rows, w), dtype=x.dtype, device=x.device)
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    vec = _vec(w, x2.stride(0), (x2, g32, b32))
    with torch.cuda.device(x.device):
        err = _lib().layer_norm_fwd(x2.data_ptr(), x2.stride(0), g32.data_ptr(), b32.data_ptr(),
                                    y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), rows, w,
                                    float(eps), _DTYPES[x.dtype], vec, _stream(x))
    _build.check_launch(err, "layer_norm forward")
    LAUNCHES["layer_norm_fwd"] += 1
    return y.view(x.shape), mean.view(x.shape[:-1]), rstd.view(x.shape[:-1])


def layer_norm_bwd_cuda(x, g, mean, rstd, dy, weights: bool):
    _check("layer_norm backward", x, (g,))
    w = x.shape[-1]
    x2, g32 = _rows(x), _f32(g)
    rows = x2.shape[0]
    dy2 = dy.to(x.dtype).reshape(rows, w).contiguous()
    dx = torch.empty((rows, w), dtype=x.dtype, device=x.device)
    vec = _vec(w, x2.stride(0), (x2, g32, dy2))
    dt = _DTYPES[x.dtype]
    lib = _lib()
    part = dg = db = None
    if weights:
        slots = lib.block_ops_slots(0, rows, w, dt, vec)
        part = torch.empty((slots, 2 * w), dtype=torch.float32, device=x.device)
        dg = torch.empty(w, dtype=torch.float32, device=x.device)
        db = torch.empty(w, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.layer_norm_bwd(x2.data_ptr(), x2.stride(0), dy2.data_ptr(), g32.data_ptr(),
                                 mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), _ptr(part), _ptr(dg),
                                 _ptr(db), rows, w, dt, vec, _stream(x))
    _build.check_launch(err, "layer_norm backward")
    LAUNCHES["layer_norm_bwd"] += 1
    return dx.view(x.shape), dg, db


def bias_act_fwd_cuda(h, bias, act):
    _check("bias_act", h, (bias,))
    n = h.shape[-1]
    h2, b32 = h.contiguous().view(-1, n), _f32(bias)
    out = torch.empty_like(h2)
    vec = _vec(n, n, (h2, b32))
    with torch.cuda.device(h.device):
        err = _lib().bias_act_fwd(h2.data_ptr(), b32.data_ptr(), out.data_ptr(), h2.shape[0], n,
                                  ACTS[act_name(act)], _DTYPES[h.dtype], vec, _stream(h))
    _build.check_launch(err, "bias_act forward")
    LAUNCHES["bias_act_fwd"] += 1
    return out.view(h.shape)


def bias_act_bwd_cuda(h, bias, dy, act, with_bias: bool):
    _check("bias_act backward", h, (bias,))
    n = h.shape[-1]
    h2, b32 = h.contiguous().view(-1, n), _f32(bias)
    rows = h2.shape[0]
    dy2 = dy.to(h.dtype).reshape(rows, n).contiguous()
    dh = torch.empty_like(h2)
    vec = _vec(n, n, (h2, b32, dy2))
    dt = _DTYPES[h.dtype]
    lib = _lib()
    part = dbias = None
    if with_bias:
        part = torch.empty((lib.block_ops_slots(1, rows, n, dt, vec), n), dtype=torch.float32,
                           device=h.device)
        dbias = torch.empty(n, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        err = lib.bias_act_bwd(h2.data_ptr(), b32.data_ptr(), dy2.data_ptr(), dh.data_ptr(),
                               _ptr(part), _ptr(dbias), rows, n, ACTS[act_name(act)], dt, vec, _stream(h))
    _build.check_launch(err, "bias_act backward")
    LAUNCHES["bias_act_bwd"] += 1
    return dh.view(h.shape), dbias


# ------------------------------------------------------------ autograd route
def _cast(grad: Optional[torch.Tensor], like: torch.Tensor) -> Optional[torch.Tensor]:
    return None if grad is None else grad.to(like.dtype)


class LayerNormFn(torch.autograd.Function):
    """`layer_norm` differentiable in x, g and b (b may be None: no bias);
    saves x, g and the per-row float32 mean and rstd. The kernels for CUDA
    tensors, the plain versions (analytic backward) otherwise."""

    @staticmethod
    def forward(ctx, x, g, b, eps):
        fwd = layer_norm_fwd_cuda if x.is_cuda else layer_norm_fwd_plain
        y, mean, rstd = fwd(x, g, b, eps)
        ctx.save_for_backward(x, g, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, g, mean, rstd = ctx.saved_tensors
        _, need_g, need_b, _ = ctx.needs_input_grad
        bwd = layer_norm_bwd_cuda if x.is_cuda else layer_norm_bwd_plain
        dx, dg, db = bwd(x, g, mean, rstd, dy, need_g or need_b)
        return dx, _cast(dg, g) if need_g else None, _cast(db, g) if need_b else None, None


class BiasActFn(torch.autograd.Function):
    """`bias_act` differentiable in h and the bias; saves h and the bias."""

    @staticmethod
    def forward(ctx, h, bias, act):
        out = bias_act_fwd_cuda(h, bias, act) if h.is_cuda else bias_act_plain(h, bias, act)
        ctx.save_for_backward(h, bias)
        ctx.act = act
        return out

    @staticmethod
    def backward(ctx, dy):
        h, bias = ctx.saved_tensors
        need_bias = ctx.needs_input_grad[1]
        bwd = bias_act_bwd_cuda if h.is_cuda else bias_act_bwd_plain
        dh, dbias = bwd(h, bias, dy, ctx.act, need_bias)
        return dh, _cast(dbias, bias), None


def _route(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU one (plain)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with float32 statistics regardless of the
    activation dtype; the output in x's dtype. b None: no bias."""
    if not _route("layer_norm", x):
        return layer_norm_plain(x, g, b, eps)
    return LayerNormFn.apply(x, g, b, eps)


def bias_act(h: torch.Tensor, bias: torch.Tensor, act) -> torch.Tensor:
    """The activation `act` (`act_name`: QuickGELU, the exact GELU or ReLU)
    of `h + bias`, the bias cast to h's dtype (the block's MLP after its
    first product)."""
    if not _route("bias_act", h):
        return bias_act_plain(h, bias, act)
    return BiasActFn.apply(h, bias, act)
