"""Plain PyTorch pieces the references share: products in a stated
precision, LayerNorm, the activations and the CLIP pixel normalization.

Nothing here imports the program. `float32` is the reference (TF32 off);
`fp8` is the control, the step below the configurations' bfloat16: both
operands of every product rounded to float8 e4m3 with one scale a tensor
(its largest magnitude onto 448), then multiplied in float32.
"""

from __future__ import annotations

import math

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
E4M3_MAX = 448.0


def full_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded through float8 e4m3 with a per-tensor scale, in float32.
    The rounding's gradient is passed straight through."""
    t = t.float()
    scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b (batched) in float32, after rounding both operands to fp8 for
    the control."""
    if precision == "fp8":
        return fp8_round(a) @ fp8_round(b)
    if precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return a.float() @ b.float()


def layer_norm(x: torch.Tensor, g, b=None, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) / torch.sqrt(var + eps) * g.float()
    return y if b is None else y + b.float()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU, 0.5 x (1 + erf(x / sqrt 2))."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def normalize_pixels(x01: torch.Tensor) -> torch.Tensor:
    m = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x01.device).reshape(1, 3, 1, 1)
    s = torch.tensor(CLIP_STD, dtype=torch.float32, device=x01.device).reshape(1, 3, 1, 1)
    return (x01.float() - m) / s


def softmax_attention(q, k, v, precision: str, bias=None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias) v over the last two axes."""
    s = mm(q, k.transpose(-1, -2), precision) / math.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias
    return mm(torch.softmax(s, dim=-1), v, precision)
