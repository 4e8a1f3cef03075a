"""Fused l-inf APGD/PGD iterate update: CUDA kernel and its plain version.

Counterpart of `robustvlm_tpu/ops/pallas/attack_step.py`. The kernel
(`csrc/attack_step.cu`) replaces `_pallas_linf_step`; the plain version
`linf_step_plain` is `_linf_step_jnp` in PyTorch, bit for bit in float32.
The JAX package leaves its kernel off by default; the port launches its
kernel for every CUDA tensor.

`fused_linf_apgd_step` takes the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from robustvlm_tpu_torch.ops.kernels import _build

# launches of the CUDA kernel (not of the plain version)
LAUNCHES = {"linf_step": 0}


def jnp_sign(g: torch.Tensor) -> torch.Tensor:
    """`jnp.sign`: NaN stays NaN and a zero keeps its sign (`torch.sign`
    maps both to +0)."""
    one = torch.ones((), dtype=g.dtype, device=g.device)
    return torch.where(g > 0, one, torch.where(g < 0, -one, g))


def _f32(value, device) -> torch.Tensor:
    """A float32 0-d tensor: the value rounded to float32 once, on the host,
    as JAX rounds a weak-typed Python float against a float32 array. A fill,
    not a copy from the host, so the plain version can be captured in a
    CUDA graph."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32, device=device)


def linf_step_plain(x_adv, x_adv_old, grad, x, step_size, eps, a) -> torch.Tensor:
    """`_linf_step_jnp` (attack_step.py:37-43) op for op."""
    eps_t = _f32(eps, x.device)
    a_t = _f32(a, x.device)
    step = step_size.reshape(-1, *([1] * (x.dim() - 1)))
    lo = x - eps_t
    hi = x + eps_t
    z = x_adv + step * jnp_sign(grad)
    z = torch.clamp(torch.minimum(torch.maximum(z, lo), hi), 0.0, 1.0)
    xn = x_adv + (z - x_adv) * a_t + (x_adv - x_adv_old) * (1.0 - a_t)
    return torch.clamp(torch.minimum(torch.maximum(xn, lo), hi), 0.0, 1.0)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("attack_step")
    p = ctypes.c_void_p
    lib.linf_step.argtypes = [
        p, p, p, p, p, ctypes.c_float, ctypes.c_float, p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, p,
    ]
    lib.linf_step.restype = ctypes.c_int
    return lib


def _check_cuda(tensors, step_size) -> None:
    ref = tensors[0]
    for t in (*tensors, step_size):
        if t.device != ref.device:
            raise ValueError(f"linf step: tensors on {t.device} and {ref.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"linf step: the kernel takes float32, got {t.dtype}")
    for t in tensors[1:]:
        if t.shape != ref.shape:
            raise ValueError(f"linf step: shape {tuple(t.shape)} != {tuple(ref.shape)}")
    if step_size.numel() != ref.shape[0]:
        raise ValueError(
            f"linf step: step_size has {step_size.numel()} entries for batch {ref.shape[0]}"
        )


def linf_step_cuda(x_adv, x_adv_old, grad, x, step_size, eps, a) -> torch.Tensor:
    """Launch `csrc/attack_step.cu` on CUDA tensors; raises on anything the
    kernel does not take or on a failed launch."""
    tensors = [x_adv, x_adv_old, grad, x]
    _check_cuda(tensors, step_size)
    b = x_adv.shape[0]
    f = math.prod(x_adv.shape[1:])
    xs = [t.contiguous() for t in tensors]
    step = step_size.contiguous()
    out = torch.empty_like(xs[0])
    vec4 = f % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (*xs, out))
    lib = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.linf_step(
            xs[0].data_ptr(), xs[1].data_ptr(), xs[2].data_ptr(), xs[3].data_ptr(),
            step.data_ptr(), float(eps), float(a), out.data_ptr(), b, f,
            int(vec4), stream,
        )
    _build.check_launch(err, "linf_step")
    LAUNCHES["linf_step"] += 1
    return out


def fused_linf_apgd_step(
    x_adv: torch.Tensor,
    x_adv_old: torch.Tensor,
    grad: torch.Tensor,
    x: torch.Tensor,
    step_size: torch.Tensor,
    eps: float,
    a: float,
) -> torch.Tensor:
    """One l-inf APGD iterate update over (B, ...) images with per-example
    step sizes (B,), radius `eps` and momentum blend `a` (1.0 on the first
    iteration, 0.75 after). CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if x_adv.device.type == "cpu":
        return linf_step_plain(x_adv, x_adv_old, grad, x, step_size, eps, a)
    if x_adv.device.type != "cuda":
        raise ValueError(f"linf step: unsupported device {x_adv.device}")
    return linf_step_cuda(x_adv, x_adv_old, grad, x, step_size, eps, a)
