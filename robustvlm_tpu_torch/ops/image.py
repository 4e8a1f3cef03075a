"""In-model image preprocessing: CLIP normalization and bicubic resize.

Counterpart of `robustvlm_tpu/ops/image.py`. Attacks operate on raw [0,1]
pixels; normalize (and for CIFAR the 32->224 bicubic resize, antialias off)
happen inside the model forward so they are differentiated through. The
resize is two small dense matmuls with precomputed separable weights.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# OpenAI CLIP normalization constants
OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_clip(x: torch.Tensor, mean=OPENAI_MEAN, std=OPENAI_STD) -> torch.Tensor:
    """(x - mean) / std over the channel axis; x is NCHW in [0,1]."""
    m = torch.tensor(mean, dtype=x.dtype, device=x.device).reshape(1, -1, 1, 1)
    s = torch.tensor(std, dtype=x.dtype, device=x.device).reshape(1, -1, 1, 1)
    return (x - m) / s


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel (a=-0.75, the torch/OpenCV convention)."""
    t = np.abs(t)
    out = np.zeros_like(t)
    m1 = t <= 1
    out[m1] = ((a + 2) * t[m1] - (a + 3)) * t[m1] * t[m1] + 1
    m2 = (t > 1) & (t < 2)
    out[m2] = a * (((t[m2] - 5) * t[m2] + 8) * t[m2] - 4)
    return out


@functools.lru_cache(maxsize=32)
def _resize_matrix(src: int, dst: int) -> np.ndarray:
    """(src, dst) weights of 1-D bicubic resize, antialias off, half-pixel
    centers (torchvision's tensor-path BICUBIC with antialias=False)."""
    scale = src / dst
    pos = (np.arange(dst) + 0.5) * scale - 0.5
    base = np.floor(pos).astype(np.int64)
    frac = pos - base
    mat = np.zeros((src, dst), dtype=np.float32)
    for tap in range(-1, 3):
        idx = np.clip(base + tap, 0, src - 1)
        w = _cubic_kernel(frac - tap)
        np.add.at(mat, (idx, np.arange(dst)), w.astype(np.float32))
    return mat


def resize_bicubic(x: torch.Tensor, size: int) -> torch.Tensor:
    """Bicubic resize of NCHW images to (size, size) via two matmuls;
    differentiable."""
    _, _, h, w = x.shape
    if h == size and w == size:
        return x
    mh = torch.from_numpy(_resize_matrix(h, size)).to(x.device, x.dtype)
    mw = torch.from_numpy(_resize_matrix(w, size)).to(x.device, x.dtype)
    y = torch.einsum("bchw,hs->bcsw", x, mh)
    return torch.einsum("bcsw,wt->bcst", y, mw)
