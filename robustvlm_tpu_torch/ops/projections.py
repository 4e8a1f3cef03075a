"""Norms, gradient normalization and eps-ball projections, batch-first.

Counterpart of `robustvlm_tpu/ops/projections.py` for the l-inf and l2
norms: what l-inf APGD and PGD need. Norms reduce over every axis but the
first. The l1 balls are not ported yet (ROADMAP A5).
"""

from __future__ import annotations

import torch

from robustvlm_tpu_torch.ops.kernels.attack_step import jnp_sign

_EPS_DIV = 1e-12


def canonical_norm(norm: str) -> str:
    """Accept 'Linf'/'linf'/'L2'/... and return the lowercase name."""
    n = norm.lower()
    if n not in ("linf", "l2", "l1", "l0"):
        raise ValueError(f"unknown norm: {norm}")
    return n


def linf_norm(x: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    z = x.reshape(x.shape[0], -1).abs().amax(dim=-1)
    return z.reshape(-1, *([1] * (x.dim() - 1))) if keepdims else z


def _per_example(z: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return z.reshape(-1, *([1] * (like.dim() - 1)))


def l2_norm(x: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    z = torch.sqrt(torch.square(x.reshape(x.shape[0], -1)).sum(dim=-1))
    return _per_example(z, x) if keepdims else z


def normalize_grad(grad: torch.Tensor, norm: str) -> torch.Tensor:
    """PGD step direction: linf -> `jnp.sign(g)` (NaN stays NaN, -0.0
    keeps its sign); l2 -> g / (||g||_2 + 1e-12) per example."""
    n = canonical_norm(norm)
    if n == "linf":
        return jnp_sign(grad)
    if n == "l2":
        return grad / (l2_norm(grad, keepdims=True) + _EPS_DIV)
    raise ValueError(f"normalize_grad: unsupported norm {norm}")


def project_perturbation(delta: torch.Tensor, eps: float, norm: str) -> torch.Tensor:
    """Onto the eps-ball: linf clamps each element to [-eps, eps] (NaN
    stays NaN, as `jnp.clip`); l2 scales rows whose norm exceeds eps by
    min(1, eps / (||delta||_2 + 1e-12))."""
    n = canonical_norm(norm)
    if n == "linf":
        return torch.clamp(delta, -eps, eps)
    if n == "l2":
        factor = torch.clamp(eps / (l2_norm(delta, keepdims=True) + _EPS_DIV), max=1.0)
        return delta * factor
    raise ValueError(f"project_perturbation: unsupported norm {norm}")


def lp_normalize(x: torch.Tensor, norm: str) -> torch.Tensor:
    """x / (||x||_p + 1e-12) per example; l-inf only in this port."""
    if canonical_norm(norm) != "linf":
        raise NotImplementedError(
            f"lp_normalize: norm {norm} is not ported yet (ROADMAP queue A3)"
        )
    return x / (linf_norm(x, keepdims=True) + _EPS_DIV)
