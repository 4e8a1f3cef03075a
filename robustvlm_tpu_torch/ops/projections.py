"""Norm names and l-inf normalization, batch-first.

Counterpart of the l-inf part of `robustvlm_tpu/ops/projections.py`: what
the l-inf APGD needs (l2/l1 balls are not ported yet).
"""

from __future__ import annotations

import torch

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


def lp_normalize(x: torch.Tensor, norm: str) -> torch.Tensor:
    """x / (||x||_p + 1e-12) per example; l-inf only in this port."""
    if canonical_norm(norm) != "linf":
        raise NotImplementedError(
            f"lp_normalize: norm {norm} is not ported yet (ROADMAP queue A3)"
        )
    return x / (linf_norm(x, keepdims=True) + _EPS_DIV)
