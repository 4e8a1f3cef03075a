"""Norms, gradient normalization and eps-ball projections, batch-first.

Counterpart of `robustvlm_tpu/ops/projections.py`. Norms reduce over every
axis but the first; per-example scalars broadcast back over the trailing
axes. The l1 projection onto the l1 ball intersected with the [0,1] box is
the sorted-breakpoint bisection of the JAX version, with its fixed
ceil(log2(2F)) steps, in float32 as in JAX (float64 inputs stay float64).
"""

from __future__ import annotations

import math

import torch

from robustvlm_tpu_torch.ops.kernels.attack_step import jnp_sign

_EPS_DIV = 1e-12


def canonical_norm(norm: str) -> str:
    """Accept 'Linf'/'linf'/'L2'/... and return the lowercase name."""
    n = norm.lower()
    if n not in ("linf", "l2", "l1", "l0"):
        raise ValueError(f"unknown norm: {norm}")
    return n


def _flatten(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _per_example(z: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return z.reshape(-1, *([1] * (like.dim() - 1)))


def l1_norm(x: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    z = _flatten(x).abs().sum(dim=-1)
    return _per_example(z, x) if keepdims else z


def l2_norm(x: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    z = torch.sqrt(torch.square(_flatten(x)).sum(dim=-1))
    return _per_example(z, x) if keepdims else z


def linf_norm(x: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    z = _flatten(x).abs().amax(dim=-1)
    return _per_example(z, x) if keepdims else z


def l0_norm(x: torch.Tensor) -> torch.Tensor:
    """Nonzero entries per example, as float32."""
    return (_flatten(x) != 0.0).to(torch.float32).sum(dim=-1)


_NORM_FNS = {"linf": linf_norm, "l2": l2_norm, "l1": l1_norm}


def lp_normalize(x: torch.Tensor, norm: str) -> torch.Tensor:
    """x / (||x||_p + 1e-12) per example, p in linf, l2, l1."""
    fn = _NORM_FNS[canonical_norm(norm)]
    return x / (fn(x, keepdims=True) + _EPS_DIV)


def normalize_grad(grad: torch.Tensor, norm: str) -> torch.Tensor:
    """PGD step direction: linf -> `jnp.sign(g)` (NaN stays NaN, -0.0
    keeps its sign); l2 -> g / (||g||_2 + 1e-12) per example. The JAX
    version has no l1 direction either."""
    n = canonical_norm(norm)
    if n == "linf":
        return jnp_sign(grad)
    if n == "l2":
        return grad / (l2_norm(grad, keepdims=True) + _EPS_DIV)
    raise ValueError(f"normalize_grad: unsupported norm {norm}")


def project_perturbation(delta: torch.Tensor, eps: float, norm: str) -> torch.Tensor:
    """Onto the eps-ball: linf clamps each element to [-eps, eps] (NaN
    stays NaN, as `jnp.clip`); l2 scales rows whose norm exceeds eps by
    min(1, eps / (||delta||_2 + 1e-12)). For l1 use `l1_ball_projection`,
    as the JAX package does."""
    n = canonical_norm(norm)
    if n == "linf":
        return torch.clamp(delta, -eps, eps)
    if n == "l2":
        factor = torch.clamp(eps / (l2_norm(delta, keepdims=True) + _EPS_DIV), max=1.0)
        return delta * factor
    raise ValueError(f"project_perturbation: unsupported norm {norm}")


def l1_ball_projection(x: torch.Tensor, y: torch.Tensor, eps) -> torch.Tensor:
    """Correction `d` such that ||y + d||_1 <= eps and 0 <= x + y + d <= 1.

    For each example the shrinkage threshold `alpha` is found by bisection
    over the 2F sorted breakpoints of the piecewise-linear l1-mass function;
    each coordinate's magnitude is then reduced toward it within the [0,1]
    box. Rows already inside the ball are left as they are. The sort is
    stable and carries each breakpoint's provenance (the u half or the l
    half), as `jax.lax.sort_key_val` does: breakpoints tie wherever y = 0,
    and the provenance sets the cumulative counts.
    """
    b = x.shape[0]
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = _flatten(x).to(acc)
    yf = _flatten(y).to(acc)
    n_fts = xf.shape[1]

    sigma = jnp_sign(yf)
    # u: the most |y_i| can grow inside the box; <= 0 after the min with 0
    u = torch.minimum(1.0 - xf - yf, xf + yf)
    u = torch.minimum(torch.zeros_like(yf), u)
    l = -yf.abs()

    bs, indbs = torch.sort(-torch.cat([u, l], dim=1), dim=1, stable=True)  # (B, 2F)
    bs2 = torch.cat([bs[:, 1:], torch.zeros((b, 1), dtype=bs.dtype, device=bs.device)], dim=1)

    inu = 2.0 * (indbs < n_fts).to(acc) - 1.0
    size1 = torch.cumsum(inu, dim=1)

    s1 = -u.sum(dim=1)
    c = float(eps) - yf.abs().sum(dim=1)
    needs_proj = (s1 + c) < 0.0

    s = s1[:, None] + torch.cumsum((bs2 - bs) * size1, dim=1)

    # bisection for the largest index with s[idx] + c < 0
    nitermax = int(math.ceil(math.log2(2 * n_fts)))
    lb = torch.zeros((b,), dtype=torch.float32, device=xf.device)
    ub = torch.full((b,), float(2 * n_fts - 1), dtype=torch.float32, device=xf.device)
    for _ in range(nitermax):
        mid = torch.floor((lb + ub) / 2.0)
        smid = s.gather(1, mid.to(torch.int64)[:, None])[:, 0]
        lt = (smid + c) < 0.0
        lb, ub = torch.where(lt, mid, lb), torch.where(lt, ub, mid)
    lb2 = lb.to(torch.int64)[:, None]

    s_lb = s.gather(1, lb2)[:, 0]
    size1_lb1 = size1.gather(1, lb2 + 1)[:, 0]
    bs2_lb = bs2.gather(1, lb2)[:, 0]
    alpha = (-s_lb - c) / size1_lb1 + bs2_lb

    d_proj = -torch.minimum(torch.maximum(-u, alpha[:, None]), -l)
    d = torch.where(needs_proj[:, None], d_proj, u)
    return (sigma * d).reshape(x.shape).to(x.dtype)


def project_onto_l1_box(x: torch.Tensor, delta: torch.Tensor, eps) -> torch.Tensor:
    """The projected point x + delta + l1_ball_projection(x, delta, eps)."""
    return x + delta + l1_ball_projection(x, delta, eps)
