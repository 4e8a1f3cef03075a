"""Momentum PGD as a Python loop over PyTorch tensors.

Counterpart of `robustvlm_tpu/attacks/pgd.py` (`pgd_attack`). Per
iteration: the gradient of the loss with respect to the perturbation, NaN
gradients zeroed, the direction normalized (sign or unit l2), the velocity
accumulated with momentum and re-normalized itself, a signed step (max or
min mode), the eps-ball projection and the [0,1] clamp. The update is plain
elementwise PyTorch, as it is plain jnp in JAX; only the model's forward
and backward launch kernels.

A random start draws from a `torch.Generator` seeded with an integer; the
two frameworks give different numbers from the same seed, so comparisons
pass an explicit `perturbation`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from robustvlm_tpu_torch.attacks._validate import check_image_range
from robustvlm_tpu_torch.ops.projections import normalize_grad, project_perturbation


def pgd_random_start(shape, eps: float, seed: int, device, dtype) -> torch.Tensor:
    """PGD's random start: U(-eps, eps) of `shape` drawn from the integer
    seed `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(shape, generator=gen, device=device, dtype=dtype)
    return -eps + 2.0 * eps * u


def pgd_attack(
    loss_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    *,
    eps: float,
    stepsize: float,
    iterations: int,
    norm: str = "linf",
    mode: str = "max",
    momentum: float = 0.9,
    perturbation: Optional[torch.Tensor] = None,
    random_start: bool = False,
    rng: Optional[int] = None,
) -> torch.Tensor:
    """Run momentum PGD and return `x + delta`, detached.

    loss_fn maps x_adv (B, ...) in [0,1] to a scalar loss; the model and
    the targets are closed over. eps and stepsize are in image units.
    mode 'max' maximizes the loss, 'min' minimizes it. `perturbation` is an
    explicit start and overrides `random_start`, which draws U(-eps, eps)
    from the integer seed `rng`."""
    check_image_range(x)
    if mode not in ("min", "max"):
        raise ValueError(f"unknown mode: {mode}")
    sign = -1.0 if mode == "min" else 1.0
    x = x.detach()
    if perturbation is None:
        if random_start:
            if rng is None:
                raise ValueError("random_start=True requires rng")
            perturbation = pgd_random_start(x.shape, eps, rng, x.device, x.dtype)
        else:
            perturbation = torch.zeros_like(x)
    pert = perturbation.detach()
    velocity = torch.zeros_like(x)
    for _ in range(iterations):
        xa = (x + pert).requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(loss_fn(xa), xa)
        with torch.no_grad():
            g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
            g = normalize_grad(g, norm)
            velocity = normalize_grad(momentum * velocity + g, norm)
            pert = project_perturbation(pert + sign * stepsize * velocity, eps, norm)
            pert = torch.clamp(x + pert, 0.0, 1.0) - x
    return x + pert
