"""AutoPGD (APGD), l-inf, as a Python loop over PyTorch tensors.

Counterpart of `robustvlm_tpu/attacks/apgd.py` (`apgd_attack`,
`apgd_restarts`) for the l-inf norm. The JAX version's compiled-core cache,
`host_loop` and buffer donation are JAX machinery; here one Python loop
drives the iterations eagerly. What changes results is kept as it is:

- the static checkpoint schedule (`_checkpoint_schedule`), so halving
  happens at the same iterations;
- the wrap-around of `_oscillation_count` at the first checkpoint (the
  reference's torch negative-index read of a still-zero row);
- strictly-greater best tracking;
- the forward-only final iteration (`skip_last_grad`): its gradient is
  never read, so its backward is skipped;
- warm starts (`x_init`) and random starts (`use_rs`).

The pixel gradient comes from `torch.autograd.grad` with respect to the
iterate only; `CLIP` freezes its weights (`requires_grad_(False)`), so
autograd computes no weight gradients. The l-inf update is
`fused_linf_apgd_step`: the CUDA kernel for CUDA tensors.

Random starts draw from a `torch.Generator` seeded with an integer. Where
the JAX package folds integers into a PRNG key (`jax.random.fold_in`), the
port folds the same integers into the seed with `fold_in`; the two
frameworks give different random numbers from the same seed.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from robustvlm_tpu_torch.attacks._validate import check_image_range
from robustvlm_tpu_torch.ops.kernels.attack_step import fused_linf_apgd_step
from robustvlm_tpu_torch.ops.projections import canonical_norm, lp_normalize

_MASK64 = (1 << 64) - 1


class APGDResult(NamedTuple):
    x_best: torch.Tensor      # iterate attaining the highest loss
    x_best_adv: torch.Tensor  # last iterate observed misclassified (or last iterate)
    loss_best: torch.Tensor   # (B,) best loss per example
    acc: torch.Tensor         # (B,) bool: still classified correctly at every step


def fold_in(seed: int, data: int) -> int:
    """A child seed from (seed, data), splitmix64-mixed: the port's
    counterpart of `jax.random.fold_in`. Deterministic; fits
    `torch.Generator.manual_seed`."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _checkpoint_schedule(n_iter: int, norm: str):
    """(is_ckpt[n_iter] bool, window[n_iter] int32): the counter3/k
    bookkeeping unrolled; window is the oscillation-check span in effect at
    each checkpoint (before its decrement)."""
    if norm in ("linf", "l2"):
        k = max(int(0.22 * n_iter), 1)
        n_iter_min = max(int(0.06 * n_iter), 1)
        size_decr = max(int(0.03 * n_iter), 1)
    else:  # l1
        k = max(int(0.04 * n_iter), 1)
        n_iter_min = size_decr = 0
    is_ckpt = np.zeros(n_iter, dtype=bool)
    window = np.zeros(n_iter, dtype=np.int32)
    counter3 = 0
    for i in range(n_iter):
        counter3 += 1
        if counter3 == k:
            is_ckpt[i] = True
            window[i] = k
            counter3 = 0
            if norm in ("linf", "l2"):
                k = max(k - size_decr, n_iter_min)
    return is_ckpt, window


def _oscillation_count(hist: torch.Tensor, i: int, k: int) -> torch.Tensor:
    """t[b] = #{ j in (i-k, i] : hist[j] > hist[j-1 mod n_iter] }."""
    n_iter = hist.shape[0]
    prev = torch.roll(hist, 1, dims=0)
    increased = (hist > prev).to(torch.float32)
    j = torch.arange(n_iter, device=hist.device)[:, None]
    in_window = ((j > i - k) & (j <= i)).to(torch.float32)
    return (increased * in_window).sum(dim=0)


def _random_init(seed: int, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Canonical l-inf random start: x + eps * t/||t||_inf, t ~ U(-1, 1)."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    t = 2.0 * torch.rand(x.shape, generator=gen, device=x.device, dtype=x.dtype) - 1.0
    return x + eps * lp_normalize(t, "linf")


def apgd_attack(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    *,
    criterion: Callable,
    eps: float,
    n_iter: int = 100,
    norm: str = "linf",
    alpha: Optional[float] = None,
    initial_stepsize: Optional[float] = None,
    use_rs: bool = False,
    rng: Optional[int] = None,
    x_init: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    criterion_args: tuple = (),
    skip_last_grad: bool = True,
) -> APGDResult:
    """Run l-inf APGD, maximizing `criterion(model_fn(x_adv), y, *criterion_args)`.

    model_fn maps [0,1] pixels to logits (normalization inside). y (B,)
    enables accuracy tracking; None makes x_best_adv track the last
    iterate. alpha is the initial step multiplier (step = alpha * eps,
    default 2.0); initial_stepsize (absolute) overrides it. use_rs draws a
    random start from the integer seed `rng`; x_init is an explicit warm
    start; mask multiplies the gradient.
    """
    norm = canonical_norm(norm)
    if norm != "linf":
        raise NotImplementedError(
            f"apgd: norm {norm} is not ported yet (ROADMAP queue A3); l-inf only"
        )
    check_image_range(x)
    b = x.shape[0]
    track_acc = y is not None
    if alpha is None:
        alpha = 2.0
    if initial_stepsize is not None:
        alpha = initial_stepsize / eps

    if x_init is not None:
        x_adv = x_init
    elif use_rs:
        if rng is None:
            raise ValueError("use_rs=True requires rng")
        x_adv = _random_init(rng, x, eps)
    else:
        x_adv = x
    x_adv = x_adv.detach().clamp(0.0, 1.0)

    def expand(v):  # (B,) -> broadcastable over image dims
        return v.reshape(-1, *([1] * (x.dim() - 1)))

    def predictions(out):
        if track_acc:
            return out.argmax(dim=-1) == y
        return torch.zeros((b,), dtype=torch.bool, device=x.device)

    def eval_point(xa):
        xa = xa.detach().requires_grad_(True)
        with torch.enable_grad():
            out = model_fn(xa)
            li = criterion(out, y, *criterion_args)
            (grad,) = torch.autograd.grad(li.sum(), xa)
        if mask is not None:
            grad = grad * mask
        return li.detach(), grad, predictions(out.detach())

    def fwd_only_eval(xa):
        out = model_fn(xa)
        li = criterion(out, y, *criterion_args)
        return li, torch.zeros_like(xa), predictions(out)

    is_ckpt, window = _checkpoint_schedule(n_iter, norm)
    with torch.no_grad():
        loss, grad, correct = eval_point(x_adv)
        x_adv_old = x_adv
        grad_best = grad
        x_best = x_best_adv = x_adv
        loss_best = loss_best_last_check = loss
        reduced_last_check = torch.ones((b,), dtype=x.dtype, device=x.device)
        step_size = torch.full((b,), alpha * eps, dtype=x.dtype, device=x.device)
        acc = correct
        hist = torch.zeros((n_iter, b), dtype=torch.float32, device=x.device)

        for i in range(n_iter):
            a = 0.75 if i > 0 else 1.0
            x_new = fused_linf_apgd_step(x_adv, x_adv_old, grad, x, step_size, eps, a)
            x_adv_old, x_adv = x_adv, x_new

            if skip_last_grad and i == n_iter - 1:
                loss, grad, pred_correct = fwd_only_eval(x_adv)
            else:
                loss, grad, pred_correct = eval_point(x_adv)
            if track_acc:
                acc = acc & pred_correct
            x_best_adv = torch.where(expand(~pred_correct), x_adv, x_best_adv)

            # best tracking, strictly greater
            improved = loss > loss_best
            x_best = torch.where(expand(improved), x_adv, x_best)
            grad_best = torch.where(expand(improved), grad, grad_best)
            loss_best = torch.where(improved, loss, loss_best)
            hist[i] = loss.to(torch.float32)

            if is_ckpt[i]:  # oscillation check at the static checkpoints
                k = int(window[i])
                t = _oscillation_count(hist, i, k)
                fl_osc = (t <= k * 0.75).to(x.dtype)
                fl_no_impr = (1.0 - reduced_last_check) * (
                    loss_best_last_check >= loss_best
                ).to(x.dtype)
                fl = torch.maximum(fl_osc, fl_no_impr)
                halve = fl > 0
                step_size = torch.where(halve, step_size / 2.0, step_size)
                x_adv = torch.where(expand(halve), x_best, x_adv)
                grad = torch.where(expand(halve), grad_best, grad)
                reduced_last_check = fl
                loss_best_last_check = loss_best

    return APGDResult(x_best=x_best, x_best_adv=x_best_adv, loss_best=loss_best, acc=acc)


def apgd_restarts(
    model_fn,
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    *,
    criterion,
    eps: float,
    n_iter: int = 100,
    norm: str = "linf",
    n_restarts: int = 1,
    use_largereps: bool = False,
    rng: Optional[int] = None,
    use_rs: bool = True,
    **kwargs,
) -> APGDResult:
    """n_restarts independent APGD runs. Per example, x_best_adv keeps the
    FIRST successful adversarial across restarts; x_best/loss_best track the
    highest-loss point."""
    if use_largereps:
        raise NotImplementedError(
            "apgd_decr_eps (use_largereps) is not ported yet (ROADMAP queue A3)"
        )
    rng = 0 if rng is None else rng
    ndim1 = (-1,) + (1,) * (x.dim() - 1)
    acc = None
    x_adv = x
    x_best = x
    loss_best = torch.full((x.shape[0],), -math.inf, dtype=torch.float32, device=x.device)
    for r in range(max(n_restarts, 1)):
        res = apgd_attack(
            model_fn, x, y, criterion=criterion, eps=eps, n_iter=n_iter,
            norm=norm, use_rs=use_rs, rng=fold_in(rng, r), **kwargs,
        )
        if acc is None:
            acc, x_adv = res.acc, res.x_best_adv
        else:
            newly_fooled = acc & ~res.acc
            x_adv = torch.where(newly_fooled.reshape(ndim1), res.x_best_adv, x_adv)
            acc = acc & res.acc
        improved = res.loss_best > loss_best
        x_best = torch.where(improved.reshape(ndim1), res.x_best, x_best)
        loss_best = torch.where(improved, res.loss_best, loss_best)
    return APGDResult(x_best=x_best, x_best_adv=x_adv, loss_best=loss_best, acc=acc)
