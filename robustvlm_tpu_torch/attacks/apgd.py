"""AutoPGD (APGD) in the l-inf, l2 and l1 norms, as a Python loop over
PyTorch tensors.

Counterpart of `robustvlm_tpu/attacks/apgd.py` (`apgd_attack`,
`apgd_decr_eps`, `apgd_restarts`). The JAX version's compiled-core cache,
`host_loop` and buffer donation are JAX machinery; here one Python loop
drives the iterations eagerly. What changes results is kept as it is:

- the static checkpoint schedule (`_checkpoint_schedule`), so halving
  (l-inf, l2) and the sparsity adaptation (l1) happen at the same
  iterations;
- the wrap-around of `_oscillation_count` at the first checkpoint (the
  reference's torch negative-index read of a still-zero row);
- strictly-greater best tracking;
- the forward-only final iteration (`skip_last_grad`): its gradient is
  never read, so its backward is skipped;
- warm starts (`x_init`), random starts (`use_rs`) and EOT averaging
  (`eot_iter`, `model_rng_fn`).

The pixel gradient comes from `torch.autograd.grad` with respect to the
iterate only; `CLIP` freezes its weights (`requires_grad_(False)`), so
autograd computes no weight gradients. The l-inf update is
`fused_linf_apgd_step` (the CUDA kernel for CUDA tensors); the l2 and l1
updates are plain tensor code, as they are plain XLA in JAX.

Random draws come from a `torch.Generator` seeded with an integer. Where
the JAX package folds integers into a PRNG key (`jax.random.fold_in`), the
port folds the same integers into the seed with `fold_in`; the two
frameworks give different random numbers from the same seed.

Under a profiler window (`utils/profiling.span`) a call is an
`apgd.attack` span; its first evaluation's `apgd.forward` and
`apgd.backward` sit directly under it, and each iteration is an
`apgd.iter` whose children are `apgd.update` (the step, then the best
tracking and checkpoint), `apgd.forward` (model and criterion) and
`apgd.backward` (the pixel gradient).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from robustvlm_tpu_torch.attacks._validate import check_image_range
from robustvlm_tpu_torch.ops.kernels.attack_step import fused_linf_apgd_step, jnp_sign
from robustvlm_tpu_torch.ops.projections import (
    canonical_norm,
    l0_norm,
    l1_ball_projection,
    l2_norm,
    lp_normalize,
)
from robustvlm_tpu_torch.utils.profiling import span

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


def generator(seed: int, device) -> torch.Generator:
    """A `torch.Generator` on `device` seeded with the integer `seed`."""
    return torch.Generator(device=device).manual_seed(int(seed))


def _checkpoint_schedule(n_iter: int, norm: str):
    """(is_ckpt[n_iter] bool, window[n_iter] int32): the counter3/k
    bookkeeping unrolled; window is the oscillation-check span in effect at
    each checkpoint (before its decrement). For l1 the span never decays."""
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


def _random_init(seed: int, x: torch.Tensor, eps: float, norm: str = "linf") -> torch.Tensor:
    """The canonical random start: l-inf x + eps * t/||t||_inf with t ~
    U(-1, 1); l2 x + eps * t/||t||_2 with t ~ N(0, 1); l1 t ~ N(0, 1)
    projected onto the l1 ball and the [0,1] box."""
    gen = generator(seed, x.device)
    if norm == "linf":
        t = 2.0 * torch.rand(x.shape, generator=gen, device=x.device, dtype=x.dtype) - 1.0
        return x + eps * lp_normalize(t, "linf")
    t = torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype)
    if norm == "l2":
        return x + eps * lp_normalize(t, "l2")
    return x + t + l1_ball_projection(x, t, eps)


def _expand(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) -> broadcastable over the image dims of `like`."""
    return v.reshape(-1, *([1] * (like.dim() - 1)))


def step_l2(x_adv, x_adv_old, grad, x, step_size, eps: float, a: float) -> torch.Tensor:
    """The l2 iterate update: a normalized gradient step projected onto the
    eps ball and the box, the momentum blend, and the projection again."""
    z = x_adv + _expand(step_size, x) * lp_normalize(grad, "l2")
    d = z - x
    z = torch.clamp(x + lp_normalize(d, "l2") * torch.clamp(l2_norm(d, keepdims=True), max=eps), 0.0, 1.0)
    z = x_adv + (z - x_adv) * a + (x_adv - x_adv_old) * (1.0 - a)
    d = z - x
    return torch.clamp(x + lp_normalize(d, "l2") * torch.clamp(l2_norm(d, keepdims=True), max=eps), 0.0, 1.0)


def step_l1(x_adv, grad, x, step_size, topk, eps: float) -> torch.Tensor:
    """The l1 iterate update (no momentum, as in the reference): the signs of
    the gradient's top `topk` share of entries by magnitude, spread evenly,
    then projected onto the l1 ball and the box."""
    b = x.shape[0]
    n_fts = math.prod(x.shape[1:])
    gsort = torch.sort(grad.reshape(b, -1).abs(), dim=-1).values  # ascending
    topk_curr = torch.clamp(((1.0 - topk) * n_fts).to(torch.int32), 0, n_fts - 1)
    thr = _expand(gsort.gather(1, topk_curr.to(torch.int64)[:, None])[:, 0], x)
    sparse = grad * (grad.abs() >= thr).to(grad.dtype)
    ssign = jnp_sign(sparse)
    denom = ssign.reshape(b, -1).abs().sum(dim=-1) + 1e-10
    z = x_adv + _expand(step_size, x) * ssign / _expand(denom, x)
    delta_u = z - x
    return x + delta_u + l1_ball_projection(x, delta_u, eps)


def eot_loss_grad(model_fn, criterion, xa, y, criterion_args=(), *, eot_iter: int = 1,
                  model_rng_fn: Optional[Callable] = None, seed: int = 0):
    """(per-example loss, pixel gradient, logits) at `xa`.

    Without `model_rng_fn` one forward and backward of `model_fn`. With it,
    the randomized model `model_rng_fn(x, seed)` (an integer seed: draw with
    `generator(seed, x.device)`) is called with `seed` when `eot_iter <= 1`,
    else `eot_iter` times with `fold_in(seed, j)`, and the losses and
    gradients are averaged (the logits are the last draw's)."""
    def one(s):
        xg = xa.detach().requires_grad_(True)
        with torch.enable_grad():
            with span("apgd.forward"):
                out = model_fn(xg) if model_rng_fn is None else model_rng_fn(xg, s)
                li = criterion(out, y, *criterion_args)
            with span("apgd.backward"):
                (g,) = torch.autograd.grad(li.sum(), xg)
        return li.detach(), g, out.detach()

    if eot_iter <= 1 or model_rng_fn is None:
        return one(seed)
    g_sum = torch.zeros_like(xa)
    l_sum = torch.zeros((xa.shape[0],), dtype=torch.float32, device=xa.device)
    for j in range(eot_iter):
        li, g, out = one(fold_in(seed, j))
        g_sum = g_sum + g
        l_sum = l_sum + li
    return l_sum / eot_iter, g_sum / eot_iter, out


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
    topk_init: Optional[float] = None,
    use_fused_kernel: bool = True,
    eot_iter: int = 1,
    model_rng_fn: Optional[Callable] = None,
    host_loop: bool = False,
    criterion_args: tuple = (),
    skip_last_grad: Optional[bool] = None,
) -> APGDResult:
    """Run APGD, maximizing `criterion(model_fn(x_adv), y, *criterion_args)`.

    model_fn maps [0,1] pixels to logits (normalization inside). y (B,)
    enables accuracy tracking; None makes x_best_adv track the last
    iterate. norm is linf, l2 or l1. alpha is the initial step multiplier
    (step = alpha * eps; default 2.0, 1.0 for l1); initial_stepsize
    (absolute) overrides it. use_rs draws a random start from the integer
    seed `rng`; x_init is an explicit warm start; mask multiplies the
    gradient. topk_init is l1's initial sparsity (default 0.2).
    use_fused_kernel is accepted for the JAX signature: the l-inf update
    launches its kernel on a CUDA tensor and runs the plain version on the
    CPU, and False on a CUDA tensor raises. eot_iter and model_rng_fn average the loss
    gradient over draws of a randomized model (`eot_loss_grad`); the draws
    of iteration i use seed `fold_in(rng, i)` (rng or 0), the first
    evaluation `rng` itself. host_loop is a JAX compile option, accepted and
    ignored. skip_last_grad (None: on for deterministic models) skips the
    final iteration's backward.
    """
    norm = canonical_norm(norm)
    if norm not in ("linf", "l2", "l1"):
        raise ValueError(f"apgd: unsupported norm {norm}")
    del host_loop
    if not use_fused_kernel and x.is_cuda:
        raise ValueError("apgd: the l-inf step always launches its kernel on a CUDA tensor; "
                         "use_fused_kernel=False is for the CPU only")
    check_image_range(x)
    b = x.shape[0]
    n_fts = math.prod(x.shape[1:])
    track_acc = y is not None
    if alpha is None:
        alpha = 2.0 if norm in ("linf", "l2") else 1.0
    if initial_stepsize is not None:
        alpha = initial_stepsize / eps

    if use_rs and x_init is None and rng is None:
        raise ValueError("use_rs=True requires rng")

    deterministic = eot_iter <= 1 and model_rng_fn is None
    skip_last_grad = deterministic if skip_last_grad is None else (skip_last_grad and deterministic)
    eot_seed = 0 if rng is None else rng

    def expand(v):
        return _expand(v, x)

    def predictions(out):
        if track_acc:
            return out.argmax(dim=-1) == y
        return torch.zeros((b,), dtype=torch.bool, device=x.device)

    def eval_point(xa, it=None):
        seed = eot_seed if it is None else fold_in(eot_seed, it)
        li, grad, out = eot_loss_grad(model_fn, criterion, xa, y, criterion_args, eot_iter=eot_iter,
                                      model_rng_fn=model_rng_fn, seed=seed)
        if mask is not None:
            grad = grad * mask
        return li, grad, predictions(out)

    def fwd_only_eval(xa):
        with span("apgd.forward"):
            out = model_fn(xa)
            li = criterion(out, y, *criterion_args)
        return li, torch.zeros_like(xa), predictions(out)

    if norm == "l1" and topk_init is None:
        topk_init = 0.2
    is_ckpt, window = _checkpoint_schedule(n_iter, norm)
    with span("apgd.attack"), torch.no_grad():
        if x_init is not None:
            x_adv = x_init
        elif use_rs:
            x_adv = _random_init(rng, x, eps, norm)
        else:
            x_adv = x
        x_adv = x_adv.detach().clamp(0.0, 1.0)
        loss, grad, correct = eval_point(x_adv)
        x_adv_old = x_adv
        grad_best = grad
        x_best = x_best_adv = x_adv
        loss_best = loss_best_last_check = loss
        reduced_last_check = torch.ones((b,), dtype=x.dtype, device=x.device)
        step_size = torch.full((b,), alpha * eps, dtype=x.dtype, device=x.device)
        acc = correct
        hist = torch.zeros((n_iter, b), dtype=torch.float32, device=x.device)
        if norm == "l1":
            if x_init is None:
                topk = torch.full((b,), topk_init, dtype=x.dtype, device=x.device)
                sp_old = torch.full((b,), float(n_fts), dtype=x.dtype, device=x.device)
            else:
                sp0 = l0_norm(x_adv - x)
                topk = (sp0 / n_fts / 1.5).to(x.dtype)
                sp_old = sp0.to(x.dtype)

        for i in range(n_iter):
            with span("apgd.iter"):
                with span("apgd.update"):
                    a = 0.75 if i > 0 else 1.0
                    if norm == "linf":
                        x_new = fused_linf_apgd_step(x_adv, x_adv_old, grad, x, step_size, eps, a)
                    elif norm == "l2":
                        x_new = step_l2(x_adv, x_adv_old, grad, x, step_size, eps, a)
                    else:
                        x_new = step_l1(x_adv, grad, x, step_size, topk, eps)
                    x_adv_old, x_adv = x_adv, x_new
                if skip_last_grad and i == n_iter - 1:
                    loss, grad, pred_correct = fwd_only_eval(x_adv)
                else:
                    loss, grad, pred_correct = eval_point(x_adv, i)
                with span("apgd.update"):
                    if track_acc:
                        acc = acc & pred_correct
                    x_best_adv = torch.where(expand(~pred_correct), x_adv, x_best_adv)

                    # best tracking, strictly greater
                    improved = loss > loss_best
                    x_best = torch.where(expand(improved), x_adv, x_best)
                    grad_best = torch.where(expand(improved), grad, grad_best)
                    loss_best = torch.where(improved, loss, loss_best)
                    hist[i] = loss.to(torch.float32)

                    if not is_ckpt[i]:
                        continue
                    if norm in ("linf", "l2"):  # oscillation check at the static checkpoints
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
                    else:  # l1 sparsity adaptation
                        sp_curr = l0_norm(x_best - x).to(x.dtype)
                        fl_red = (sp_curr / sp_old) < 0.95
                        step_up = torch.full_like(step_size, alpha * eps)
                        step_size = torch.clamp(torch.where(fl_red, step_up, step_size / 1.5),
                                                alpha * eps / 10.0, alpha * eps)
                        topk = sp_curr / n_fts / 1.5
                        sp_old = sp_curr
                        x_adv = torch.where(expand(fl_red), x_best, x_adv)
                        grad = torch.where(expand(fl_red), grad_best, grad)

    return APGDResult(x_best=x_best, x_best_adv=x_best_adv, loss_best=loss_best, acc=acc)


def decr_eps_schedule(eps: float, n_iter: int):
    """The stages of `apgd_decr_eps`: radii 3, 2 and 1 times eps for
    ceil(.3 n), ceil(.3 n) and the remaining iterations."""
    iters = [math.ceil(0.3 * n_iter), math.ceil(0.3 * n_iter)]
    iters.append(n_iter - sum(iters))
    return [3.0 * eps, 2.0 * eps, 1.0 * eps], iters


def apgd_decr_eps(
    model_fn,
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    *,
    criterion,
    eps: float,
    n_iter: int = 100,
    norm: str = "linf",
    rng: Optional[int] = None,
    **kwargs,
) -> APGDResult:
    """Multi-epsilon APGD: the attack at 3 eps, 2 eps and eps for 0.3, 0.3
    and 0.4 of n_iter, each stage warm-started from the previous stage's
    best point projected into its ball (l1: `l1_ball_projection`; l-inf:
    the [0,1] box, then the ball). The first stage starts from x plus
    N(0, 1) noise drawn from the seed `rng`. AutoAttack's default for l1."""
    norm = canonical_norm(norm)
    if norm not in ("linf", "l1"):
        raise ValueError(f"decr_eps_pgd supports linf/l1, got {norm}")
    rng = 0 if rng is None else rng
    kwargs.pop("use_rs", None)  # stages are explicitly warm-started
    kwargs.pop("x_init", None)

    epss, iters = decr_eps_schedule(eps, n_iter)
    gen = generator(rng, x.device)
    x_init = x + torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype)
    res = None
    for i, (e, ni) in enumerate(zip(epss, iters)):
        if norm == "l1":
            x_init = x_init + l1_ball_projection(x, x_init - x, e)
        else:
            x_init = torch.clamp(x_init, 0.0, 1.0)
            x_init = torch.minimum(torch.maximum(x_init, x - e), x + e)
        res = apgd_attack(
            model_fn, x, y, criterion=criterion, eps=e, n_iter=ni, norm=norm,
            x_init=x_init, rng=fold_in(rng, i), **kwargs,
        )
        x_init = res.x_best
    return res


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
    """n_restarts independent APGD runs, each through the decr-eps schedule
    when use_largereps. Per example, x_best_adv keeps the FIRST successful
    adversarial across restarts; x_best/loss_best track the highest-loss
    point."""
    rng = 0 if rng is None else rng
    ndim1 = (-1,) + (1,) * (x.dim() - 1)
    acc = None
    x_adv = x
    x_best = x
    loss_best = torch.full((x.shape[0],), -math.inf, dtype=torch.float32, device=x.device)
    for r in range(max(n_restarts, 1)):
        kr = fold_in(rng, r)
        if use_largereps:
            res = apgd_decr_eps(model_fn, x, y, criterion=criterion, eps=eps, n_iter=n_iter,
                                norm=norm, rng=kr, **kwargs)
        else:
            res = apgd_attack(model_fn, x, y, criterion=criterion, eps=eps, n_iter=n_iter,
                              norm=norm, use_rs=use_rs, rng=kr, **kwargs)
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
