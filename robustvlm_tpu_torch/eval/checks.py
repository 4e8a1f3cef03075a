"""Defense sanity checks run before an AutoAttack evaluation.

Counterpart of `robustvlm_tpu/eval/checks.py`: randomized defenses (two
identical forwards disagreeing), probabilities returned instead of logits,
zero gradients, the class count against targeted attacks, Square beating
the white-box attacks, and dynamic defenses.
"""

from __future__ import annotations

import logging
import sys

import torch

from robustvlm_tpu_torch.ops.losses import dlr_loss

log = logging.getLogger("robustvlm_tpu_torch.autoattack")


def check_randomized(logits_fn, x, atol: float = 1e-6) -> bool:
    with torch.no_grad():
        a = logits_fn(x)
        b = logits_fn(x)
    randomized = not bool(torch.allclose(a, b, atol=atol))
    if randomized:
        log.warning(
            "Model output differs across identical calls — randomized defense? "
            "Use rand-version attacks (EOT)."
        )
    return randomized


def check_range_output(logits_fn, x) -> int:
    with torch.no_grad():
        out = logits_fn(x)
    n_cls = out.shape[-1]
    looks_softmax = bool(
        (out >= 0.0).all()
        and (out <= 1.0).all()
        and torch.allclose(out.sum(dim=-1), torch.ones_like(out[:, 0]), atol=1e-4)
    )
    if looks_softmax:
        log.warning(
            "Output rows lie in [0,1] and sum to 1 — the model seems to return "
            "probabilities, not logits; attacks expect logits."
        )
    return n_cls


def check_zero_gradients(grad: torch.Tensor) -> bool:
    flat = grad.reshape(grad.shape[0], -1)
    n_zero = int((flat.abs().sum(dim=-1) == 0.0).sum())
    if n_zero > 0:
        log.warning(
            "%d of %d examples have exactly zero gradient — possible gradient "
            "masking; consider different losses/attacks.",
            n_zero, flat.shape[0],
        )
    return n_zero > 0


def check_zero_gradients_fn(logits_fn, x: torch.Tensor, y: torch.Tensor) -> bool:
    """`check_zero_gradients` of the summed DLR loss's gradient with respect
    to x (JAX's `jax.grad` of the same sum)."""
    xa = x.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(dlr_loss(logits_fn(xa), y).sum(), xa)
    return check_zero_gradients(g)


def check_n_classes(n_cls: int, attacks_to_run, n_target_classes: int) -> None:
    # targeted attacks index order[:, -tc] for tc in 2..n_target_classes+1,
    # so n_cls == n_target_classes + 1 is exactly sufficient
    if any(a in attacks_to_run for a in ("apgd-t", "fab-t")):
        if n_cls < n_target_classes + 1:
            log.warning(
                "%d classes < n_target_classes+1=%d — targeted attacks will "
                "cycle through fewer targets.",
                n_cls, n_target_classes + 1,
            )


def check_square_sr(robust_accuracy_dict: dict) -> None:
    """Flag when the black-box Square attack outperforms the white-box
    cascade (a gradient-masking symptom)."""
    if "square" not in robust_accuracy_dict:
        return
    others = [v for k, v in robust_accuracy_dict.items() if k not in ("clean", "square")]
    if others and robust_accuracy_dict["square"] < min(others) - 0.0001:
        log.warning(
            "Square attack is stronger than the white-box attacks — possible "
            "gradient masking."
        )


def _python_calls(logits_fn, x) -> int:
    n = [0]

    def tracer(frame, event, arg):
        if event == "call":
            n[0] += 1
        return None

    old = sys.gettrace()
    sys.settrace(tracer)
    try:
        with torch.no_grad():
            out = logits_fn(x)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    finally:
        sys.settrace(old)
    return n[0]


def check_dynamic(logits_fn, x, verbose: bool = True) -> bool:
    """Detect dynamic defenses: models whose host-side work grows across
    identical inference calls (the reference counts Python function calls
    with sys.settrace).

    An eager PyTorch model repeats the same Python work on every call, so
    the absolute count says nothing; the JAX version's test (a second call
    nearly free of Python calls under a jit cache) would flag every eager
    model. Here the second count must clearly exceed the first: a static
    model gives equal counts (or a smaller second one, when the first call
    did one-time set-up such as loading a kernel)."""
    counts = [_python_calls(logits_fn, x) for _ in range(2)]
    dynamic = counts[1] > 1.1 * counts[0] + 100
    if dynamic and verbose:
        log.warning(
            "the model's host work grows across identical calls (%d -> %d "
            "python calls); attacks may be evaluated against a dynamic defense",
            counts[0], counts[1],
        )
    return dynamic
