"""FARE fine-tuning's outer step as plain PyTorch (Schlarmann et al. 2024,
"Robust CLIP": the unsupervised l2 loss between the adversarial image's
embedding and the frozen original's clean embedding), with AdamW
(Loshchilov and Hutter; decoupled decay) at open_clip's cosine schedule
with linear warm-up, in float32 or the fp8 control.

`follow` runs the reference's own weights through the program's first
steps at the program's adversarial images (the inner attack's result is
the program's; its strength and ball are checked apart, by `inner_gain`):
per step the loss, and the gradients and weights it needs. Gradients are
taken in blocks of rows and summed, which is the batch mean's gradient.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from reference import clip as C

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def lr_at(base: float, warmup: int, total: int, count: int) -> float:
    """open_clip's cosine_lr at update `count` (0 first), in float32."""
    f = np.float32
    s = f(count)
    if s < f(warmup):
        return float(f(base) * (s + f(1.0)) / f(max(warmup, 1)))
    prog = (s - f(warmup)) / f(max(total - warmup, 1))
    return float(f(0.5) * (f(1.0) + np.cos(f(np.pi) * prog)) * f(base))


def embed(w, cfg, x, precision, normalize=False):
    return C.embed(w, "visual.", cfg, x, precision, normalize=normalize)


def outer_loss_and_grads(w: Dict[str, torch.Tensor], cfg, x, x_adv, emb_orig, precision: str,
                         rows: int = 32):
    """The batch-mean l2 loss of embed(x_adv) against emb_orig, and its
    gradient into every tensor of `w` (zero where none flows)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in w.items()}
    grads = {k: torch.zeros_like(v) for k, v in w.items()}
    total = 0.0
    b = x.shape[0]
    for s in range(0, b, rows):
        with torch.enable_grad():
            e = embed(leaves, cfg, x_adv[s:s + rows], precision)
            part = (e - emb_orig[s:s + rows]).square().sum(dim=-1).sum() / b
            names = [k for k in leaves if k.startswith("visual.")]
            gs = torch.autograd.grad(part, [leaves[k] for k in names], allow_unused=True)
        for k, g in zip(names, gs):
            if g is not None:
                grads[k] += g
        total += float(part.detach())
    return total, grads


def adamw_(w, m, v, grads, lr: float, wd: float, t: int) -> None:
    """torch.optim.AdamW's update, in place: decay, moments, bias-corrected step."""
    b1, b2 = BETAS
    for k in w:
        g = grads[k]
        w[k].mul_(1.0 - lr * wd)
        m[k].mul_(b1).add_(g, alpha=1.0 - b1)
        v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (v[k].sqrt() / np.sqrt(1.0 - b2 ** t)).add_(ADAM_EPS)
        w[k].addcdiv_(m[k], denom, value=-lr / (1.0 - b1 ** t))


def follow(w0: Dict[str, torch.Tensor], cfg, train: dict, xs: List[torch.Tensor],
           x_advs: List[torch.Tensor], precision: str) -> dict:
    """The reference's steps at the program's adversarial images: per step
    the loss; the first step's gradient; the change of the weights after
    the last step (both by leaf)."""
    w = {k: v.detach().clone().float() for k, v in w0.items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v = {k: torch.zeros_like(t) for k, t in w.items()}
    losses, g1 = [], None
    for t, (x, xa) in enumerate(zip(xs, x_advs), start=1):
        with torch.no_grad():
            emb_orig = torch.cat([embed(w0, cfg, x[s:s + 32], precision) for s in range(0, x.shape[0], 32)])
        loss, grads = outer_loss_and_grads(w, cfg, x, xa, emb_orig, precision)
        losses.append(loss)
        if g1 is None:
            g1 = grads
        lr = lr_at(train["lr"], train["warmup"], train["steps"], t - 1)
        with torch.no_grad():
            adamw_(w, m, v, grads, lr, train["wd"], t)
    change = {k: w[k] - w0[k].float() for k in w}
    return {"losses": losses, "grads": g1, "change": change}


def inner_gain(w0, cfg, x, x_adv, rows: int = 32) -> float:
    """The inner loss's rise from the clean image to x_adv, batch mean: the
    l2 distance of the normalized embedding at x_adv from the frozen clean
    embedding, less the same at x."""
    total = 0.0
    with torch.no_grad():
        for s in range(0, x.shape[0], rows):
            e0 = embed(w0, cfg, x[s:s + rows], "float32")
            ea = embed(w0, cfg, x_adv[s:s + rows], "float32", normalize=True)
            ec = embed(w0, cfg, x[s:s + rows], "float32", normalize=True)
            total += float(((ea - e0).square().sum(-1) - (ec - e0).square().sum(-1)).sum())
    return total / x.shape[0]
