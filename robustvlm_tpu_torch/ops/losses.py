"""Attack losses: cross-entropy and the (targeted) DLR losses.

Counterpart of `robustvlm_tpu/ops/losses.py` (`ce_loss`, `dlr_loss`,
`dlr_loss_targeted`); the DLR losses read the top-4 logits only.
"""

from __future__ import annotations

import torch

_EPS_DIV = 1e-12


def _reduce(loss_vec: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return loss_vec
    if reduction == "mean":
        return loss_vec.mean()
    if reduction == "sum":
        return loss_vec.sum()
    raise ValueError(f"unknown reduction: {reduction}")


def ce_loss(logits: torch.Tensor, targets: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """Cross-entropy on integer targets."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[:, None].long())[:, 0]
    return _reduce(nll, reduction)


def _top4_and_gather(logits: torch.Tensor, *idx: torch.Tensor):
    topv, topi = torch.topk(logits, 4, dim=-1)  # descending: topv[:, 0] is the max
    gathered = [torch.gather(logits, -1, i[:, None].long())[:, 0] for i in idx]
    return topv, topi, gathered


def dlr_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """-(z_y - z_(1)*1[argmax==y] - z_(0)*1[argmax!=y]) / (z_(0) - z_(2) + 1e-12),
    z_(k) the (k+1)-th largest logit."""
    topv, topi, (z_y,) = _top4_and_gather(logits, y)
    is_correct = (topi[:, 0] == y).to(logits.dtype)
    num = z_y - topv[:, 1] * is_correct - topv[:, 0] * (1.0 - is_correct)
    den = topv[:, 0] - topv[:, 2] + _EPS_DIV
    return -num / den


def dlr_loss_targeted(logits: torch.Tensor, y: torch.Tensor, y_target: torch.Tensor) -> torch.Tensor:
    """-(z_y - z_t) / (z_(0) - 0.5*(z_(2) + z_(3)) + 1e-12)."""
    topv, _, (z_y, z_t) = _top4_and_gather(logits, y, y_target)
    den = topv[:, 0] - 0.5 * (topv[:, 2] + topv[:, 3]) + _EPS_DIV
    return -(z_y - z_t) / den
