"""Zero-shot classification, clean and under AutoAttack.

Counterpart of `robustvlm_tpu/benchmark/zeroshot.py`: the template-ensemble
classifier, top-k accuracy, mean per-class recall, multilabel macro mAP,
and `run_classification`, which runs the clean pass at `batch_size` and,
with `attack="aa"`, the port's `AutoAttack` (APGD-CE then APGD-T) over the
accumulated samples at `attack_batch` a chunk, then the adversarial
metrics. Data stays numpy on the host; each batch goes to the logits
module's device.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from robustvlm_tpu_torch.eval.autoattack import AutoAttack
from robustvlm_tpu_torch.eval.classifier import build_text_classifier


def zero_shot_classifier(
    model,
    tokenize: Callable[[Sequence[str]], torch.Tensor],
    classnames: Sequence[str],
    templates: Sequence[str],
) -> torch.Tensor:
    """(D, C) column-normalized template-ensemble classifier."""
    return build_text_classifier(model, tokenize, classnames, templates=templates)


def accuracy_topk(logits: np.ndarray, target: np.ndarray,
                  topk: Sequence[int] = (1, 5)) -> Tuple[float, ...]:
    order = np.argsort(-logits, axis=-1)
    return tuple(
        float(np.mean((order[:, :k] == target[:, None]).any(axis=1)))
        for k in topk
    )


def mean_per_class_recall(logits: np.ndarray, target: np.ndarray) -> float:
    pred = logits.argmax(-1)
    recalls = []
    for c in np.unique(target):
        m = target == c
        recalls.append(float((pred[m] == c).mean()))
    return float(np.mean(recalls))


def multilabel_average_precision(scores: np.ndarray, target: np.ndarray) -> float:
    """Macro mAP over classes; target is an (N, C) multi-hot matrix."""
    aps = []
    for c in range(scores.shape[1]):
        y = target[:, c]
        if y.sum() == 0:
            continue
        order = np.argsort(-scores[:, c])
        y_sorted = y[order]
        cum_pos = np.cumsum(y_sorted)
        precision = cum_pos / (np.arange(len(y_sorted)) + 1)
        aps.append(float((precision * y_sorted).sum() / y_sorted.sum()))
    return float(np.mean(aps)) if aps else 0.0


def _device_of(logits_fn) -> torch.device:
    """A module's device (of its first buffer or parameter); the CPU for a
    plain function."""
    if isinstance(logits_fn, torch.nn.Module):
        for t in itertools.chain(logits_fn.buffers(), logits_fn.parameters()):
            return t.device
    return torch.device("cpu")


@torch.no_grad()
def _logits(logits_fn, x: np.ndarray, device) -> np.ndarray:
    return logits_fn(torch.as_tensor(x).to(device)).float().cpu().numpy()


def run_classification(
    logits_fn,
    data: Iterable[Tuple[np.ndarray, np.ndarray]],
    *,
    attack: Optional[str] = None,
    eps: float = 4.0 / 255.0,
    norm: str = "linf",
    n_iter: int = 100,
    n_samples: Optional[int] = None,
    batch_size: int = 128,
    attack_batch: int = 8,
    verbose: bool = False,
    device=None,
) -> Dict[str, float]:
    """Evaluate a pixel-space logits module over a dataset iterator.

    attack=None: the clean pass. attack='aa': the samples (up to n_samples)
    are kept and attacked by APGD-CE and APGD-T; the clean metrics are
    reported too. `device` defaults to the module's."""
    device = _device_of(logits_fn) if device is None else torch.device(device)
    xs, ys, logits_clean = [], [], []
    seen = 0
    for xb, yb in data:
        if attack is not None and np.asarray(yb).ndim == 2:
            # on the first batch, not after the clean pass
            raise NotImplementedError("adversarial evaluation of multilabel datasets is not "
                                      "supported (the reference cascade needs int labels)")
        if n_samples is not None and seen >= n_samples:
            break
        if n_samples is not None:
            keep = min(len(xb), n_samples - seen)
            xb, yb = xb[:keep], yb[:keep]
        seen += len(xb)
        logits_clean.append(_logits(logits_fn, xb, device))
        if attack is not None:
            xs.append(np.asarray(xb))
        ys.append(np.asarray(yb))

    logits_clean = np.concatenate(logits_clean)
    y = np.concatenate(ys)
    if y.ndim == 2:
        # (N, C) multi-hot labels: macro mAP is the metric
        return {"mean_average_precision": multilabel_average_precision(logits_clean, y)}
    acc1, acc5 = accuracy_topk(logits_clean, y)
    metrics = {
        "acc1": acc1,
        "acc5": acc5,
        "mean_per_class_recall": mean_per_class_recall(logits_clean, y),
    }

    if attack == "aa":
        aa = AutoAttack(logits_fn, eps=eps, norm=norm, n_iter=n_iter,
                        attacks_to_run=["apgd-ce", "apgd-t"], verbose=verbose, device=device)
        x_adv = aa.run_standard_evaluation(np.concatenate(xs), y, bs=attack_batch).numpy()
        logits_adv = np.concatenate([
            _logits(logits_fn, x_adv[i: i + batch_size], device)
            for i in range(0, len(x_adv), batch_size)
        ])
        r1, r5 = accuracy_topk(logits_adv, y)
        metrics.update({
            "adv_acc1": r1,
            "adv_acc5": r5,
            "adv_mean_per_class_recall": mean_per_class_recall(logits_adv, y),
        })
    elif attack is not None:
        raise ValueError(f"unknown attack mode: {attack}")
    return metrics


def evaluate(
    model,
    tokenize,
    classnames: Sequence[str],
    templates: Sequence[str],
    data,
    *,
    make_logits_fn,
    attack: Optional[str] = None,
    **kw,
) -> Dict[str, float]:
    """End to end: the template-ensemble classifier, wrapped as a pixel-space
    logits module by `make_logits_fn`, then `run_classification`."""
    classifier = zero_shot_classifier(model, tokenize, classnames, templates)
    return run_classification(make_logits_fn(classifier), data, attack=attack, **kw)
