"""Linear probe: frozen image features and a logistic-regression head.

Counterpart of `robustvlm_tpu/benchmark/linear_probe.py`: features of the
frozen encoder (optionally cached to `.npz`), then AdamW (optax's adamw:
betas 0.9, 0.999, eps 1e-8, decay on every parameter) on softmax cross
entropy at `cosine_warmup_lr(lr, min(total // 20, 100), total)`, over the
same minibatches in the same order (`np.random.RandomState(seed)`
permutations, one an epoch). The optimizer is the trainer's
`ScheduledOptimizer`, the schedule `train/schedules.py`'s. `device` is
`cuda` unless `cpu` is asked for (`device.resolve_device`).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from robustvlm_tpu_torch.device import resolve_device
from robustvlm_tpu_torch.train.trainer import ScheduledOptimizer, TrainConfig


def extract_features(
    embed_fn: Callable[[torch.Tensor], torch.Tensor],
    data: Iterable[Tuple[np.ndarray, np.ndarray]],
    cache_path: Optional[str] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run the frozen encoder over a dataset; with `cache_path`, read the
    features from that `.npz` if it is there and write them to it if not."""
    device = resolve_device(device)
    if cache_path:
        try:
            z = np.load(cache_path)
            return z["features"], z["labels"]
        except (FileNotFoundError, OSError):
            pass
    feats, labels = [], []
    with torch.no_grad():
        for xb, yb in data:
            feats.append(embed_fn(torch.as_tensor(xb).to(device)).float().cpu().numpy())
            labels.append(np.asarray(yb))
    f, y = np.concatenate(feats), np.concatenate(labels)
    if cache_path:
        np.savez(cache_path, features=f, labels=y)
    return f, y


def train_linear_probe(
    features: np.ndarray,
    labels: np.ndarray,
    n_classes: int,
    *,
    lr: float = 0.1,
    epochs: int = 10,
    batch_size: int = 256,
    wd: float = 0.0,
    seed: int = 0,
    device=None,
) -> Dict[str, torch.Tensor]:
    """AdamW logistic regression on (N, D) features; returns {'w', 'b'}
    (w is (D, C), as `features @ w + b`)."""
    device = resolve_device(device)
    n, d = features.shape
    steps_per_epoch = max(n // batch_size, 1)
    total = epochs * steps_per_epoch
    w = torch.zeros((d, n_classes), dtype=torch.float32, device=device, requires_grad=True)
    b = torch.zeros((n_classes,), dtype=torch.float32, device=device, requires_grad=True)
    cfg = TrainConfig(opt="adamw", lr=lr, wd=wd, warmup=min(total // 20, 100), steps=total)
    opt = ScheduledOptimizer(cfg, [w, b])
    rng = np.random.RandomState(seed)
    f = torch.as_tensor(features, dtype=torch.float32).to(device)
    y = torch.as_tensor(labels).long().to(device)
    for _ in range(epochs):
        order = rng.permutation(n)
        for step in range(steps_per_epoch):
            idx = torch.as_tensor(order[step * batch_size: (step + 1) * batch_size]).to(device)
            opt.zero_grad()
            F.cross_entropy(f[idx] @ w + b, y[idx]).backward()
            opt.step()
    return {"w": w.detach(), "b": b.detach()}


def evaluate_linear_probe(
    embed_fn: Callable,
    train_data,
    test_data,
    n_classes: int,
    *,
    cache_dir: Optional[str] = None,
    device=None,
    **train_kw,
) -> Dict[str, float]:
    device = resolve_device(device)
    f_tr, y_tr = extract_features(
        embed_fn, train_data, cache_path=f"{cache_dir}/train.npz" if cache_dir else None, device=device)
    f_te, y_te = extract_features(
        embed_fn, test_data, cache_path=f"{cache_dir}/test.npz" if cache_dir else None, device=device)
    probe = train_linear_probe(f_tr, y_tr, n_classes, device=device, **train_kw)
    with torch.no_grad():
        logits = (torch.as_tensor(f_te).to(device) @ probe["w"] + probe["b"]).cpu().numpy()
    return {"lp_acc1": float((logits.argmax(-1) == y_te).mean())}
