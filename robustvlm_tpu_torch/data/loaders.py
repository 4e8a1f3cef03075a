"""Host-side evaluation data: the image transform, synthetic images and
CIFAR-10.

Counterpart of `default_image_transform` (its PIL path; the native C++
pipeline comes with training, ROADMAP A7), `SyntheticClassificationDataset`
and `load_cifar10` in `robustvlm_tpu/data/loaders.py`. Images are float32
NCHW in [0,1], without CLIP normalization (normalization happens inside the
model).
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Optional

import numpy as np


def default_image_transform(size: int = 224):
    """Resize(size, bicubic) + CenterCrop(size) + [0,1] float CHW: the
    reference preprocessing minus Normalize, through PIL."""
    from PIL import Image

    def tf(img) -> np.ndarray:
        if img.mode != "RGB":
            img = img.convert("RGB")
        w, h = img.size
        short = min(w, h)
        nw, nh = round(w * size / short), round(h * size / short)
        img = img.resize((nw, nh), Image.BICUBIC)
        left, top = (nw - size) // 2, (nh - size) // 2
        img = img.crop((left, top, left + size, top + size))
        return (np.asarray(img, np.float32) / 255.0).transpose(2, 0, 1)

    return tf


class SyntheticClassificationDataset:
    """Deterministic random images/labels, for tests and benches; item i is
    the same as the JAX package's."""

    def __init__(self, n: int = 512, n_classes: int = 1000, size: int = 224, seed: int = 0):
        self.n, self.n_classes, self.size, self.seed = n, n_classes, size, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed * 1_000_003 + i)
        x = rng.rand(3, self.size, self.size).astype(np.float32)
        return x, int(rng.randint(self.n_classes))

    def arrays(self, n: Optional[int] = None):
        """The first n items stacked: (x (n,3,S,S) float32, y (n,) int64)."""
        n = self.n if n is None else min(n, self.n)
        items = [self[i] for i in range(n)]
        return (np.stack([it[0] for it in items]),
                np.asarray([it[1] for it in items], np.int64))


def load_cifar10(root: str, train: bool = False, n_examples: Optional[int] = None):
    """CIFAR-10 python batches from disk -> (x NCHW [0,1], y), native 32x32
    (the resize to the model's size happens in-model)."""
    d = Path(root)
    base = d / "cifar-10-batches-py"
    if base.exists():
        d = base
    files = [d / f"data_batch_{i}" for i in range(1, 6)] if train else [d / "test_batch"]
    xs, ys = [], []
    for f in files:
        with open(f, "rb") as fh:
            batch = pickle.load(fh, encoding="bytes")
        xs.append(batch[b"data"])
        ys.extend(batch[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).astype(np.float32) / 255.0
    y = np.asarray(ys, np.int64)
    if n_examples is not None:
        x, y = x[:n_examples], y[:n_examples]
    return x, y
