"""Host-side data: the image transform, an image-folder tree, synthetic
images, CIFAR-10, and a shuffling, prefetching batch loader.

Counterpart of `default_image_transform` (the C++ transform of
`data/native.py` when it builds, PIL otherwise, as in JAX),
`ImageFolderDataset`, `SyntheticClassificationDataset`, `load_cifar10`,
`prefetch_iter`, `DataLoader`, `COCOFlickrDataset` and `SamData` in
`robustvlm_tpu/data/loaders.py`. Images
are float32 NCHW in [0,1], without CLIP normalization (normalization
happens inside the model). `DataLoader` yields numpy batches in the JAX
loader's order from the same seed.
"""

from __future__ import annotations

import pickle
import queue
import threading
from pathlib import Path
from typing import Callable, Iterator, Optional, Tuple

import numpy as np


def default_image_transform(size: int = 224, prefer_native: bool = True):
    """Resize(size, bicubic) + CenterCrop(size) + [0,1] float CHW: the
    reference preprocessing minus Normalize. Through the C++ transform
    (`data/native.py`) when it is available and `prefer_native`, through
    PIL otherwise; the two agree within 1/255 a pixel."""
    if prefer_native:
        from robustvlm_tpu_torch.data.native import native_image_transform

        tf = native_image_transform(size)
        if tf is not None:
            return tf
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


class ImageFolderDataset:
    """An ImageNet-style tree, one directory per class (sorted names give the
    labels), image files sorted within each."""

    EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}

    def __init__(self, root: str, transform: Optional[Callable] = None, size: int = 224):
        self.root = Path(root)
        self.transform = transform or default_image_transform(size)
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = [
            (p, self.class_to_idx[c])
            for c in classes
            for p in sorted((self.root / c).iterdir())
            if p.suffix.lower() in self.EXTS
        ]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i) -> Tuple[np.ndarray, int]:
        from PIL import Image

        path, label = self.samples[i]
        with Image.open(path) as img:
            return self.transform(img), label


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


def prefetch_iter(it: Iterator, depth: int = 2) -> Iterator:
    """Run `it` on a background daemon thread, keeping up to `depth` items
    ready, so host decoding overlaps the consumer's device work. An
    abandoned consumer stops the producer; a producer's exception is
    raised at the consumer's next pull."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end, err = object(), object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in it:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # noqa: BLE001 - raised again at the consumer
            put((err, e))

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is err:
                raise item[1]
            yield item
    finally:
        stop.set()


class DataLoader:
    """Shuffling, batching, background-prefetching loader of numpy batches
    (x (B, 3, S, S) float32, y (B,) int64). Epoch e's order is
    `np.random.RandomState(seed + e).shuffle` of the indices, as in JAX."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 2, num_threads: int = 8):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.num_threads = num_threads
        self.epoch = 0

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def _load_batch(self, idxs: np.ndarray):
        from concurrent.futures import ThreadPoolExecutor

        if self.num_threads > 1 and len(idxs) > 8:
            with ThreadPoolExecutor(self.num_threads) as ex:
                items = list(ex.map(self.ds.__getitem__, idxs))
        else:
            items = [self.ds[i] for i in idxs]
        return np.stack([it[0] for it in items]), np.asarray([it[1] for it in items], np.int64)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        n_batches = len(self)

        def batches():
            for b in range(n_batches):
                yield self._load_batch(order[b * self.bs: (b + 1) * self.bs])

        return prefetch_iter(batches(), self.prefetch)


class COCOFlickrDataset:
    """The images of a COCO-format caption file (`images` with id/file_name
    or cocoid/filename, `annotations` with image_id), one item an
    annotation, for FARE-style unsupervised training: yields (image, 0),
    since the fine-tune reads only the images."""

    def __init__(self, image_dir: str, annotations_path: str, transform: Optional[Callable] = None,
                 size: int = 224, prefix: str = ""):
        import json

        self.image_dir = Path(image_dir)
        self.transform = transform or default_image_transform(size)
        with open(annotations_path) as f:
            data = json.load(f)
        files = {im.get("id", im.get("cocoid")): im.get("file_name", im.get("filename"))
                 for im in data.get("images", [])}
        self.samples = [(self.image_dir / (prefix + files[a["image_id"]]), a.get("caption", ""))
                        for a in data.get("annotations", []) if a["image_id"] in files]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i) -> Tuple[np.ndarray, int]:
        from PIL import Image

        with Image.open(self.samples[i][0]) as img:
            return self.transform(img), 0


class SamData:
    """A directory tree of SA-1B images (every image file under it, sorted by
    path): yields (image, 0)."""

    def __init__(self, data_dir: str, transform: Optional[Callable] = None, size: int = 224):
        self.paths = sorted(p for p in Path(data_dir).rglob("*")
                            if p.suffix.lower() in ImageFolderDataset.EXTS)
        self.transform = transform or default_image_transform(size)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i) -> Tuple[np.ndarray, int]:
        from PIL import Image

        with Image.open(self.paths[i]) as img:
            return self.transform(img), 0
