"""Dataset builders for the benchmark suite.

Counterpart of `robustvlm_tpu/benchmark/builder.py`: `build_dataset`
dispatch (synthetic, cifar10, image folders, webdatasets, tfds/vtab) and a
webdataset reader on `tarfile` alone: a sequential tar stream is grouped
into samples by basename ({'jpg', 'png', ..., 'cls', 'txt', 'json',
'npy'}), each image decoded by `data.loaders.default_image_transform` (the
C++ transform when it builds) and batched ahead on a host thread
(`prefetch_iter`). A reference-layout root (`<split>/nshards.txt`,
`classnames.txt`, `zeroshot_classification_templates.txt`,
`dataset_type.txt`) may be a local directory, a `file://` or `https://`
URL, a Hugging Face hub tree URL or `hf://user/repo`; shards stream
through urllib and are never downloaded whole.
"""

from __future__ import annotations

import io
import json
import tarfile
import urllib.request
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from robustvlm_tpu_torch.data.loaders import (
    DataLoader,
    ImageFolderDataset,
    SyntheticClassificationDataset,
    default_image_transform,
    load_cifar10,
    prefetch_iter,
)

IMG_KEYS = ("jpg", "jpeg", "png", "webp", "bmp")


def _is_url(path: str) -> bool:
    return "://" in str(path)


def _open_shard(path: str):
    """File-like byte stream for a shard path or URL (streaming; a remote
    tar is read incrementally through the socket, never fully downloaded)."""
    if _is_url(path):
        return urllib.request.urlopen(path)
    return open(path, "rb")


def _read_text(path: str) -> str:
    if _is_url(path):
        with urllib.request.urlopen(path) as r:
            return r.read().decode("utf-8")
    return Path(path).read_text()


def resolve_wds_dirs(data_dir: str) -> Tuple[str, str]:
    """(metadata_dir, tardata_dir) for a wds root. Hugging Face hub tree URLs
    read metadata through /raw/ and the LFS tars through /resolve/;
    `hf://user/repo` expands to the hub's main-branch tree."""
    data_dir = str(data_dir)
    if data_dir.startswith("hf://"):
        data_dir = (
            "https://huggingface.co/datasets/"
            + data_dir[len("hf://"):].rstrip("/")
            + "/tree/main"
        )
    if data_dir.startswith("https://huggingface.co/datasets"):
        parts = data_dir.rstrip("/").split("/", 7)
        # .../datasets/<org>/<repo>[/tree/<branch>[/subpath]]
        if len(parts) >= 8 and parts[6] == "tree":
            url_head = "/".join(parts[:6])
            branch_path = parts[7]
        elif len(parts) == 6:
            url_head = "/".join(parts)  # plain repo URL — default branch
            branch_path = "main"
        else:
            raise ValueError(
                f"unrecognized HF datasets URL {data_dir!r}; expected "
                "https://huggingface.co/datasets/<org>/<repo>[/tree/<branch>]"
            )
        return (
            "/".join([url_head, "raw", branch_path]),
            "/".join([url_head, "resolve", branch_path]),
        )
    return data_dir, data_dir


def _join(base: str, *parts: str) -> str:
    if _is_url(base):
        return "/".join([base.rstrip("/"), *parts])
    return str(Path(base, *parts))


def _decode_image(data: bytes, transform) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as img:
        return transform(img)


class WdsShardDataset:
    """Iterable webdataset-format reader over .tar shards (paths or URLs).

    Each sample is the group of tar members sharing a basename; emits
    (image [0,1] CHW float32, label, multi-hot labels or captions): the
    class from a 'cls' member, multi-hot labels from 'npy', captions from
    'txt' (one a line) or 'json' ('caption' or 'text').
    """

    def __init__(
        self,
        shards: Sequence[str],
        size: int = 224,
        transform: Optional[Callable] = None,
        mode: str = "classification",  # or "captions"
    ):
        self.shards = [str(s) for s in shards]
        self.transform = transform or default_image_transform(size)
        self.mode = mode

    def __iter__(self) -> Iterator[Tuple[np.ndarray, object]]:
        for shard in self.shards:
            with _open_shard(shard) as stream, tarfile.open(
                fileobj=stream, mode="r|*"
            ) as tf:
                current_key: Optional[str] = None
                parts: Dict[str, bytes] = {}
                for member in tf:
                    if not member.isfile():
                        continue
                    name = Path(member.name)
                    key, ext = str(name.parent / name.stem), name.suffix[1:].lower()
                    if current_key is not None and key != current_key and parts:
                        s = self._emit(parts)
                        if s is not None:
                            yield s
                        parts = {}
                    current_key = key
                    parts[ext] = tf.extractfile(member).read()
                if parts:
                    s = self._emit(parts)
                    if s is not None:
                        yield s

    def _emit(self, parts: Dict[str, bytes]):
        img_data = next(
            (parts[k] for k in IMG_KEYS if k in parts), None
        )
        if img_data is None:
            return None
        x = _decode_image(img_data, self.transform)
        if self.mode == "multilabel":
            if "npy" not in parts:
                return None
            return x, np.load(io.BytesIO(parts["npy"]), allow_pickle=False)
        if self.mode == "classification":
            if "cls" not in parts:
                return None
            return x, int(parts["cls"].decode().strip())
        # retrieval/captions: txt holds newline-separated captions
        caption = None
        if "txt" in parts:
            caption = [
                l for l in parts["txt"].decode().splitlines() if l.strip()
            ]
        elif "json" in parts:
            j = json.loads(parts["json"])
            c = j.get("caption") or j.get("text")
            caption = [c] if isinstance(c, str) else c
        return x, caption


class WdsBatchedLoader:
    """Batch an iterable WdsShardDataset (classification mode), with the
    stream decoded ahead on a background thread."""

    def __init__(self, ds: WdsShardDataset, batch_size: int,
                 prefetch: int = 2):
        self.ds = ds
        self.bs = batch_size
        self.prefetch = prefetch

    def __iter__(self):
        def batches():
            xs: List[np.ndarray] = []
            ys: List[int] = []
            for x, y in self.ds:
                xs.append(x)
                ys.append(y)
                if len(xs) == self.bs:
                    yield np.stack(xs), np.asarray(ys, np.int64)
                    xs, ys = [], []
            if xs:
                yield np.stack(xs), np.asarray(ys, np.int64)

        return prefetch_iter(batches(), self.prefetch)


class WdsDataset:
    """A webdataset in the reference's exported layout: per-split numbered
    shards and nshards.txt, with optional classnames.txt,
    zeroshot_classification_templates.txt and dataset_type.txt. Works on
    local dirs, file:// and https:// roots, Hugging Face hub tree URLs and
    hf:// shorthand: shards stream, metadata is read at construction."""

    def __init__(
        self,
        data_dir: str,
        *,
        split: str = "test",
        size: int = 224,
        transform: Optional[Callable] = None,
    ):
        meta_dir, tar_dir = resolve_wds_dirs(data_dir)
        nshards = int(_read_text(_join(meta_dir, split, "nshards.txt")).strip())
        try:
            self.dataset_type = _read_text(
                _join(meta_dir, "dataset_type.txt")
            ).strip().lower()
        except (FileNotFoundError, OSError):
            self.dataset_type = "classification"
        self.classes: Optional[List[str]] = None
        self.templates: Optional[List[str]] = None
        if self.dataset_type != "retrieval":
            for attr, fname in (
                ("classes", "classnames.txt"),
                ("templates", "zeroshot_classification_templates.txt"),
            ):
                try:
                    setattr(self, attr, [
                        l.strip()
                        for l in _read_text(_join(meta_dir, fname)).splitlines()
                        if l.strip()
                    ])
                except (FileNotFoundError, OSError):
                    pass
        shards = [_join(tar_dir, split, f"{i}.tar") for i in range(nshards)]
        mode = {
            "retrieval": "captions",
            "multilabel": "multilabel",
        }.get(self.dataset_type, "classification")
        self.samples = WdsShardDataset(
            shards, size=size, transform=transform, mode=mode
        )

    def __iter__(self):
        return iter(self.samples)

    def batched(self, batch_size: int):
        if self.dataset_type == "retrieval":
            def gen():
                xs, caps = [], []
                for x, c in self.samples:
                    xs.append(x)
                    caps.append(c)
                    if len(xs) == batch_size:
                        yield np.stack(xs), caps
                        xs, caps = [], []
                if xs:
                    yield np.stack(xs), caps
            return prefetch_iter(gen())
        return WdsBatchedLoader(self.samples, batch_size)


def _truncate_batches(it, n_samples: Optional[int]):
    """Cap a batched (x, y) iterator at n_samples total examples."""
    if n_samples is None:
        return it

    def gen():
        seen = 0
        for xb, yb in it:
            keep = min(len(xb), n_samples - seen)
            seen += keep
            yield xb[:keep], yb[:keep]
            if seen >= n_samples:
                return  # before the loop decodes one extra batch

    return gen()


def build_dataset(
    name: str,
    root: str,
    *,
    split: str = "test",
    size: int = 224,
    batch_size: int = 128,
    n_samples: Optional[int] = None,
):
    """Dispatch by dataset name -> batched (x, y) iterator.

    Supported: 'cifar10' (local python batches), 'imagenet'/'imagefolder'
    (class-per-dir tree), 'wds/<anything>' (webdataset: a reference-layout
    root, local, file://, https://, a hub tree URL or hf://user/repo, else
    a flat local dir of .tar shards), 'tfds/<name>' and 'vtab/<task>' (with
    the optional tensorflow_datasets), 'synthetic' (tests and benches).
    """
    if name == "cifar10":
        x, y = load_cifar10(root, train=(split == "train"), n_examples=n_samples)
        def gen():
            for i in range(0, len(x), batch_size):
                yield x[i : i + batch_size], y[i : i + batch_size]
        return gen()
    if name in ("imagenet", "imagefolder", "imagenet1k"):
        sub = {"test": "val", "train": "train"}.get(split, split)
        ds = ImageFolderDataset(f"{root}/{sub}", size=size)
        return _truncate_batches(
            DataLoader(ds, batch_size, shuffle=False, drop_last=False),
            n_samples,
        )
    if name.startswith("wds/"):
        # reference-layout root (has <split>/nshards.txt) streams via
        # WdsDataset; a flat local dir of .tar shards keeps working
        if _is_url(root):
            it = WdsDataset(root, split=split, size=size).batched(batch_size)
        elif Path(root, split, "nshards.txt").exists():
            it = WdsDataset(root, split=split, size=size).batched(batch_size)
        else:
            shards = sorted(Path(root).glob("*.tar"))
            if not shards:
                raise FileNotFoundError(f"no .tar shards under {root}")
            it = WdsBatchedLoader(WdsShardDataset(shards, size=size), batch_size)
        return _truncate_batches(it, n_samples)
    if name.startswith("tfds/"):
        from robustvlm_tpu_torch.benchmark.tfds_adapter import build_tfds_dataset

        return build_tfds_dataset(
            name[len("tfds/"):], root or None, split=split, size=size,
            n_samples=n_samples,
        ).batched(batch_size)
    if name.startswith("vtab/"):
        from robustvlm_tpu_torch.benchmark.tfds_adapter import build_vtab_dataset

        return build_vtab_dataset(
            name[len("vtab/"):], root or None, split=split, size=size,
            n_samples=n_samples,
        ).batched(batch_size)
    if name == "synthetic":
        ds = SyntheticClassificationDataset(
            n=n_samples or 256, size=size
        )
        return DataLoader(ds, batch_size, shuffle=False, drop_last=False)
    raise ValueError(f"unknown dataset: {name}")
