"""TFDS / VTAB datasets for the zero-shot benchmark.

Counterpart of `robustvlm_tpu/benchmark/tfds_adapter.py`: `tfds/<name>`
and `vtab/<task>` datasets through the optional `tensorflow_datasets`
package (not a dependency of the port: the import is gated, and its error
points at the dependency-free `wds/` mirrors of the same benchmarks). The
images go through the port's own transform. The VTAB tasks with derived
labels reimplement the published preprocessing:
  - kitti closest_vehicle_distance: min z over Car/Van/Truck, thresholds
    [-100, 8, 20, 999];
  - clevr count_all (objects - 3) and closest_object_distance (min pixel
    z against [0, 8, 8.5, 9, 9.5, 10, 100]).
The dsprites/smallnorb attribute tasks need the original `task_adaptation`
package and raise, saying so.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np


def _require_tfds():
    try:
        import tensorflow_datasets as tfds  # type: ignore
    except ImportError as e:  # pragma: no cover - exercised via fake module
        raise ImportError(
            "tfds/<name> and vtab/<name> datasets need the optional "
            "`tensorflow_datasets` package (not bundled with robustvlm_tpu_torch). "
            "The same benchmarks stream dependency-free as 'wds/<name>' "
            "from the clip-benchmark HF-hub mirrors: see benchmark/cli.py."
        ) from e
    try:  # keep TF off the accelerators
        import tensorflow as tf  # type: ignore

        tf.config.set_visible_devices([], "GPU")
    except Exception:
        pass
    return tfds


# VTAB name -> (tfds builder name, label feature)
_VTAB_DIRECT = {
    "caltech101": ("caltech101:3.*.*", "label"),
    "cifar10": ("cifar10", "label"),
    "cifar100": ("cifar100", "label"),
    "cars": ("cars196:2.*.*", "label"),
    "dtd": ("dtd", "label"),
    "eurosat": ("eurosat/rgb:2.*.*", "label"),
    "flowers": ("oxford_flowers102:2.*.*", "label"),
    "pets": ("oxford_iiit_pet:3.*.*", "label"),
    "pcam": ("patch_camelyon:2.*.*", "label"),
    "resisc45": ("resisc45:3.*.*", "label"),
    "sun397": ("sun397/tfds:4.*.*", "label"),
    "svhn": ("svhn_cropped:3.*.*", "label"),
    "dmlab": ("dmlab:2.0.1", "label"),
}

_KITTI_VEHICLE_THRS = np.array([-100.0, 8.0, 20.0, 999.0])
_CLEVR_DIST_THRS = np.array([0.0, 8.0, 8.5, 9.0, 9.5, 10.0, 100.0])


def kitti_closest_vehicle_distance_label(example: dict) -> int:
    """Distance class of the closest Car/Van/Truck (types 0-2), with a 'no
    vehicle' class at 1000 m."""
    types = np.asarray(example["objects"]["type"]).reshape(-1)
    loc = np.asarray(example["objects"]["location"]).reshape(-1, 3)
    z = loc[types < 3, 2] if types.size else np.zeros((0,))
    dist = float(np.min(np.concatenate([z, [1000.0]])))
    return int(np.max(np.where((_KITTI_VEHICLE_THRS - dist) < 0)[0]))


def clevr_count_all_label(example: dict) -> int:
    """VTAB CLEVR counting task: 3..10 objects -> classes 0..7."""
    return int(len(np.asarray(example["objects"]["size"]).reshape(-1)) - 3)


def clevr_closest_object_distance_label(example: dict) -> int:
    """VTAB CLEVR distance task: min pixel-space z binned by thresholds."""
    z = np.asarray(example["objects"]["pixel_coords"]).reshape(-1, 3)[:, 2]
    dist = float(np.min(z))
    return int(np.max(np.where((_CLEVR_DIST_THRS - dist) < 0)[0]))


_VTAB_DERIVED = {
    "kitti_closest_vehicle_distance": (
        "kitti:3.*.*", kitti_closest_vehicle_distance_label
    ),
    "clevr_count_all": ("clevr:3.*.*", clevr_count_all_label),
    "clevr_closest_object_distance": ("clevr:3.*.*", clevr_closest_object_distance_label),
}


class TfdsClassificationDataset:
    """Batched (images [B,3,S,S] float32 in [0,1], labels [B]) iterator over
    a TFDS image-classification split, resized with the port's own host
    transform (no TF preprocessing in the loop)."""

    def __init__(
        self,
        tfds_name: str,
        *,
        root: Optional[str] = None,
        split: str = "test",
        size: int = 224,
        label_fn=None,
        label_key: str = "label",
        n_samples: Optional[int] = None,
    ):
        tfds = _require_tfds()
        builder = tfds.builder(tfds_name, data_dir=root)
        builder.download_and_prepare()
        self._ds = builder.as_dataset(split=split)
        info = builder.info
        self.classes: Optional[List[str]] = None
        if label_fn is None and label_key in info.features:
            try:
                self.classes = list(info.features[label_key].names)
            except Exception:
                self.classes = None
        self._label_fn = label_fn
        self._label_key = label_key
        self._size = size
        self._n = n_samples
        self._tf = None

    def _to_image(self, img: np.ndarray) -> np.ndarray:
        from PIL import Image

        from robustvlm_tpu_torch.data.loaders import default_image_transform

        if self._tf is None:
            self._tf = default_image_transform(self._size)
        return self._tf(Image.fromarray(np.asarray(img)))

    def batched(self, batch_size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        import tensorflow_datasets as tfds  # type: ignore

        xs, ys = [], []
        seen = 0
        for ex in tfds.as_numpy(self._ds):
            if self._n is not None and seen >= self._n:
                break
            seen += 1
            xs.append(self._to_image(ex["image"]))
            ys.append(
                self._label_fn(ex) if self._label_fn is not None
                else int(ex[self._label_key])
            )
            if len(xs) == batch_size:
                yield np.stack(xs), np.asarray(ys, np.int64)
                xs, ys = [], []
        if xs:
            yield np.stack(xs), np.asarray(ys, np.int64)


def build_tfds_dataset(name: str, root: Optional[str], *, split: str = "test",
                       size: int = 224, n_samples: Optional[int] = None):
    """`tfds/<builder_name>` -> dataset."""
    return TfdsClassificationDataset(
        name, root=root, split=split, size=size, n_samples=n_samples
    )


def build_vtab_dataset(name: str, root: Optional[str], *, split: str = "test",
                       size: int = 224, n_samples: Optional[int] = None):
    """`vtab/<task>` -> dataset with VTAB task labels."""
    if name in _VTAB_DIRECT:
        tfds_name, label_key = _VTAB_DIRECT[name]
        return TfdsClassificationDataset(
            tfds_name, root=root, split=split, size=size,
            label_key=label_key, n_samples=n_samples,
        )
    if name in _VTAB_DERIVED:
        tfds_name, label_fn = _VTAB_DERIVED[name]
        ds = TfdsClassificationDataset(
            tfds_name, root=root, split=split, size=size,
            label_fn=label_fn, n_samples=n_samples,
        )
        from robustvlm_tpu_torch.benchmark.templates import get_classnames

        try:
            ds.classes = get_classnames(name)
        except KeyError:
            pass
        return ds
    if name.startswith(("dsprites_", "smallnorb_")) or name == "diabetic_retinopathy":
        raise NotImplementedError(
            f"vtab/{name} uses task_adaptation-specific preprocessing; "
            "install/port the original `task_adaptation` pipeline or use "
            f"the dependency-free 'wds/vtab/{name}' HF-hub mirror instead."
        )
    raise ValueError(f"unknown VTAB dataset: {name}")
