"""The port's `COCOFlickrDataset` and `SamData` (robustvlm_tpu_torch.data.
loaders) against the JAX package's on a tmp fixture: the same samples in
the same order, and each item's image array bit-equal (both sides on the
PIL transform) with label 0."""

import json

import numpy as np
import pytest
from PIL import Image

from robustvlm_tpu.data import loaders as JL
from robustvlm_tpu_torch.data import loaders as PL


def _images(root, names, seed=0):
    rng = np.random.RandomState(seed)
    for n in names:
        (root / n).parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (30 + len(n), 40, 3), np.uint8)).save(root / n)


def _equal(port_ds, jax_ds):
    assert len(port_ds) == len(jax_ds) > 0
    for i in range(len(jax_ds)):
        (x, y), (xr, yr) = port_ds[i], jax_ds[i]
        assert y == yr == 0 and x.dtype == np.float32
        np.testing.assert_array_equal(x, np.asarray(xr))


@pytest.mark.parametrize("layout", ["coco", "karpathy"])
def test_coco_flickr_dataset_equals_jax(tmp_path, layout):
    _images(tmp_path / "img", ["pre_a.jpg", "pre_b.png"])
    key, fname = ("id", "file_name") if layout == "coco" else ("cocoid", "filename")
    data = {"images": [{key: 7, fname: "a.jpg"}, {key: 9, fname: "b.png"}],
            "annotations": [{"image_id": 9, "caption": "b one"}, {"image_id": 7, "caption": "a"},
                            {"image_id": 3, "caption": "no image"}, {"image_id": 9, "caption": "b two"}]}
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(data))
    kw = dict(size=16, prefix="pre_")
    port = PL.COCOFlickrDataset(str(tmp_path / "img"), str(ann),
                                transform=PL.default_image_transform(16, prefer_native=False), **kw)
    ref = JL.COCOFlickrDataset(str(tmp_path / "img"), str(ann),
                               transform=JL.default_image_transform(16, prefer_native=False), **kw)
    assert port.samples == ref.samples and len(port) == 3
    _equal(port, ref)


def test_sam_data_equals_jax(tmp_path):
    _images(tmp_path, ["sa_2.jpg", "sub/sa_1.jpg", "x.png", "notes.txt.jpeg"], seed=1)
    (tmp_path / "readme.txt").write_text("not an image")
    port = PL.SamData(str(tmp_path), transform=PL.default_image_transform(24, prefer_native=False))
    ref = JL.SamData(str(tmp_path), transform=JL.default_image_transform(24, prefer_native=False))
    assert port.paths == ref.paths and len(port) == 4
    _equal(port, ref)
