"""The JAX package's last functions without a port counterpart, against
their JAX twins on the CPU: `fold_normalization` (float32, same weights),
`check_zero_gradients_fn`, `center_crop`, `span`, the tee `Logger`, the
VLM ImageNet and Hateful Memes datasets and LLaVA's two constants."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from robustvlm_tpu.eval import checks as jax_checks
from robustvlm_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS
from robustvlm_tpu.models.clip import init_clip_params
from robustvlm_tpu.models.clip.model import encode_image as jax_encode_image
from robustvlm_tpu.models.clip.model import fold_normalization as jax_fold
from robustvlm_tpu.ops import image as jax_image
from robustvlm_tpu_torch.eval import checks
from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, params_from_jax
from robustvlm_tpu_torch.models.clip.model import cast_matrices_, fold_normalization
from robustvlm_tpu_torch.ops import image
from robustvlm_tpu_torch.utils import logging as port_logging
from robustvlm_tpu_torch.utils import profiling

torch.set_num_threads(1)
FOLD_TOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    cfg = JAX_CONFIGS["test-tiny"]
    jparams = init_clip_params(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, jparams)
    return cfg, jparams, tree


def _model(tree):
    model = CLIP(CLIP_CONFIGS["test-tiny"])
    model.load_state_dict(params_from_jax(tree))
    return model


def _images(n=3, size=32, seed=0):
    return np.random.RandomState(seed).rand(n, 3, size, size).astype(np.float32)


def test_folded_forward_matches_unfolded_and_jax(tiny):
    cfg, jparams, tree = tiny
    x = _images()
    model = _model(tree)
    ref = model.encode_image(image.normalize_clip(torch.from_numpy(x))).numpy()
    folded = _model(tree)
    fold_normalization(folded.visual)
    got = folded.encode_image(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= FOLD_TOL

    jfold = dict(jparams)
    jfold["visual"] = jax_fold(jparams["visual"], cfg.patch_size)
    jout = np.asarray(jax_encode_image(jfold, jnp.asarray(x), cfg, compute_dtype=jnp.float32))
    assert np.abs(got - jout).max() <= FOLD_TOL
    # the folded rows and the bias are JAX's
    np.testing.assert_allclose(folded.visual.patch_embed.numpy(),
                               np.asarray(jfold["visual"]["patch_embed"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(folded.visual.patch_bias.numpy(),
                               np.asarray(jfold["visual"]["patch_bias"]), rtol=1e-5, atol=1e-6)


def test_folded_jax_tree_loads_into_a_fresh_model(tiny):
    """`params_from_jax` carries a folded tree's `patch_bias` across, and an
    unfolded module takes it at load."""
    cfg, jparams, tree = tiny
    jfold = dict(jparams)
    jfold["visual"] = jax_fold(jparams["visual"], cfg.patch_size)
    model = CLIP(CLIP_CONFIGS["test-tiny"])
    assert model.visual.patch_bias is None
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jfold)))
    assert model.visual.patch_bias is not None
    x = _images(seed=1)
    got = model.encode_image(torch.from_numpy(x)).numpy()
    jout = np.asarray(jax_encode_image(jfold, jnp.asarray(x), cfg, compute_dtype=jnp.float32))
    assert np.abs(got - jout).max() <= FOLD_TOL


def test_fold_keeps_the_bias_in_float32_under_cast_and_refuses_twice(tiny):
    _, _, tree = tiny
    model = _model(tree)
    fold_normalization(model.visual)
    cast_matrices_(model, torch.bfloat16)
    assert model.visual.patch_embed.dtype == torch.bfloat16
    assert model.visual.patch_bias.dtype == torch.float32
    with pytest.raises(ValueError, match="already folded"):
        fold_normalization(model.visual)


def test_check_zero_gradients_fn_matches_jax_on_a_dead_input():
    """A linear classifier, live and with its weights zeroed (the logits no
    longer depend on x: every row's gradient is exactly 0). The labels are
    each row's argmax, where the DLR loss is not flat (at the third-ranked
    class it is 1 for every x, and float noise decides)."""
    rng = np.random.RandomState(0)
    w = rng.randn(12, 5).astype(np.float32)
    x = rng.rand(4, 3, 2, 2).astype(np.float32)
    for dead in (False, True):
        wd = w.copy()
        if dead:
            wd[:] = 0.0  # logits independent of x: every row's gradient is 0
        tw = torch.from_numpy(wd)
        y = (x.reshape(4, -1) @ w).argmax(-1)

        def port_fn(xa):
            return xa.reshape(xa.shape[0], -1) @ tw

        def jax_fn(xa):
            return xa.reshape(xa.shape[0], -1) @ jnp.asarray(wd)

        got = checks.check_zero_gradients_fn(port_fn, torch.from_numpy(x), torch.from_numpy(y))
        ref = jax_checks.check_zero_gradients_fn(jax_fn, jnp.asarray(x), jnp.asarray(y))
        assert got == bool(ref) == dead


@pytest.mark.parametrize("shape,size", [((2, 3, 40, 36), 32), ((3, 33, 33), 16), ((1, 3, 8, 8), 8)])
def test_center_crop_is_bitwise_jax(shape, size):
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    got = image.center_crop(torch.from_numpy(x), size).numpy()
    ref = np.asarray(jax_image.center_crop(jnp.asarray(x), size))
    assert got.shape == ref.shape == shape[:-2] + (size, size)
    assert np.array_equal(got, ref)


def test_span_names_a_region_in_the_trace_and_in_spans_json(tmp_path):
    profiling.reset()
    with profiling.span("apgd.attack"):  # before the window: not recorded
        pass
    with profiling.trace(str(tmp_path)):
        with profiling.span("apgd.iter"):
            with profiling.span("apgd.update"):
                torch.ones(8).sum()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = [e for e in events if e.get("name") in ("apgd.iter", "apgd.update")]
    assert sorted(e["name"] for e in ranges) == ["apgd.iter", "apgd.update"]
    assert all(e.get("cat") != "gpu_user_annotation" for e in ranges)
    log = json.loads((tmp_path / "spans.json").read_text())
    assert log["dropped"] == 0
    it, up = log["spans"]
    assert (it["name"], up["name"]) == ("apgd.iter", "apgd.update")
    assert up["parent"] == it["id"] == up["root"] and it["complete"] and up["complete"]
    assert it["host_ms"] >= up["host_ms"] >= 0


def test_logger_tees_to_stdout_and_file(tmp_path, capsys):
    from robustvlm_tpu.utils.logging import Logger as JaxLogger

    path = tmp_path / "log.txt"
    port_logging.Logger(str(path)).log("robust accuracy: 12.50%")
    port_logging.Logger(None).log("no file")
    jpath = tmp_path / "jax_log.txt"
    JaxLogger(str(jpath)).log("robust accuracy: 12.50%")
    out = capsys.readouterr().out
    assert "robust accuracy: 12.50%" in out and "no file" in out
    assert path.read_text() == jpath.read_text() == "robust accuracy: 12.50%\n"


def _png(path, seed, size=(40, 30)):
    rgb = (np.random.RandomState(seed).rand(size[1], size[0], 3) * 255).astype("uint8")
    Image.fromarray(rgb).save(path)


@pytest.fixture
def pil_transforms(monkeypatch):
    """Both packages through PIL's transform (JAX's native resize otherwise
    differs from the port's by up to 1/255)."""
    from robustvlm_tpu.data import loaders as jax_loaders
    from robustvlm_tpu.vlm_eval import datasets as jax_ds
    from robustvlm_tpu_torch.data import loaders as port_loaders
    from robustvlm_tpu_torch.vlm_eval import datasets as port_ds

    for mod, fn in ((jax_loaders, jax_loaders.default_image_transform),
                    (jax_ds, jax_loaders.default_image_transform),
                    (port_loaders, port_loaders.default_image_transform),
                    (port_ds, port_loaders.default_image_transform)):
        monkeypatch.setattr(mod, "default_image_transform",
                            lambda size=224, prefer_native=True, _f=fn: _f(size, prefer_native=False))


def _equal_items(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "image":
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
        else:
            assert a[k] == b[k]


def test_vlm_imagenet_dataset_items_equal_jax(tmp_path, pil_transforms):
    from robustvlm_tpu.vlm_eval.datasets import VLMImageNetDataset as JaxDS
    from robustvlm_tpu_torch.vlm_eval.datasets import VLMImageNetDataset

    for c, cls in enumerate(("n01440764", "n01443537")):
        (tmp_path / cls).mkdir()
        for j in range(2):
            _png(tmp_path / cls / f"img{j}.png", 10 * c + j)
    port, ref = VLMImageNetDataset(str(tmp_path), size=24, n_samples=3), JaxDS(str(tmp_path), size=24,
                                                                              n_samples=3)
    assert len(port) == len(ref) == 3
    for i in range(3):
        _equal_items(port[i], ref[i])
    assert port[2]["class_name"] == ref[2]["class_name"] == port.classnames[1]


def test_hateful_memes_dataset_items_equal_jax(tmp_path, pil_transforms):
    from robustvlm_tpu.vlm_eval.datasets import HatefulMemesDataset as JaxDS
    from robustvlm_tpu_torch.vlm_eval.datasets import HatefulMemesDataset

    (tmp_path / "img").mkdir()
    lines = []
    for i in range(3):
        _png(tmp_path / "img" / f"{i:05d}.png", i)
        lines.append(json.dumps({"id": 100 + i, "img": f"img/{i:05d}.png", "text": f"meme {i}",
                                 "label": i % 2}))
    ann = tmp_path / "dev.jsonl"
    ann.write_text("\n".join(lines[:2]) + "\n\n" + lines[2] + "\n")
    port = HatefulMemesDataset(str(tmp_path / "img"), str(ann), size=24)
    ref = JaxDS(str(tmp_path / "img"), str(ann), size=24)
    assert len(port) == len(ref) == 3
    for i in range(3):
        _equal_items(port[i], ref[i])


def test_llava_constants_equal_jax():
    from robustvlm_tpu.models.llava import model as jax_llava
    from robustvlm_tpu_torch.models.llava import model as port_llava

    assert port_llava.IMAGE_TOKEN_INDEX == jax_llava.IMAGE_TOKEN_INDEX == -200
    assert port_llava.IGNORE_INDEX == jax_llava.IGNORE_INDEX == -100
