"""Megatron tensor parallelism over `model` for the towers beside the CLIP
ViT ones (tests/test_torch_parallel_tp.py), in gloo worlds on the CPU,
float32: the ConvNeXt CLIP (`test-tiny-convnext`, layer scale opened to
0.5 so that the blocks count)
and the BERT/XLM-R text towers of ja_clip (`test-tiny`) and mclip
(`test-tiny-mclip`, with its MLP projection), on meshes (1, 1, 2) and
(1, 2, 2).

Each world (`_torch_parallel_workers.tp_family_world`) holds the split
model against the same port model unsplit, in the same rank; here both
are held against JAX's single-device encoders on the same weights:
- image and text embeddings (unit vectors): 1e-5 of their largest
  magnitude (the row-parallel sums reorder float32 adds);
- every ConvNeXt block, BERT block and the MLP projection split, and so do
  the ViT and CLIP text blocks;
- each rank's bytes of each parameter: JAX's `shard_params` bytes on the
  device of the same index of `make_mesh(d, f, m)`;
- the split model's state_dict is the unsplit layout: it loads into an
  unsplit port model, which gives the unsplit embeddings bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.models import jaclip as JJ
from robustvlm_tpu.models import mclip as JM
from robustvlm_tpu.models.clip import CLIP_CONFIGS as JAX_CLIP
from robustvlm_tpu.models.clip import init_clip_params
from robustvlm_tpu.models.clip.model import encode_image as jax_encode_image
from robustvlm_tpu.models.clip.model import encode_text as jax_encode_text
from robustvlm_tpu.ops.image import normalize_clip as jax_normalize_clip
from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, params_from_jax
from robustvlm_tpu_torch.models.jaclip import JACLIP_CONFIGS, JaCLIP
from robustvlm_tpu_torch.models.mclip import MCLIP_CONFIGS
from robustvlm_tpu_torch.ops.image import normalize_clip

from _torch_parallel_workers import run_world
from test_torch_parallel_tp import _held
from test_torch_parallel_tp_vlms import bytes_equal_jax

torch.set_num_threads(1)
K = jax.random.PRNGKey(0)
MESHES = {"mesh112": (1, 1, 2), "mesh122": (1, 2, 2)}
FAMILIES = ("convnext", "ja_clip", "mclip")
CONFIGS = {"convnext": "test-tiny-convnext", "ja_clip": "test-tiny", "mclip": "test-tiny-mclip"}
JAX_CONFIGS = {"convnext": JAX_CLIP["test-tiny-convnext"], "ja_clip": JJ.JACLIP_CONFIGS["test-tiny"],
               "mclip": JM.MCLIP_CONFIGS["test-tiny-mclip"]}


def _build(family, tree):
    if family == "convnext":
        model = CLIP(CLIP_CONFIGS[CONFIGS[family]])
    else:
        model = JaCLIP({**JACLIP_CONFIGS, **MCLIP_CONFIGS}[CONFIGS[family]])
    model.load_state_dict(params_from_jax(tree))
    return model


def _inputs():
    rng = np.random.RandomState(0)
    tree = jax.tree.map(np.asarray, init_clip_params(K, JAX_CONFIGS["convnext"]))
    for st in tree["visual"]["stages"]:  # a layer scale of 1e-6 hides the blocks
        st["blocks"]["gamma"] = np.full_like(st["blocks"]["gamma"], 0.5)
    out = {"convnext": {"tree": tree, "x": rng.rand(4, 3, 32, 32).astype(np.float32),
                        "text": (rng.randint(1, 500, (4, 16)),)}}
    for family, init, key in (("ja_clip", JJ.init_jaclip_params, 1), ("mclip", JM.init_mclip_params, 4)):
        cfg = JAX_CONFIGS[family]
        ids = rng.randint(5, cfg.text.vocab_size, (4, 12))
        mask = np.ones((4, 12), np.int64)
        mask[1, 7:] = mask[3, 4:] = 0  # padded rows
        out[family] = {"tree": jax.tree.map(np.asarray, init(jax.random.PRNGKey(key), cfg)), "config": CONFIGS[family],
                       "x": rng.rand(4, 3, 32, 32).astype(np.float32), "text": (ids, mask)}
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """mesh name -> (shape, per-rank results): every world once."""
    return {name: (shape, run_world(tmp_path_factory.mktemp(name), int(np.prod(shape)), "tp_family_world",
                                    timeout=240, mesh_shape=shape, families=inputs))
            for name, shape in MESHES.items()}


@pytest.fixture(scope="module")
def jax_embeddings(inputs):
    out = {}
    for family, d in inputs.items():
        cfg, p = JAX_CONFIGS[family], jax.tree.map(jnp.asarray, d["tree"])
        x = jax_normalize_clip(jnp.asarray(d["x"]))
        text = [jnp.asarray(t) for t in d["text"]]
        if family == "convnext":
            img = jax_encode_image(p, x, cfg, normalize=True)
            txt = jax_encode_text(p, *text, cfg, normalize=True)
        else:
            img = JJ.encode_image(p, x, cfg, normalize=True)
            txt = JJ.encode_text(p, *text, cfg, normalize=True)
        out[family] = {"img": np.asarray(img), "txt": np.asarray(txt)}
    return out


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_embeddings_match_unsplit_and_jax(worlds, jax_embeddings, mesh, family):
    for r in worlds[mesh][1]:
        v = r[family]
        for k in ("img", "txt"):
            _held((v[k], v[f"ref_{k}"]), jax_embeddings[family][k])
            np.testing.assert_allclose(np.linalg.norm(v[k], axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_every_block_splits(worlds, mesh, family):
    for r in worlds[mesh][1]:
        s = r[family]["split"]
        assert s["vision"] and all(s["vision"]) and s["text"] and all(s["text"])
        if family == "mclip":
            assert s["projection"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_local_bytes_equal_jax_shards(worlds, inputs, mesh, family):
    shape, ranks = worlds[mesh]
    for rank, r in enumerate(ranks):
        bytes_equal_jax(family, r[family]["bytes"], inputs[family]["tree"], lambda t: _build(family, t), shape, rank)


@pytest.mark.parametrize("family", FAMILIES)
def test_split_state_dict_loads_unsplit(worlds, inputs, family):
    """Rank 0's state_dict on (1, 2, 2) holds JAX's values in the unsplit
    layout and gives the unsplit embeddings, bit for bit."""
    r = worlds["mesh122"][1][0][family]
    d = inputs[family]
    sd = {k: torch.from_numpy(v) for k, v in r["state"].items()}
    want = params_from_jax(d["tree"])
    assert set(sd) == set(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    model = _build(family, d["tree"])
    model.load_state_dict(sd)
    with torch.no_grad():
        img = model.encode_image(normalize_clip(torch.from_numpy(d["x"])), normalize=True)
        txt = model.encode_text(*(torch.from_numpy(t) for t in d["text"]), normalize=True)
    np.testing.assert_array_equal(img.numpy(), r["ref_img"])
    np.testing.assert_array_equal(txt.numpy(), r["ref_txt"])
