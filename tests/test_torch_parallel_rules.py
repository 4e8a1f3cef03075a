"""The port's sharding rules (robustvlm_tpu_torch.parallel.mesh) against the
JAX package's `param_sharding_rules` on the 8-device (2, 2, 2) mesh
(conftest), parameter by parameter, for every family's tiny tree and for
OpenFlamingo-9B's full tree (the port's model built on the meta device);
with `_fit_spec`'s fallbacks and the sharded share of the bytes (the
counterpart of tests/test_parallel.py's rule tests).

Each port tensor's JAX leaf is found by value: the JAX tree's leaves are
redrawn at random (so every value is unique), carried across by the
family's `params_from_jax`, which copies a leaf, or one layer of a stacked
leaf, possibly transposed; the JAX spec's dims for that slice (the stack's
leading dims dropped, reversed for a transpose) must equal the port's. On
the meta device (no values) the leaf is found by name, the per-layer
indices dropped. Needs no process group: the rules are a pure function of
names, shapes and the mesh's shape.
"""

import re

import jax
import numpy as np
import pytest
import torch

from robustvlm_tpu.parallel.mesh import make_mesh as jax_mesh
from robustvlm_tpu.parallel.mesh import param_sharding_rules as jax_rules
from robustvlm_tpu_torch.parallel.mesh import param_sharding_rules, shard_dim

MESH = {"data": 2, "fsdp": 2, "model": 2}
K = jax.random.PRNGKey(0)


def _clip(name):
    from robustvlm_tpu.models.clip import CLIP_CONFIGS as J, init_clip_params
    from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, params_from_jax

    def port(tree):
        m = CLIP(CLIP_CONFIGS[name])
        m.load_state_dict(params_from_jax(tree))
        return m
    return init_clip_params(K, J[name]), port


def _llama():
    from robustvlm_tpu.models.llama import LLAMA_CONFIGS as J
    from robustvlm_tpu.models.llama.model import init_llama_params
    from robustvlm_tpu_torch.models.llama.model import LLAMA_CONFIGS, Llama
    from robustvlm_tpu_torch.models.clip import params_from_jax

    def port(tree):
        m = Llama(LLAMA_CONFIGS["test-tiny"])
        m.load_state_dict(params_from_jax(tree))
        return m
    return init_llama_params(K, J["test-tiny"]), port


def _mpt():
    from robustvlm_tpu.models.mpt import model as JM
    from robustvlm_tpu_torch.models.mpt import model as PM
    from robustvlm_tpu_torch.models.mpt.convert import params_from_jax

    return (JM.init_mpt_params(K, JM.MPT_CONFIGS["test-tiny"]),
            lambda t: PM.MPT.from_state(PM.MPT_CONFIGS["test-tiny"], params_from_jax(t)))


def _flamingo():
    from robustvlm_tpu.models.flamingo import model as JF
    from robustvlm_tpu_torch.models.flamingo import convert as PC
    from robustvlm_tpu_torch.models.flamingo import model as PF

    return (JF.init_flamingo_params(K, JF.FLAMINGO_CONFIGS["test-tiny"]),
            lambda t: PF.Flamingo.from_state(PF.FLAMINGO_CONFIGS["test-tiny"], PC.params_from_jax(t)))


def _llava():
    from robustvlm_tpu.models.llava.model import LLAVA_CONFIGS as J, init_llava_params
    from robustvlm_tpu_torch.models.llava.convert import params_from_jax
    from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS, Llava

    return init_llava_params(K, J["test-tiny"]), lambda t: Llava.from_state(LLAVA_CONFIGS["test-tiny"],
                                                                            params_from_jax(t))


def _blip2():
    from robustvlm_tpu.models.blip2 import model as JB
    from robustvlm_tpu_torch.models.blip2 import model as PB
    from robustvlm_tpu_torch.models.blip2.convert import params_from_jax

    return (JB.init_blip2_params(K, JB.BLIP2_CONFIGS["test-tiny"]),
            lambda t: PB.Blip2.from_state(PB.BLIP2_CONFIGS["test-tiny"], params_from_jax(t)))


def _jaclip(kind):
    from robustvlm_tpu_torch.models.clip import params_from_jax

    if kind == "mclip":
        from robustvlm_tpu.models import mclip as JM
        from robustvlm_tpu_torch.models.mclip import MCLIP_CONFIGS as CONFIGS, JaCLIP

        name, tree = "test-tiny-mclip", JM.init_mclip_params(K, JM.MCLIP_CONFIGS["test-tiny-mclip"])
    else:
        from robustvlm_tpu.models import jaclip as JJ
        from robustvlm_tpu_torch.models.jaclip import JACLIP_CONFIGS as CONFIGS, JaCLIP

        name, tree = "test-tiny", JJ.init_jaclip_params(K, JJ.JACLIP_CONFIGS["test-tiny"])

    def port(t):
        m = JaCLIP(CONFIGS[name])
        m.load_state_dict(params_from_jax(t))
        return m
    return tree, port


def _opt():
    from robustvlm_tpu.models.opt import model as JO
    from robustvlm_tpu_torch.models.opt import model as PO
    from robustvlm_tpu_torch.models.opt.convert import params_from_jax

    return (JO.init_opt_params(K, JO.OPT_CONFIGS["test-tiny"]),
            lambda t: PO.OPT.from_state(PO.OPT_CONFIGS["test-tiny"], params_from_jax(t)))


FAMILIES = {
    "clip": lambda: _clip("test-tiny"), "convnext": lambda: _clip("test-tiny-convnext"),
    "llama": _llama, "mpt": _mpt, "flamingo": _flamingo, "llava": _llava, "blip2": _blip2,
    "mclip": lambda: _jaclip("mclip"), "ja_clip": lambda: _jaclip("ja_clip"), "opt": _opt,
}


def _jax_specs(tree, mesh):
    """path -> (leaf shape, JAX's spec padded to the leaf's dims)."""
    sh = jax_rules(tree, mesh)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    specs = jax.tree.leaves(sh, is_leaf=lambda x: hasattr(x, "spec"))
    out = {}
    for (kp, leaf), s in zip(flat, specs):
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        spec = tuple(s.spec)
        out[path] = (tuple(leaf.shape), spec + (None,) * (len(leaf.shape) - len(spec)))
    return out


def _pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def _by_value(tree):
    """bytes of every layer slice (and its transpose) -> (path, lead dims,
    transposed)."""
    index = {}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for kp, leaf in flat:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        a = np.asarray(leaf)
        for lead in range(a.ndim + 1):
            for idx in np.ndindex(*a.shape[:lead]):
                s = np.ascontiguousarray(a[idx])
                index.setdefault((s.shape, s.tobytes()), (path, lead, False))
                if s.ndim == 2:
                    t = np.ascontiguousarray(s.T)
                    index.setdefault((t.shape, t.tobytes()), (path, lead, True))
    return index


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_shard_decisions_equal_jax(family):
    tree, port = FAMILIES[family]()
    rng = np.random.RandomState(0)
    tree = jax.tree.map(lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), tree)
    model = port(tree)
    jspecs = _jax_specs(jax.tree.map(jax.numpy.asarray, tree), jax_mesh(2, 2, 2))
    index = _by_value(tree)
    ours = param_sharding_rules(model, MESH)
    total = sharded = 0
    for name, p in model.named_parameters():
        v = np.ascontiguousarray(p.detach().numpy())
        hit = index.get((v.shape, v.tobytes()))
        assert hit is not None, f"{family}: no JAX leaf holds {name}'s values"
        path, lead, transposed = hit
        want = jspecs[path][1][lead:]
        if transposed:
            want = want[::-1]
        assert _pad(ours[name], p.dim()) == want, (family, name, path)
        total += v.nbytes
        sharded += v.nbytes if any(a is not None for a in ours[name]) else 0
    assert sharded / total > 0.5, family


@pytest.mark.parametrize("mesh", [(2, 2, 2), (1, 8, 1)], ids=["mesh222", "fsdp8"])
def test_openflamingo_9b_full_tree_decisions_equal_jax(mesh):
    from robustvlm_tpu.models.flamingo import FLAMINGO_CONFIGS, init_flamingo_params
    from robustvlm_tpu_torch.models.flamingo import model as PF

    shapes = jax.eval_shape(lambda k: init_flamingo_params(k, FLAMINGO_CONFIGS["openflamingo-9b"]), K)
    jspecs = _jax_specs(shapes, jax_mesh(*mesh))
    with torch.device("meta"):
        model = PF.Flamingo(PF.FLAMINGO_CONFIGS["openflamingo-9b"])
    shape = dict(zip(("data", "fsdp", "model"), mesh))
    ours = param_sharding_rules(model, shape)
    seen = set()
    for name, p in model.named_parameters():
        path = "/".join(part for part in name.split(".") if not part.isdigit())
        seen.add(path)
        jshape, jspec = jspecs[path]
        lead = len(jshape) - p.dim()
        assert tuple(jshape[lead:]) == tuple(p.shape), name
        assert _pad(ours[name], p.dim()) == jspec[lead:], name
        d = shard_dim(name, tuple(p.shape), shape)
        assert d is None or p.shape[d] % (shape["fsdp"] * shape["model"]) == 0, name
    assert seen == set(jspecs)  # every JAX leaf has its port parameters
    wqkv = ours["mpt.blocks.0.attn.wqkv"]
    assert "fsdp" in wqkv


@pytest.mark.parametrize("rows,want,dim", [(588, (None, None), None), (768, ("fsdp", None), 0)])
def test_fit_spec_replicates_an_indivisible_dim(rows, want, dim):
    """ViT-L/14's (588, 1024) patch embedding on an 8-way fsdp axis stays
    unsharded on its rows (588 = 3 * 14 * 14); (768, 1024) is sharded."""
    mesh = {"data": 1, "fsdp": 8, "model": 1}
    assert param_sharding_rules([("patch_embed", (rows, 1024))], mesh)["patch_embed"] == want
    assert shard_dim("patch_embed", (rows, 1024), mesh) == dim
    jtree = {"patch_embed": jax.ShapeDtypeStruct((rows, 1024), np.float32)}
    jspec = tuple(jax_rules(jtree, jax_mesh(1, 8, 1))["patch_embed"].spec)
    assert _pad(jspec, 2) == want


def test_rules_name_no_axis_beyond_a_parameters_dims():
    from robustvlm_tpu_torch.parallel.mesh import _RULES, _spec_for

    for pat, spec in _RULES:
        assert re.compile(pat)
    with pytest.raises(ValueError):
        _spec_for("llava.projector.w1", 1)  # ("fsdp", "model") on a 1-D tensor
