"""Megatron tensor parallelism over `model` for the VLM families beside
LLaVA-LLaMA (tests/test_torch_parallel_tp.py), in gloo worlds on the CPU,
float32: LLaVA-MPT (`test-tiny-mpt`), OpenFlamingo (`test-tiny`, both gates of every block
opened to 0.5, two media slots a row) and BLIP-2 (`test-tiny`), on meshes
(1, 1, 2) and (1, 2, 2), OpenFlamingo also on (2, 1, 2), and OpenFlamingo
and BLIP-2 on (1, 1, 4), where the 2-head Perceiver attention, gated
cross-attention and Q-Former attention stay whole while the 4-head MPT and
OPT blocks split.

Each world (`_torch_parallel_workers.tp_family_world`) holds the split
model against the same port model unsplit, in the same rank; here both
are held against JAX's single-device function on the same weights:
- the per-sample loss: 1e-5 relative; its pixel gradient: 1e-5 of its
  largest magnitude (the row-parallel sums reorder float32 adds, so bits
  are not asked);
- greedy tokens (and OpenFlamingo's 3-beam tokens) through the eval
  adapters' `_decode_fns_of`, whose caches hold the rank's heads: exactly;
- OpenFlamingo's 5 APGD-CE iterations on the two-caption logits
  -loss(caption): robust flags equal;
- a split MPT block's flash calls run on (B, H/m, T, hd) with this rank's
  slice of `alibi_slopes(H)`, and block 0's local wqkv columns are exactly
  the q, k and v columns of the rank's heads; a split Perceiver's and
  cross-attention's local to_kv columns are the k and v columns of its
  heads;
- each rank's bytes of each parameter: JAX's `shard_params` bytes on the
  device of the same index of `make_mesh(d, f, m)` (the JAX package's
  virtual CPU devices, conftest);
- the split model's state_dict is the unsplit layout: it loads into an
  unsplit port model, which gives the unsplit loss bit for bit.
And `flash_attention` refuses an ALiBi slope vector whose length is not H.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.attacks.apgd import apgd_attack as jax_apgd
from robustvlm_tpu.models import generation as JG
from robustvlm_tpu.models.blip2 import model as JB
from robustvlm_tpu.models.flamingo import model as JF
from robustvlm_tpu.models.llava import model as JV
from robustvlm_tpu.ops.losses import ce_loss as jax_ce
from robustvlm_tpu_torch.models.blip2 import model as PB
from robustvlm_tpu_torch.models.blip2.convert import params_from_jax as blip2_from_jax
from robustvlm_tpu_torch.models.flamingo import convert as PC
from robustvlm_tpu_torch.models.flamingo import model as PF
from robustvlm_tpu_torch.models.llava import model as PV
from robustvlm_tpu_torch.models.llava.convert import params_from_jax as llava_from_jax
from robustvlm_tpu_torch.models.mpt.model import MPT_CONFIGS, alibi_slopes
from robustvlm_tpu_torch.ops.kernels.flash_attention import flash_attention

from _torch_parallel_workers import GEN_NEW, run_world
from test_torch_parallel_rules import _by_value
from test_torch_parallel_tp import _held, _jax_bytes, _rel

torch.set_num_threads(1)
MEDIA = 511  # WordTokenizer(512).media_token_id
K = jax.random.PRNGKey(0)
LCFG = JV.LLAVA_CONFIGS["test-tiny-mpt"]
FCFG = dataclasses.replace(JF.FLAMINGO_CONFIGS["test-tiny"], media_token_id=MEDIA)
BCFG = JB.BLIP2_CONFIGS["test-tiny"]
MESHES = {"mesh112": (1, 1, 2), "mesh122": (1, 2, 2), "mesh212": (2, 1, 2), "mesh114": (1, 1, 4)}
MESH_FAMILIES = {"mesh112": ("llava_mpt", "flamingo", "blip2"), "mesh122": ("llava_mpt", "flamingo", "blip2"),
                 "mesh212": ("flamingo",), "mesh114": ("flamingo", "blip2")}
# the meshes on which every module of the family splits
APGD_EPS = 0.5 / 255  # the two-caption margins are a few tenths: some rows flip, some hold
SPLIT_MESHES = {"llava_mpt": ("mesh112", "mesh122"), "flamingo": ("mesh112", "mesh122", "mesh212"),
                "blip2": ("mesh112", "mesh122")}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flamingo_tree():
    tree = jax.jit(JF.init_flamingo_params, static_argnums=1)(K, FCFG)
    for gate in ("attn_gate", "ff_gate"):
        tree["xattn"][gate] = jnp.full_like(tree["xattn"][gate], 0.5)
    return _np_tree(tree)


def _inputs():
    rng = np.random.RandomState(0)

    def mask(b, t, lo):
        m = (rng.rand(b, t) > 0.3).astype(np.float32)
        m[:, :lo] = 0.0
        m[:, -1] = 1.0
        return m

    llava = {"tree": _np_tree(JV.init_llava_params(K, LCFG)), "x": rng.rand(4, 3, 32, 32).astype(np.float32),
             "pre": rng.randint(3, 500, (4, 5)), "post": rng.randint(3, 500, (4, 9)), "mask": mask(4, 9, 1),
             "gen_x": rng.rand(2, 3, 32, 32).astype(np.float32), "gen_pre": rng.randint(3, 500, (2, 5)),
             "seqs": [[5, 6, 7, 8, 9, 10, 11], [12, 13]]}
    lang = rng.randint(3, 500, (4, 10))
    lang[:, [0, 5]] = MEDIA
    lang[2:, [0, 5]] = lang[2:, [2, 7]]
    lang[2:, [2, 7]] = MEDIA
    # APGD: two captions that differ in their last token, the only one
    # scored; labels are each model's clean predictions
    arng = np.random.RandomState(5)
    lang_a = arng.randint(3, 500, (4, 8))
    lang_a[:, 0] = MEDIA
    lang_b = lang_a.copy()
    lang_b[:, -1] = arng.randint(3, 500, 4)
    last = np.zeros((4, 8), np.float32)
    last[:, -1] = 1.0
    apgd = {"lang_a": lang_a, "lang_b": lang_b, "mask_a": last, "mask_b": last, "eps": APGD_EPS,
            "x": arng.rand(4, 3, 32, 32).astype(np.float32)}
    flamingo = {"tree": _flamingo_tree(), "media": MEDIA, "vx": rng.rand(4, 2, 1, 3, 32, 32).astype(np.float32),
                "lang": lang, "mask": mask(4, 10, 1), "gen_vx": rng.rand(2, 1, 1, 3, 32, 32).astype(np.float32),
                "seqs": [[MEDIA, 5, 6, 7, 8], [MEDIA, 9, 10]],
                "apgd": apgd}
    blip2 = {"tree": _np_tree(JB.init_blip2_params(K, BCFG)), "x": rng.rand(4, 3, 32, 32).astype(np.float32),
             "tokens": rng.randint(5, BCFG.opt.vocab_size, (4, 8)), "mask": mask(4, 8, 2),
             "gen_x": rng.rand(2, 3, 32, 32).astype(np.float32), "seqs": [[1, 5, 6, 7, 8], [1, 9, 10]]}
    return {"llava_mpt": llava, "flamingo": flamingo, "blip2": blip2}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """mesh name -> (shape, per-rank results): every world once."""
    out = {}
    for name, shape in MESHES.items():
        fams = {f: inputs[f] for f in MESH_FAMILIES[name]}
        out[name] = shape, run_world(tmp_path_factory.mktemp(name), int(np.prod(shape)), "tp_family_world",
                                     timeout=240, mesh_shape=shape, families=fams)
    return out


@pytest.fixture
def world(worlds, request):
    return worlds[request.param]


def _worlds(family):
    return pytest.mark.parametrize("world", [m for m in MESHES if family in MESH_FAMILIES[m]], indirect=True)


# ------------------------------------------------------------------ JAX references
def _generate(pf, df, seqs, beams):
    jt, jn = map(jnp.asarray, JG.left_pad(seqs, pad_id=0))
    kw = dict(max_new_tokens=GEN_NEW, eos_id=2, pad_id=0)
    if beams == 1:
        return np.asarray(JG.greedy_generate(pf, df, jt, jn, **kw).tokens)
    return np.asarray(JG.beam_generate(pf, df, jt, jn, num_beams=beams, length_penalty=1.0, **kw).tokens)


def _loss_and_grad(f, x):
    x = jnp.asarray(x)
    return np.asarray(f(x)), np.asarray(jax.grad(lambda xx: jnp.sum(f(xx)))(x))


@pytest.fixture(scope="module")
def jax_llava_mpt(inputs):
    d = inputs["llava_mpt"]
    p = jax.tree.map(jnp.asarray, d["tree"])
    pre, post, mask = (jnp.asarray(d[k]) for k in ("pre", "post", "mask"))
    loss, grad = _loss_and_grad(lambda xx: JV.llava_per_sample_loss(p, xx, pre, post, post, mask, LCFG,
                                                                    compute_dtype=jnp.float32), d["x"])
    total = max(len(s) for s in d["seqs"]) + GEN_NEW
    pf, df = JV.make_llava_decode_fns(p, LCFG, jnp.asarray(d["gen_x"]), jnp.asarray(d["gen_pre"]),
                                      max_total_len=total, compute_dtype=jnp.float32)
    return {"loss": loss, "grad": grad, "tokens": _generate(pf, df, d["seqs"], 1)}


@pytest.fixture(scope="module")
def jax_flamingo(inputs):
    d = inputs["flamingo"]
    p = jax.tree.map(jnp.asarray, d["tree"])
    lang, mask = jnp.asarray(d["lang"]), jnp.asarray(d["mask"])

    def loss(vx, la, ma):
        return JF.flamingo_per_sample_loss(p, vx, la, la, ma, FCFG, compute_dtype=jnp.float32)

    out = dict(zip(("loss", "grad"), _loss_and_grad(jax.jit(lambda vx: loss(vx, lang, mask)), d["vx"])))
    total = max(len(s) for s in d["seqs"]) + GEN_NEW
    for beams in (1, 3):
        pf, df = JF.make_flamingo_decode_fns(p, FCFG, jnp.asarray(d["gen_vx"]), max_total_len=total,
                                             compute_dtype=jnp.float32)
        out[f"tokens{beams}"] = _generate(pf, df, d["seqs"], beams)
    a = d["apgd"]
    pairs = [(jnp.asarray(a[f"lang_{c}"]), jnp.asarray(a[f"mask_{c}"])) for c in "ab"]

    @jax.jit
    def logits(xa):
        return -jnp.stack([loss(xa[:, None, None], la, ma) for la, ma in pairs], axis=-1)

    x = jnp.asarray(a["x"])
    out["y"] = np.asarray(jnp.argmax(logits(x), axis=-1))
    res = jax_apgd(logits, x, jnp.asarray(out["y"]), criterion=lambda o, t: jax_ce(o, t, reduction="none"),
                   eps=a["eps"], n_iter=5, norm="linf")
    out["flags"] = np.asarray(res.acc)
    return out


@pytest.fixture(scope="module")
def jax_blip2(inputs):
    d = inputs["blip2"]
    p = jax.tree.map(jnp.asarray, d["tree"])
    tok, mask = jnp.asarray(d["tokens"]), jnp.asarray(d["mask"])
    loss, grad = _loss_and_grad(lambda xx: JB.blip2_per_sample_loss(p, xx, tok, tok, mask, BCFG,
                                                                    compute_dtype=jnp.float32), d["x"])
    total = max(len(s) for s in d["seqs"]) + GEN_NEW
    pf, df = JB.make_blip2_decode_fns(p, BCFG, jnp.asarray(d["gen_x"]), max_total_len=total)
    return {"loss": loss, "grad": grad, "tokens": _generate(pf, df, d["seqs"], 1)}


_PATHS, _BYTES = {}, {}


def _port_paths(tree, build) -> dict:
    """port parameter name -> the JAX leaf path that holds it, found by value
    on a redraw of `tree` (every value unique) carried across by `build`."""
    rng = np.random.RandomState(1)
    drawn = jax.tree.map(lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), tree)
    index = _by_value(drawn)
    out = {}
    for name, p in build(drawn).named_parameters():
        v = np.ascontiguousarray(p.detach().numpy())
        out[name] = index[(v.shape, v.tobytes())][0]
    return out


def bytes_equal_jax(family, rank_bytes, tree, build, shape, rank):
    """Each JAX leaf's bytes on device `rank` of make_mesh(*shape) equal the
    bytes this rank holds of the port parameters cut from it."""
    if family not in _PATHS:
        _PATHS[family] = _port_paths(tree, build)
    if (family, shape) not in _BYTES:
        _BYTES[family, shape] = _jax_bytes(tree, shape)
    paths, jb = _PATHS[family], _BYTES[family, shape]
    ours = {}
    for name, b in rank_bytes.items():
        ours[paths[name]] = ours.get(paths[name], 0) + b
    assert set(ours) == set(jb)
    for path, b in ours.items():
        assert b == jb[path][rank], (path, b, jb[path][rank])


FROM_STATE = {
    "llava_mpt": lambda sd: PV.Llava.from_state(PV.LLAVA_CONFIGS["test-tiny-mpt"], sd),
    "flamingo": lambda sd: PF.Flamingo.from_state(
        dataclasses.replace(PF.FLAMINGO_CONFIGS["test-tiny"], media_token_id=MEDIA), sd),
    "blip2": lambda sd: PB.Blip2.from_state(PB.BLIP2_CONFIGS["test-tiny"], sd),
}
FROM_JAX = {"llava_mpt": llava_from_jax, "flamingo": PC.params_from_jax, "blip2": blip2_from_jax}


def _build(family, tree):
    return FROM_STATE[family](FROM_JAX[family](tree))


def _loss_held(v, ref):
    _rel(v["loss"], v["ref_loss"])
    _rel(v["loss"], ref["loss"])
    _held((v["grad"], v["ref_grad"]), ref["grad"])


# ------------------------------------------------------------------ tests
def test_flash_attention_refuses_slopes_not_one_per_head():
    q = torch.randn(2, 4, 8, 16)
    slopes = torch.from_numpy(alibi_slopes(8))
    with pytest.raises(ValueError, match="8 alibi_slopes for 4 heads"):
        flash_attention(q, q, q, causal=True, alibi_slopes=slopes)
    out = flash_attention(q, q, q, causal=True, alibi_slopes=slopes[:4])
    assert out.shape == q.shape


@_worlds("llava_mpt")
def test_llava_mpt_loss_and_pixel_grad_match_unsplit_and_jax(world, jax_llava_mpt):
    for r in world[1]:
        v = r["llava_mpt"]
        assert all(v["split"]["vision"]) and all(v["split"]["lm"]) and v["split"]["projector"]
        _loss_held(v, jax_llava_mpt)


@_worlds("llava_mpt")
def test_llava_mpt_greedy_tokens_equal_jax(world, jax_llava_mpt):
    for r in world[1]:
        np.testing.assert_array_equal(r["llava_mpt"]["tokens"], r["llava_mpt"]["ref_tokens"])
        np.testing.assert_array_equal(r["llava_mpt"]["tokens"], jax_llava_mpt["tokens"])


@pytest.mark.parametrize("family", ["llava_mpt", "flamingo"])
@pytest.mark.parametrize("world", ["mesh112", "mesh122"], indirect=True)
def test_split_mpt_blocks_take_their_heads_and_slopes(world, family):
    """Every flash call of a split MPT block runs on the rank's H/m heads with
    the rank's slice of alibi_slopes(H) (not alibi_slopes(H/m)); block 0's
    local wqkv columns are the rank's q, k and v columns (LLaVA-MPT)."""
    shape, ranks = world
    m, h = shape[2], MPT_CONFIGS["test-tiny"].n_heads
    rows = 4 // (shape[0] * shape[1])
    full = alibi_slopes(h)
    for r in ranks:
        calls = r[family]["spy"]
        mi = r["coords"][2]
        want = full[mi * h // m:(mi + 1) * h // m].tolist()
        assert calls and want != alibi_slopes(h // m).tolist()
        for q_shape, slopes in calls:
            assert q_shape[:2] == (rows, h // m)
            assert slopes == want
        if family == "llava_mpt":
            assert r[family]["wqkv_local_equal"]


@_worlds("flamingo")
def test_flamingo_loss_and_pixel_grad_match_unsplit_and_jax(world, jax_flamingo):
    shape, ranks = world
    for r in ranks:
        v = r["flamingo"]
        s = v["split"]
        whole_attn = FCFG.resampler_heads % shape[2] != 0
        assert all(s["vision"]) and all(s["lm"]) and all(s["perceiver_ff"]) and all(s["xattn_ff"])
        assert all(not x if whole_attn else x for x in s["perceiver_attn"] + s["xattn_attn"])
        _loss_held(v, jax_flamingo)


@pytest.mark.parametrize("beams", [1, 3])
@_worlds("flamingo")
def test_flamingo_tokens_equal_jax(world, jax_flamingo, beams):
    for r in world[1]:
        np.testing.assert_array_equal(r["flamingo"][f"tokens{beams}"], r["flamingo"][f"ref_tokens{beams}"])
        np.testing.assert_array_equal(r["flamingo"][f"tokens{beams}"], jax_flamingo[f"tokens{beams}"])


@_worlds("flamingo")
def test_flamingo_apgd_robust_flags_equal(world, jax_flamingo):
    assert 0 < jax_flamingo["flags"].sum() < len(jax_flamingo["flags"])  # the attack flips some rows
    for r in world[1]:
        np.testing.assert_array_equal(r["flamingo"]["y"], jax_flamingo["y"])
        assert np.array_equal(r["flamingo"]["flags"], r["flamingo"]["ref_flags"])
        assert np.array_equal(r["flamingo"]["flags"], jax_flamingo["flags"])


@pytest.mark.parametrize("world", list(SPLIT_MESHES["flamingo"]), indirect=True)
def test_flamingo_local_to_kv_is_the_ranks_k_and_v_columns(world):
    for r in world[1]:
        assert r["flamingo"]["to_kv_local_equal"] == [True, True]


@_worlds("blip2")
def test_blip2_loss_and_pixel_grad_match_unsplit_and_jax(world, jax_blip2):
    shape, ranks = world
    for r in ranks:
        v = r["blip2"]
        s = v["split"]
        whole = BCFG.qformer.heads % shape[2] != 0  # also EVA's 2 heads
        assert all(s["lm"]) and s["lm_head"] and s["projection"] and all(s["qformer_ffn"])
        assert all(not x if whole else x for x in s["qformer_attn"] + s["vision"])
        _loss_held(v, jax_blip2)


@_worlds("blip2")
def test_blip2_greedy_tokens_equal_jax(world, jax_blip2):
    for r in world[1]:
        np.testing.assert_array_equal(r["blip2"]["tokens"], r["blip2"]["ref_tokens"])
        np.testing.assert_array_equal(r["blip2"]["tokens"], jax_blip2["tokens"])


@pytest.mark.parametrize("world,family", [(m, f) for m in MESHES for f in MESH_FAMILIES[m]], indirect=["world"])
def test_local_bytes_equal_jax_shards(world, inputs, family):
    shape, ranks = world
    for rank, r in enumerate(ranks):
        bytes_equal_jax(family, r[family]["bytes"], inputs[family]["tree"], lambda t: _build(family, t), shape,
                        rank)


@pytest.mark.parametrize("world", ["mesh122"], indirect=True)
def test_split_state_dict_loads_unsplit(world, inputs):
    """Rank 0's state_dict of each split model holds JAX's values in the
    unsplit layout and gives the unsplit loss, bit for bit."""
    r = world[1][0]
    f32 = torch.float32
    losses = {
        "llava_mpt": lambda m, d: PV.llava_per_sample_loss(m, *(torch.from_numpy(d[k]) for k in ("x", "pre", "post",
                                                                                                   "post", "mask")),
                                                           compute_dtype=f32),
        "flamingo": lambda m, d: PF.flamingo_per_sample_loss(m, *(torch.from_numpy(d[k]) for k in
                                                                  ("vx", "lang", "lang", "mask")), compute_dtype=f32),
        "blip2": lambda m, d: PB.blip2_per_sample_loss(m, *(torch.from_numpy(d[k]) for k in
                                                            ("x", "tokens", "tokens", "mask")), compute_dtype=f32),
    }
    for family, loss in losses.items():
        d = inputs[family]
        sd = {k: torch.from_numpy(v) for k, v in r[family]["state"].items()}
        want = FROM_JAX[family](d["tree"])
        assert set(sd) == set(want)
        for k, v in want.items():
            assert torch.equal(sd[k], v), (family, k)
        with torch.no_grad():
            got = loss(FROM_STATE[family](sd), d)
        np.testing.assert_array_equal(got.numpy(), r[family]["ref_loss"])
