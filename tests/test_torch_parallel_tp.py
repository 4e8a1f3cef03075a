"""Megatron tensor parallelism of the port (robustvlm_tpu_torch.parallel,
`model` > 1) in gloo worlds on the CPU, float32: the counterpart of the
JAX package's compute split over `model` (tests/test_parallel.py on
make_mesh(data=2, fsdp=2, model=2)), on meshes (1, 1, 2), (1, 2, 2) and
(2, 1, 2), and LLaVA with a 2-kv-head LM (test-tiny-gqa) on (1, 1, 4).

Each world (`_torch_parallel_workers.tp_world`) holds the split model
against the same port model unsplit, in the same rank; here both are held
against JAX's single-device function on the same weights:
- LLaVA's per-sample loss: 1e-5 relative; CLIP image and text embeddings
  (unit vectors), 1e-5 of their largest magnitude;
- LLaVA's pixel gradient, the TeCoA and FARE steps' parameters (SGD, so
  that a parameter's update is its gradient times the rate: Adam's first
  update is lr * sign(g), which float noise in a near-zero gradient flips)
  and their updates: 1e-5 of the tensor's largest magnitude (the
  row-parallel sums reorder the float32 adds, so bits are not asked);
- 5 APGD-CE iterations' robust flags: equal;
- each rank's bytes of each parameter: JAX's `shard_params` bytes on the
  device of the same index of `make_mesh(d, f, m)` (the JAX package's
  virtual CPU devices, conftest);
- the split blocks' attention runs on (B, H/m, N, hd), and block 0's local
  qkv columns are exactly the q, k and v columns of the rank's heads;
- the split model's state_dict is the unsplit layout: it loads into an
  unsplit port model, and through the torch-layout export into JAX, and
  gives the same results;
- test-tiny-gqa at m = 4: the LM blocks (2 kv heads) stay whole, the tower,
  projector and LM head split, and the function is the same.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.attacks.apgd import apgd_attack as jax_apgd
from robustvlm_tpu.models.clip import CLIP_CONFIGS as JAX_CLIP
from robustvlm_tpu.models.clip import init_clip_params
from robustvlm_tpu.models.clip.import_torch import import_visual_state_dict
from robustvlm_tpu.models.clip.model import encode_image as jax_encode_image
from robustvlm_tpu.models.clip.model import encode_text as jax_encode_text
from robustvlm_tpu.models.llama import LLAMA_CONFIGS as JAX_LLAMA
from robustvlm_tpu.models.llava.model import LLAVA_CONFIGS as JAX_LLAVA
from robustvlm_tpu.models.llava.model import init_llava_params, llava_per_sample_loss
from robustvlm_tpu.ops.image import normalize_clip as jax_normalize_clip
from robustvlm_tpu.ops.losses import ce_loss as jax_ce
from robustvlm_tpu.parallel.mesh import make_mesh as jax_mesh
from robustvlm_tpu.parallel.mesh import shard_params as jax_shard_params
from robustvlm_tpu.train import trainer as jt
from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, params_from_jax
from robustvlm_tpu_torch.models.clip.convert import export_visual_state_dict
from robustvlm_tpu_torch.models.llama.model import LLAMA_CONFIGS
from robustvlm_tpu_torch.models.llava import model as PV
from robustvlm_tpu_torch.models.llava.convert import params_from_jax as llava_from_jax

from _torch_parallel_workers import run_world

torch.set_num_threads(1)
JCFG = JAX_CLIP["test-tiny"]
TOL = 1e-5
MESHES = {"mesh112": (1, 1, 2), "mesh122": (1, 2, 2), "mesh212": (2, 1, 2)}
TRAIN_KW = dict(attack="pgd", iterations_adv=2, eps=4 / 255, opt="sgd", lr=0.5, wd=1e-4, warmup=1, steps=10)
TRAIN_CONFIGS = {"tecoa": dict(TRAIN_KW, loss="ce", inner_loss="ce"),
                 "fare": dict(TRAIN_KW, loss="l2", inner_loss="l2")}
SEED = 0


def _inputs():
    key = jax.random.PRNGKey(0)
    rng = np.random.RandomState(0)
    clip_tree = jax.tree.map(np.asarray, init_clip_params(key, JCFG))
    t = rng.randn(JCFG.embed_dim, 10).astype(np.float32)
    temb = t / np.linalg.norm(t, axis=0, keepdims=True)
    clip = {"tree": clip_tree, "x": rng.rand(8, 3, 32, 32).astype(np.float32),
            "tokens": rng.randint(1, 500, (8, 16)), "temb": temb, "y": rng.randint(0, 10, 8)}
    lcfg = JAX_LLAVA["test-tiny"]
    llava = {"tree": jax.tree.map(np.asarray, init_llava_params(key, lcfg)),
             "x": rng.rand(4, 3, 32, 32).astype(np.float32), "tokens": rng.randint(5, 512, (4, 12)),
             "mask": (rng.rand(4, 12) > 0.4).astype(np.float32)}
    tree_orig = jax.tree.map(lambda a: (a + rng.randn(*a.shape).astype(np.float32) * 0.02 if a.ndim else a),
                             clip_tree)
    x = rng.rand(8, 3, 32, 32).astype(np.float32)
    eps = TRAIN_KW["eps"]
    starts = {SEED: np.asarray(jax.random.uniform(jax.random.PRNGKey(0), x.shape, jnp.float32, -eps, eps))}
    train = {"tree": clip_tree, "tree_orig": tree_orig, "x": x, "y": rng.randint(0, 10, 8), "temb": temb,
             "starts": starts, "configs": TRAIN_CONFIGS, "seed": SEED}
    return clip, llava, train


def _gqa_llava(tree_seed=1):
    lcfg = dataclasses.replace(JAX_LLAVA["test-tiny"], llama=JAX_LLAMA["test-tiny-gqa"])
    return lcfg, jax.tree.map(np.asarray, init_llava_params(jax.random.PRNGKey(tree_seed), lcfg))


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module", params=sorted(MESHES))
def world(request, inputs, tmp_path_factory):
    clip, llava, train = inputs
    shape = MESHES[request.param]
    ranks = run_world(tmp_path_factory.mktemp(request.param), int(np.prod(shape)), "tp_world", timeout=120,
                      mesh_shape=shape, clip=clip, llava=llava, train=train)
    return shape, ranks


@pytest.fixture(scope="module")
def gqa_world(inputs, tmp_path_factory):
    clip, llava, _ = inputs
    lcfg, tree = _gqa_llava()
    llava = dict(llava, tree=tree)
    ranks = run_world(tmp_path_factory.mktemp("gqa"), 4, "tp_world", timeout=120, mesh_shape=(1, 1, 4),
                      clip=clip, llava=llava, train=None, lm="test-tiny-gqa")
    return lcfg, llava, ranks


# ------------------------------------------------------------------ JAX references
@pytest.fixture(scope="module")
def jax_clip(inputs):
    clip = inputs[0]
    p = jax.tree.map(jnp.asarray, clip["tree"])
    img = np.asarray(jax_encode_image(p, jax_normalize_clip(jnp.asarray(clip["x"])), JCFG, normalize=True))
    txt = np.asarray(jax_encode_text(p, jnp.asarray(clip["tokens"]), JCFG, normalize=True))
    temb = jnp.asarray(clip["temb"])

    def logits(xa):
        return jax_encode_image(p, jax_normalize_clip(xa), JCFG, normalize=True) @ (100.0 * temb)

    res = jax_apgd(logits, jnp.asarray(clip["x"]), jnp.asarray(clip["y"]),
                   criterion=lambda o, t: jax_ce(o, t, reduction="none"), eps=8 / 255, n_iter=5, norm="linf")
    return {"img": img, "txt": txt, "flags": np.asarray(res.acc)}


def _jax_llava(cfg, tree, d):
    p = jax.tree.map(jnp.asarray, tree)
    tok, mask = jnp.asarray(d["tokens"]), jnp.asarray(d["mask"])

    def f(xx):
        return llava_per_sample_loss(p, xx, tok, tok, tok, mask, cfg, compute_dtype=jnp.float32)

    x = jnp.asarray(d["x"])
    return np.asarray(f(x)), np.asarray(jax.grad(lambda xx: jnp.sum(f(xx)))(x))


@pytest.fixture(scope="module")
def jax_llava(inputs):
    return _jax_llava(JAX_LLAVA["test-tiny"], inputs[1]["tree"], inputs[1])


@pytest.fixture(scope="module")
def jax_train(inputs):
    """The JAX step of each config from the same PGD start: the parameters
    after it, in the port's names."""
    train = inputs[2]
    out = {}
    for name, kw in TRAIN_CONFIGS.items():
        jcfg = jt.TrainConfig(**kw)
        params = jax.tree.map(jnp.asarray, train["tree"])
        opt = jt.make_optimizer(jcfg)
        step = jax.jit(jt.make_train_step(jcfg, JCFG, jnp.asarray(train["temb"])))
        new, _, m = step(params, jax.tree.map(jnp.asarray, train["tree_orig"]), opt.init(params),
                         jnp.asarray(train["x"]), jnp.asarray(train["y"]), jax.random.PRNGKey(0), 0)
        out[name] = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, new)).items()}
    return out


def _jax_bytes(tree, shape):
    """path -> [bytes of JAX's shard on device i of make_mesh(*shape)]."""
    n = int(np.prod(shape))
    mesh = jax_mesh(*shape, devices=jax.devices()[:n])
    placed = jax_shard_params(jax.tree.map(jnp.asarray, tree), mesh)
    devices = list(mesh.devices.flat)
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        by_dev = {s.device: s.data.nbytes for s in leaf.addressable_shards}
        out[path] = [by_dev[d] for d in devices]
    return out


def _held(rec, jax_ref, tol=TOL):
    """Split vs unsplit port and vs JAX: (got, port ref, jax ref) arrays."""
    got, ref = rec
    scale = np.abs(jax_ref).max()
    assert scale > 0 and got.shape == ref.shape == jax_ref.shape
    assert np.abs(got - ref).max() <= tol * scale
    assert np.abs(got - jax_ref).max() <= tol * scale


def _rel(got, want, tol=TOL):
    assert np.all(np.abs(got - want) <= tol * np.abs(want)), np.abs((got - want) / want).max()


def _bytes_equal_jax(rank_bytes, jtree, shape, rank):
    jb = _jax_bytes(jtree, shape)
    ours = {}
    for name, b in rank_bytes.items():
        path = "/".join(part for part in name.split(".") if not part.isdigit())
        ours[path] = ours.get(path, 0) + b
    assert set(ours) == set(jb)
    for path, b in ours.items():
        assert b == jb[path][rank], (path, b, jb[path][rank])


# ------------------------------------------------------------------ tests
def test_clip_embeddings_match_unsplit_and_jax(world, jax_clip):
    for r in world[1]:
        c = r["clip"]
        for k in ("img", "txt"):
            _held((c[k], c[f"ref_{k}"]), jax_clip[k])
        assert all(c["split_blocks"])


def test_clip_apgd_robust_flags_equal(world, jax_clip):
    for r in world[1]:
        assert np.array_equal(r["clip"]["flags"], r["clip"]["ref_flags"])
        assert np.array_equal(r["clip"]["flags"], jax_clip["flags"])


def test_split_attention_runs_on_local_heads(world):
    shape, ranks = world
    m = shape[2]
    rows = 8 // (shape[0] * shape[1])
    for r in ranks:
        # the tower's 4 heads, its 16 + 1 tokens; the text tower's 16 tokens
        assert ("vit_attention", (rows, 4 // m, 17, 16)) in r["clip"]["attention"]
        assert ("flash_attention", (rows, 4 // m, 16, 16)) in r["clip"]["attention"]
        assert all(q[1] == 4 // m for _, q in r["clip"]["attention"])
        assert all(q[1] == 4 // m for _, q in r["llava"]["attention"])
        assert r["clip"]["qkv_local_equal"]


def test_llava_loss_and_pixel_grad_match_unsplit_and_jax(world, jax_llava):
    jloss, jgrad = jax_llava
    for r in world[1]:
        v = r["llava"]
        assert all(v["lm_blocks_split"]) and v["head_split"] and v["projector_split"]
        _rel(v["loss"], v["ref_loss"])
        _rel(v["loss"], jloss)
        _held((v["grad"], v["ref_grad"]), jgrad)


def test_local_bytes_equal_jax_shards(world, inputs):
    shape, ranks = world
    clip, llava, _ = inputs
    for rank, r in enumerate(ranks):
        _bytes_equal_jax(r["clip"]["bytes"], clip["tree"], shape, rank)
        _bytes_equal_jax(r["llava"]["bytes"], llava["tree"], shape, rank)


@pytest.mark.parametrize("name", sorted(TRAIN_CONFIGS))
def test_train_step_matches_unsplit_and_jax(world, inputs, jax_train, name):
    """The parameters after one step, and each parameter's update, within
    1e-5 of their largest magnitude of the single-process port step and of
    JAX's."""
    from _torch_parallel_workers import _patch_pgd_starts
    from robustvlm_tpu_torch.train import trainer as tt

    train = inputs[2]
    start = {k: v.numpy() for k, v in params_from_jax(train["tree"]).items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tt, "pgd_random_start", tt.pgd_random_start)  # restored on exit
        _patch_pgd_starts(train["starts"])
        model, orig = CLIP(CLIP_CONFIGS["test-tiny"]), CLIP(CLIP_CONFIGS["test-tiny"])
        model.load_state_dict(params_from_jax(train["tree"]))
        orig.load_state_dict(params_from_jax(train["tree_orig"]))
        step = tt.TrainStep(tt.TrainConfig(**TRAIN_CONFIGS[name]), model, orig, torch.from_numpy(train["temb"]))
        step(torch.from_numpy(train["x"]), torch.from_numpy(train["y"]), SEED)
    single = {n: p.detach().numpy() for n, p in model.named_parameters()}
    moved = 0.0
    for r in world[1]:
        got = r["train"][name]["params"]
        assert set(got) == set(single)
        for n, v in got.items():
            for want in (single[n], jax_train[name][n]):
                assert np.abs(v - want).max() <= TOL * np.abs(want).max(), n
                upd, want_upd = v - start[n], want - start[n]
                assert np.abs(upd - want_upd).max() <= TOL * max(np.abs(want_upd).max(), 1e-30), n
            moved = max(moved, float(np.abs(v - start[n]).max()))
    assert moved > 1e-3


def test_state_dict_is_the_unsplit_layout(world, inputs, jax_clip, jax_llava):
    clip, llava, _ = inputs
    r = world[1][0]
    sd = {k: torch.from_numpy(v) for k, v in r["clip"]["state"].items()}
    want = params_from_jax(clip["tree"])
    assert set(sd) == set(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    # into an unsplit port model, and through the torch-layout export into JAX
    model = CLIP(CLIP_CONFIGS["test-tiny"])
    model.load_state_dict(sd)
    x = torch.from_numpy(clip["x"])
    from robustvlm_tpu_torch.ops.image import normalize_clip

    with torch.no_grad():
        np.testing.assert_array_equal(model.encode_image(normalize_clip(x), normalize=True).numpy(),
                                      r["clip"]["ref_img"])
    visual = import_visual_state_dict({k: v.numpy() for k, v in export_visual_state_dict(sd, model.cfg).items()},
                                      JCFG)
    jp = dict(jax.tree.map(jnp.asarray, clip["tree"]), visual=jax.tree.map(jnp.asarray, visual))
    img = np.asarray(jax_encode_image(jp, jax_normalize_clip(jnp.asarray(clip["x"])), JCFG, normalize=True))
    np.testing.assert_allclose(img, jax_clip["img"], rtol=0, atol=TOL * np.abs(jax_clip["img"]).max())

    lsd = {k: torch.from_numpy(v) for k, v in r["llava"]["state"].items()}
    lm = PV.Llava.from_state(PV.LLAVA_CONFIGS["test-tiny"], lsd)
    t, mk = torch.from_numpy(llava["tokens"]), torch.from_numpy(llava["mask"])
    loss = PV.llava_per_sample_loss(lm, torch.from_numpy(llava["x"]), t, t, t, mk, compute_dtype=torch.float32)
    np.testing.assert_array_equal(loss.numpy(), r["llava"]["ref_loss"])
    _rel(loss.numpy(), jax_llava[0])


def test_gqa_at_model4_keeps_lm_blocks_whole(gqa_world, inputs):
    lcfg, llava, ranks = gqa_world
    jloss, jgrad = _jax_llava(lcfg, llava["tree"], llava)
    assert LLAMA_CONFIGS["test-tiny-gqa"].n_kv_heads % 4 != 0
    for rank, r in enumerate(ranks):
        v = r["llava"]
        assert not any(v["lm_blocks_split"]) and v["head_split"] and v["projector_split"]
        # the LM's attention stays whole (4 heads); the tower's splits (1 head)
        heads = {(n, q[1]) for n, q in v["attention"]}
        assert ("flash_attention", 4) in heads and ("vit_attention", 1) in heads
        _rel(v["loss"], v["ref_loss"])
        _rel(v["loss"], jloss)
        _held((v["grad"], v["ref_grad"]), jgrad)
        _bytes_equal_jax(v["bytes"], llava["tree"], (1, 1, 4), rank)
