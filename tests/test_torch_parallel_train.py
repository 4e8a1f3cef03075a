"""Data-parallel, HSDP and TP+FSDP training steps of the port
(robustvlm_tpu_torch.parallel + train.trainer) in a 4-rank gloo world on
the CPU, against the port's single-process step and the JAX package's
single-device step (the counterpart of tests/test_parallel.py's
TestMesh and TestDataParallelTrainStep).

Tolerances:
- the data-parallel step's loss within 1e-6 relative of the port's
  single-process step (the reductions run in another order), within 1e-4
  of JAX's (JAX's own bound, tests/test_parallel.py);
- parameters within 2 * lr of both (Adam's first update is about
  lr * sign(g), so float noise in a near-zero gradient moves an element by
  up to 2 * lr: JAX's own bound);
- both sides attack from JAX's PGD starts (the port's draw is patched in
  the ranks and here), so the loss comparison with JAX is of one start.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from robustvlm_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS
from robustvlm_tpu.models.clip import init_clip_params
from robustvlm_tpu.train import trainer as jt
from robustvlm_tpu_torch.attacks.apgd import fold_in
from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, params_from_jax
from robustvlm_tpu_torch.train import trainer as tt

from _torch_parallel_workers import _patch_pgd_starts, run_world

torch.set_num_threads(1)
JCFG = JAX_CONFIGS["test-tiny"]
CFG_KW = dict(loss="l2", inner_loss="l2", attack="pgd", iterations_adv=2, eps=4 / 255, warmup=2,
              steps=10, lr=1e-3)
ACCUMS = (1, 2)
SEED = 0


def _jax_starts(x, k):
    """JAX's PGD starts of one step at PRNGKey(0), keyed by the port's seed
    of each chunk (`SEED`, or `fold_in(SEED, i)` with grad_accum k)."""
    key, eps = jax.random.PRNGKey(0), CFG_KW["eps"]
    if k == 1:
        return {SEED: np.asarray(jax.random.uniform(key, x.shape, jnp.float32, -eps, eps))}
    keys = jax.random.split(key, k)
    shape = (x.shape[0] // k, *x.shape[1:])
    return {fold_in(SEED, i): np.asarray(jax.random.uniform(keys[i], shape, jnp.float32, -eps, eps))
            for i in range(k)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tree = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(0), JCFG))
    rng = np.random.RandomState(0)
    tree_orig = jax.tree.map(lambda a: (a + rng.randn(*a.shape).astype(np.float32) * 0.02
                                        if a.ndim else a), tree)
    x = rng.rand(8, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 8)
    t = rng.randn(JCFG.embed_dim, 10).astype(np.float32)
    temb = t / np.linalg.norm(t, axis=0, keepdims=True)
    starts = {s: a for k in ACCUMS for s, a in _jax_starts(x, k).items()}
    ranks = run_world(tmp_path_factory.mktemp("train"), 4, "train_world", tree=tree, tree_orig=tree_orig,
                      x=x, y=y, temb=temb, cfg_kw=CFG_KW, starts=starts, accums=ACCUMS, seed=SEED)
    return dict(tree=tree, tree_orig=tree_orig, x=x, y=y, temb=temb, starts=starts, ranks=ranks)


def _single_port(w, k):
    model, orig = CLIP(CLIP_CONFIGS["test-tiny"]), CLIP(CLIP_CONFIGS["test-tiny"])
    model.load_state_dict(params_from_jax(w["tree"]))
    orig.load_state_dict(params_from_jax(w["tree_orig"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tt, "pgd_random_start", tt.pgd_random_start)  # restored on exit
        _patch_pgd_starts(w["starts"])
        step = tt.TrainStep(tt.TrainConfig(**CFG_KW, grad_accum=k), model, orig, torch.from_numpy(w["temb"]))
        m = step(torch.from_numpy(w["x"]), torch.from_numpy(w["y"]), SEED)
    return {n: float(v) for n, v in m.items()}, {n: p.detach().numpy() for n, p in model.named_parameters()}


def _single_jax(w, k):
    jcfg = jt.TrainConfig(**CFG_KW, grad_accum=k)
    params = jax.tree.map(jnp.asarray, w["tree"])
    opt = jt.make_optimizer(jcfg)
    step = jax.jit(jt.make_train_step(jcfg, JCFG, jnp.asarray(w["temb"])))
    new, _, m = step(params, jax.tree.map(jnp.asarray, w["tree_orig"]), opt.init(params),
                     jnp.asarray(w["x"]), jnp.asarray(w["y"]), jax.random.PRNGKey(0), 0)
    return {n: float(v) for n, v in m.items()}, params_from_jax(jax.tree.map(np.asarray, new))


def test_mesh_shapes_and_mismatch_raises(world):
    r = world["ranks"][0]
    assert r["mesh_default"] == {"data": 4, "fsdp": 1, "model": 1}
    assert r["mesh_122"] == {"data": 1, "fsdp": 2, "model": 2}
    assert r["mesh_bad_raises"]


def test_no_process_group_mesh_is_one_device():
    from robustvlm_tpu_torch.parallel.mesh import batch_sharding, make_mesh

    m = make_mesh(device="cpu")
    assert m.shape == {"data": 1, "fsdp": 1, "model": 1} and not m.distributed
    x = torch.arange(8.0)
    assert batch_sharding(m, x) is not None and torch.equal(batch_sharding(m, x, chunks=2), x)
    with pytest.raises(ValueError):
        make_mesh(data=2, device="cpu")


@pytest.mark.parametrize("k", ACCUMS, ids=[f"grad_accum{k}" for k in ACCUMS])
def test_dp_step_matches_single_process_and_jax(world, k):
    lr = CFG_KW["lr"]
    ranks = [r[f"dp{k}"] for r in world["ranks"]]
    pm, pp = _single_port(world, k)
    jm, jp = _single_jax(world, k)
    for r in ranks:
        assert r["metrics"]["loss"] == pytest.approx(pm["loss"], rel=1e-6)
        assert r["metrics"]["loss"] == pytest.approx(jm["loss"], rel=1e-4)
        assert set(r["metrics"]) == set(pm)
        for n, v in r["params"].items():
            assert np.abs(v - ranks[0]["params"][n]).max() == 0.0, n  # replicas stay equal
            assert np.abs(v - pp[n]).max() < 2 * lr, n
            assert np.abs(v - jp[n].numpy()).max() < 2 * lr, n
    start = params_from_jax(world["tree"])
    assert max(np.abs(v - start[n].numpy()).max() for n, v in ranks[0]["params"].items()) > lr / 2


def test_hsdp_step_matches_single_process(world):
    """Parameters split over model = 2 (Megatron heads) and replicated over
    data = 2: FSDP2 all-reduces the sharded gradients over data itself, the
    trainer the replicated ones; the step is the single-process one."""
    lr = CFG_KW["lr"]
    pm, pp = _single_port(world, 1)
    for r in world["ranks"]:
        h = r["hsdp"]
        # (data: replicated, fsdp: dim 0 of size 1, model: the qkv columns of 2 of the 4 heads)
        assert h["placements"]["visual.blocks.0.attn.qkv_w"] == ((None, 0, 1), (64, 96))
        assert h["metrics"]["loss"] == pytest.approx(pm["loss"], rel=1e-6)
        for n, v in h["params"].items():
            assert np.abs(v - pp[n]).max() < 2 * lr, n


def test_tp_fsdp_step_keeps_its_sharding(world):
    from robustvlm_tpu_torch.parallel.mesh import param_sharding_rules

    specs = param_sharding_rules(CLIP(CLIP_CONFIGS["test-tiny"]), {"data": 1, "fsdp": 2, "model": 2})
    for r in world["ranks"]:
        tp = r["tp_fsdp"]
        assert np.isfinite(tp["loss"]) and tp["finite"]
        assert tp["before"] == tp["after"]
        # JAX's (fsdp, model) and (model, fsdp): FSDP2 on the fsdp dim, the
        # `model` split on the heads' columns and the out projection's rows
        assert tp["after"]["visual.blocks.0.attn.qkv_w"] == ((0, 1), (32, 96))
        assert tp["after"]["visual.blocks.0.attn.out_w"] == ((1, 0), (32, 32))
        # the parameters JAX shards are DTensors; JAX's replicated ones stay whole
        assert set(tp["after"]) == {n for n, s in specs.items() if any(a is not None for a in s)}
