"""Sharded attacks and sharded VLM parameters of the port
(robustvlm_tpu_torch.parallel) in a 4-rank gloo world on the CPU: the
counterpart of tests/test_parallel.py's TestShardedAttack and its sharded
LLaVA / BLIP-2 / mclip cases.

- `shard_attack` APGD on a data = 4 mesh, with and without `params=`:
  within 2e-5 of the single-process port, robust flags equal JAX's;
- pixel gradients of tiny LLaVA and BLIP-2 sharded over (1, 2, 2), float32:
  the per-sample loss within 1e-6 relative and the gradient within 1e-6 of
  its largest element of the same port model unsharded, and within 1e-5
  (both) of JAX's unsharded function (the family tests' bound);
- mclip's text embedding sharded over (1, 2, 2): 1e-6 of the unsharded
  port, 1e-5 of JAX, unit norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.attacks.apgd import apgd_attack as jax_apgd
from robustvlm_tpu.models import mclip as JM
from robustvlm_tpu.models.blip2 import model as JB
from robustvlm_tpu.models.llava.model import LLAVA_CONFIGS as JV
from robustvlm_tpu.models.llava.model import init_llava_params, llava_per_sample_loss
from robustvlm_tpu.ops.losses import ce_loss as jax_ce
from robustvlm_tpu_torch.attacks.apgd import apgd_attack
from robustvlm_tpu_torch.ops.losses import ce_loss

from _torch_parallel_workers import run_world

torch.set_num_threads(1)


def _apgd_inputs():
    rng = np.random.RandomState(0)
    w = (rng.randn(3 * 8 * 8, 5).astype(np.float32) * 0.1).astype(np.float32)
    x = rng.rand(16, 3, 8, 8).astype(np.float32)
    y = np.argmax(x.reshape(16, -1) @ w, -1)
    return {"w": w, "x": x, "y": y}


def _vlm_inputs(params, vocab, t, seed=0):
    rng = np.random.RandomState(seed)
    return {"params": jax.tree.map(np.asarray, params),
            "x": rng.rand(8, 3, 32, 32).astype(np.float32),
            "tokens": rng.randint(5, vocab, (8, t)),
            "mask": (rng.rand(8, t) > 0.4).astype(np.float32)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    lcfg = JV["test-tiny"]
    bcfg = JB.BLIP2_CONFIGS["test-tiny"]
    mcfg = JM.MCLIP_CONFIGS["test-tiny-mclip"]
    key = jax.random.PRNGKey(0)
    llava = _vlm_inputs(init_llava_params(key, lcfg), lcfg.llama.vocab_size, 12)
    blip2 = _vlm_inputs(JB.init_blip2_params(key, bcfg), bcfg.opt.vocab_size, 8)
    rng = np.random.RandomState(0)
    mclip = {"params": jax.tree.map(np.asarray, JM.init_mclip_params(key, mcfg)),
             "ids": rng.randint(5, mcfg.text.vocab_size, (8, 12)), "mask": np.ones((8, 12), np.int64)}
    apgd = _apgd_inputs()
    ranks = run_world(tmp_path_factory.mktemp("models"), 4, "models_world", llava_tree=llava,
                      blip2_tree=blip2, mclip_tree=mclip, apgd=apgd)
    return dict(ranks=ranks, llava=llava, blip2=blip2, mclip=mclip, apgd=apgd,
                cfgs=dict(llava=lcfg, blip2=bcfg, mclip=mcfg))


@pytest.mark.parametrize("form", ["apgd", "apgd_params"])
def test_shard_attack_apgd_matches_single_process(world, form):
    a = world["apgd"]
    w, x, y = (torch.from_numpy(a[k]) for k in ("w", "x", "y"))
    single = apgd_attack(lambda t: t.reshape(t.shape[0], -1) @ w, x, y,
                         criterion=lambda o, t: ce_loss(o, t, reduction="none"),
                         eps=8 / 255, n_iter=8, norm="linf").x_best_adv.numpy()
    jw = jnp.asarray(a["w"])
    jres = jax_apgd(lambda t: t.reshape(t.shape[0], -1) @ jw, jnp.asarray(a["x"]), jnp.asarray(a["y"]),
                    criterion=lambda o, t: jax_ce(o, t, reduction="none"), eps=8 / 255, n_iter=8, norm="linf")
    jax_robust = np.argmax(np.asarray(jres.x_best_adv).reshape(16, -1) @ a["w"], -1) == a["y"]
    for r in world["ranks"]:
        got = r[form]
        assert got.shape == single.shape
        np.testing.assert_allclose(got, single, atol=2e-5, rtol=0)
        robust = np.argmax(got.reshape(16, -1) @ a["w"], -1) == a["y"]
        assert np.array_equal(robust, jax_robust)


def _held(rec, jloss, jgrad):
    (rl, rg), (gl, gg) = rec["ref"], rec["got"]
    assert rec["sharded"], "no parameter was sharded"
    assert gl.shape == rl.shape and gg.shape == rg.shape
    assert np.abs(gl - rl).max() <= 1e-6 * np.abs(rl).max()
    assert np.abs(gg - rg).max() <= 1e-6 * np.abs(rg).max()
    assert float(np.abs(rg).max()) > 0.0
    assert np.abs(gl - jloss).max() <= 1e-5 * np.abs(jloss).max()
    assert np.abs(gg - jgrad).max() <= 1e-5 * np.abs(jgrad).max()


def test_sharded_llava_pixel_grad_matches_unsharded_and_jax(world):
    d, cfg = world["llava"], world["cfgs"]["llava"]
    p = jax.tree.map(jnp.asarray, d["params"])
    tok, mask = jnp.asarray(d["tokens"]), jnp.asarray(d["mask"])

    def f(xx):
        return llava_per_sample_loss(p, xx, tok, tok, tok, mask, cfg, compute_dtype=jnp.float32)

    x = jnp.asarray(d["x"])
    jloss, jgrad = np.asarray(f(x)), np.asarray(jax.grad(lambda xx: jnp.sum(f(xx)))(x))
    for r in world["ranks"]:
        _held(r["llava"], jloss, jgrad)


def test_sharded_blip2_pixel_grad_matches_unsharded_and_jax(world):
    d, cfg = world["blip2"], world["cfgs"]["blip2"]
    p = jax.tree.map(jnp.asarray, d["params"])
    tok, mask = jnp.asarray(d["tokens"]), jnp.asarray(d["mask"])

    def f(xx):
        return JB.blip2_per_sample_loss(p, xx, tok, tok, mask, cfg, compute_dtype=jnp.float32)

    x = jnp.asarray(d["x"])
    jloss, jgrad = np.asarray(f(x)), np.asarray(jax.grad(lambda xx: jnp.sum(f(xx)))(x))
    for r in world["ranks"]:
        _held(r["blip2"], jloss, jgrad)


def test_sharded_mclip_text_encode_matches_unsharded_and_jax(world):
    d, cfg = world["mclip"], world["cfgs"]["mclip"]
    ref = np.asarray(JM.encode_text(jax.tree.map(jnp.asarray, d["params"]), jnp.asarray(d["ids"]),
                                    jnp.asarray(d["mask"]), cfg, normalize=True))
    for r in world["ranks"]:
        rec = r["mclip"]
        assert rec["sharded"]
        assert rec["got"].shape == (8, cfg.embed_dim)
        np.testing.assert_allclose(rec["got"], rec["ref"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(rec["got"], ref, atol=1e-5, rtol=0)
        np.testing.assert_allclose(np.linalg.norm(rec["got"], axis=-1), 1.0, atol=1e-5)
