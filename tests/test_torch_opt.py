"""The port's OPT (robustvlm_tpu_torch.models.opt) against the JAX package's
on the same `test-tiny` weights (the JAX init carried across by
`params_from_jax`), float32 on the CPU: logits of the full forward (from
tokens and from input embeddings with explicit positions) and of a
left-padded cached prefill plus greedy decode steps within 1e-5 of the
largest |logit|; the random init's shapes and its tied head."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.models.opt import model as JO
from robustvlm_tpu_torch.models.opt import model as PO
from robustvlm_tpu_torch.models.opt.convert import init_random_state, params_from_jax

torch.set_num_threads(1)

CFG = JO.OPT_CONFIGS["test-tiny"]
PCFG = PO.OPT_CONFIGS["test-tiny"]
TOL = 1e-5  # of the largest |logit|


@pytest.fixture(scope="module")
def pair():
    tree = JO.init_opt_params(jax.random.PRNGKey(0), CFG)
    return tree, PO.OPT.from_state(PCFG, params_from_jax(jax.tree.map(np.asarray, tree)))


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_configs_equal_jax():
    for name, cfg in JO.OPT_CONFIGS.items():
        assert PO.OPT_CONFIGS[name].__dict__ == cfg.__dict__
    assert PO.POS_OFFSET == JO.POS_OFFSET == 2


def test_logits_match_jax(pair):
    tree, model = pair
    toks = np.random.RandomState(0).randint(3, CFG.vocab_size, (2, 11))
    ref = JO.opt_forward(tree, jnp.asarray(toks), cfg=CFG, compute_dtype=jnp.float32)
    got = PO.opt_forward(model, torch.from_numpy(toks), compute_dtype=torch.float32)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)


def test_embeds_with_positions_match_jax(pair):
    """The BLIP-2 entry: input embeddings and (B, T) positions."""
    tree, model = pair
    rng = np.random.RandomState(1)
    emb = rng.randn(2, 9, CFG.dim).astype(np.float32) * 0.5
    pos = np.stack([np.arange(9), np.r_[0, 1, 2, 3, 3, 4, 5, 6, 7]])
    ref = JO.opt_forward(tree, cfg=CFG, inputs_embeds=jnp.asarray(emb), positions=jnp.asarray(pos),
                         compute_dtype=jnp.float32)
    got = PO.opt_forward(model, inputs_embeds=torch.from_numpy(emb), positions=torch.from_numpy(pos),
                         compute_dtype=torch.float32)
    _close(got.numpy(), ref)


def test_cached_prefill_and_decode_match_jax(pair):
    """A left-padded prefill (kv_mask, positions) then 3 greedy steps."""
    tree, model = pair
    rng = np.random.RandomState(2)
    t, total = 7, 12
    toks = rng.randint(3, CFG.vocab_size, (2, t))
    n_pad = np.array([0, 3])
    toks[1, :3] = 0
    kv_valid = np.arange(t)[None, :] >= n_pad[:, None]
    positions = np.maximum(np.arange(t)[None, :] - n_pad[:, None], 0)
    jcache = JO.init_opt_cache(CFG, 2, max_len=total, dtype=jnp.float32)
    pcache = PO.init_opt_cache(PCFG, 2, max_len=total, dtype=torch.float32)

    @jax.jit
    def jstep(tok, cache, pos, kv, qpos):
        return JO.opt_forward(tree, tok, cfg=CFG, compute_dtype=jnp.float32, cache=cache,
                              cache_pos=pos, kv_mask=kv, positions=qpos)

    def pstep(tok, cache, pos, kv, qpos):
        return PO.opt_forward(model, torch.from_numpy(tok), compute_dtype=torch.float32, cache=cache,
                              cache_pos=pos, kv_mask=torch.from_numpy(kv), positions=torch.from_numpy(qpos))

    jl, jcache = jstep(jnp.asarray(toks), jcache, 0, jnp.asarray(kv_valid), jnp.asarray(positions))
    pl, pcache = pstep(toks, pcache, 0, kv_valid, positions)
    _close(pl.numpy(), jl)
    kv = np.concatenate([kv_valid, np.zeros((2, total - t), bool)], axis=1)
    nxt = np.asarray(jl)[:, -1].argmax(-1)
    for i in range(3):
        pos = t + i
        kv[:, pos] = True
        qpos = (pos - n_pad)[:, None]
        jl, jcache = jstep(jnp.asarray(nxt[:, None]), jcache, pos, jnp.asarray(kv), jnp.asarray(qpos))
        pl, pcache = pstep(nxt[:, None], pcache, pos, kv, qpos)
        _close(pl.numpy(), jl)
        nxt = np.asarray(jl)[:, -1].argmax(-1)
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(jcache["k"]), atol=1e-5)


def test_random_init_state():
    state = init_random_state(PCFG, 0)
    with torch.device("meta"):
        want = {k: v.shape for k, v in PO.OPT(PCFG).state_dict().items()}
    assert {k: v.shape for k, v in state.items()} == want
    assert torch.equal(state["lm_head"], state["tok_embedding"].T)
    assert torch.equal(state["blocks.0.ln1.g"], torch.ones(CFG.dim))
    assert not state["blocks.1.mlp.b2"].any()
