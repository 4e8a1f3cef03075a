"""The port's LLaMA (robustvlm_tpu_torch.models.llama) against the JAX
package's on the same weights: full-sequence logits, the cached decode path
step by step, and `_cache_write` with per-slot offsets. float32 on the CPU;
logits within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.models.llama import model as JL
from robustvlm_tpu_torch.models.llama import LLAMA_CONFIGS, Llama, init_cache, llama_forward
from robustvlm_tpu_torch.models.llama import model as PL
from robustvlm_tpu_torch.models.llama.convert import params_from_jax

torch.set_num_threads(1)


def _pair(name):
    cfg = JL.LLAMA_CONFIGS[name]
    tree = jax.tree.map(np.asarray, JL.init_llama_params(jax.random.PRNGKey(0), cfg))
    model = Llama(LLAMA_CONFIGS[name])
    model.load_state_dict(params_from_jax(tree))
    return cfg, tree, model


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-gqa"])
def test_logits_match_jax(name):
    cfg, tree, model = _pair(name)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 13))
    ref = JL.llama_forward(tree, jnp.asarray(tokens), cfg=cfg, compute_dtype=jnp.float32, flash=False)
    got = llama_forward(model, torch.from_numpy(tokens), compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 13, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-gqa"])
def test_cached_decode_matches_jax_step_by_step(name):
    """Prefill 6 tokens into a 12-slot cache, then decode one token at a
    time: every step's logits as JAX's."""
    cfg, tree, model = _pair(name)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 10))
    jc = JL.init_cache(cfg, 2, max_len=12, dtype=jnp.float32)
    pc = init_cache(model.cfg, 2, max_len=12, dtype=torch.float32)
    jl, jc = JL.llama_forward(tree, jnp.asarray(tokens[:, :6]), cfg=cfg, compute_dtype=jnp.float32,
                              cache=jc, cache_pos=0)
    pl, pc = llama_forward(model, torch.from_numpy(tokens[:, :6]), compute_dtype=torch.float32,
                           cache=pc, cache_pos=0)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for pos in range(6, 10):
        tok = tokens[:, pos:pos + 1]
        jl, jc = JL.llama_forward(tree, jnp.asarray(tok), cfg=cfg, compute_dtype=jnp.float32,
                                  cache=jc, cache_pos=pos)
        pl, pc = llama_forward(model, torch.from_numpy(tok), compute_dtype=torch.float32,
                               cache=pc, cache_pos=pos)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pc["k"].numpy(), np.asarray(jc["k"]), atol=1e-5)
    # the decode path equals the full forward at the same positions
    full = llama_forward(model, torch.from_numpy(tokens), compute_dtype=torch.float32)
    np.testing.assert_allclose(pl.numpy()[:, 0], full.numpy()[:, 9], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("pos", [3, np.asarray([0, 5, 2])])
def test_cache_write_matches_jax(pos):
    rng = np.random.RandomState(2)
    buf = rng.randn(3, 2, 10, 4).astype(np.float32)
    new = rng.randn(3, 2, 2, 4).astype(np.float32)
    ref = JL._cache_write(jnp.asarray(buf), jnp.asarray(new), jnp.asarray(pos))
    p = torch.from_numpy(np.asarray(pos)) if isinstance(pos, np.ndarray) else pos
    got = PL._cache_write(torch.from_numpy(buf.copy()), torch.from_numpy(new), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_rope_and_rms_norm_match_jax():
    cfg = JL.LLAMA_CONFIGS["test-tiny"]
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 7, cfg.head_dim).astype(np.float32)
    pos = rng.randint(0, 50, (2, 7))
    jc, js = JL.rope_freqs(cfg, jnp.asarray(pos))
    pc, ps = PL.rope_freqs(LLAMA_CONFIGS["test-tiny"], torch.from_numpy(pos))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-6)
    ref = JL.apply_rope(jnp.asarray(x), jc, js)
    np.testing.assert_allclose(PL.apply_rope(torch.from_numpy(x), pc, ps).numpy(), np.asarray(ref), atol=1e-6)
    h = rng.randn(3, 64).astype(np.float32)
    g = rng.rand(64).astype(np.float32)
    np.testing.assert_allclose(PL.rms_norm(torch.from_numpy(h), torch.from_numpy(g), 1e-5).numpy(),
                               np.asarray(JL.rms_norm(jnp.asarray(h), jnp.asarray(g), 1e-5)), atol=1e-6)


def test_unported_options_raise():
    _, _, model = _pair("test-tiny")
    tok = torch.zeros(1, 3, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        llama_forward(model, tok, remat=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_cache(model.cfg, 1, kv_bits=8)
    tree = JL.init_llama_params(jax.random.PRNGKey(0), JL.LLAMA_CONFIGS["test-tiny"])
    from robustvlm_tpu.ops.quant import quantize_llama_decode_params

    with pytest.raises(NotImplementedError, match="quantized"):
        params_from_jax(quantize_llama_decode_params({"llama": tree}, min_size=1)["llama"])
