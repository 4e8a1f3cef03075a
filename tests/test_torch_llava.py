"""The port's LLaVA (robustvlm_tpu_torch.models.llava) and generation against
the JAX package's on the same `test-tiny` weights (JAX init carried across
by `params_from_jax`), float32 on the CPU: the per-sample teacher-forced CE
(1e-4 relative) and its pixel gradient (1e-3 relative), and greedy and
beam tokens exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.models import generation as JG
from robustvlm_tpu.models.llava import model as JV
from robustvlm_tpu_torch.models import generation as PG
from robustvlm_tpu_torch.models.llava import model as PV
from robustvlm_tpu_torch.models.llava.convert import init_random_state, params_from_jax

torch.set_num_threads(1)

CFG = JV.LLAVA_CONFIGS["test-tiny"]


@pytest.fixture(scope="module")
def pair():
    tree = JV.init_llava_params(jax.random.PRNGKey(0), CFG)
    state = params_from_jax(jax.tree.map(np.asarray, tree))
    return tree, PV.Llava.from_state(PV.LLAVA_CONFIGS["test-tiny"], state)


def _batch(seed):
    rng = np.random.RandomState(seed)
    s = CFG.vision.image_size
    x = rng.rand(2, 3, s, s).astype(np.float32)
    pre = rng.randint(3, 500, (2, 5))
    post = rng.randint(3, 500, (2, 9))
    mask = np.zeros((2, 9), np.float32)
    mask[0, 4:8] = 1.0
    mask[1, 2:9] = 1.0
    return x, pre, post, mask


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_loss_and_pixel_gradient_match_jax(pair, reduction):
    tree, model = pair
    x, pre, post, mask = _batch(0)

    def jloss(xx):
        return JV.llava_per_sample_loss(tree, xx, jnp.asarray(pre), jnp.asarray(post), jnp.asarray(post),
                                        jnp.asarray(mask), CFG, compute_dtype=jnp.float32,
                                        reduction_per_token=reduction)

    ref = np.asarray(jloss(jnp.asarray(x)))
    ref_g = np.asarray(jax.grad(lambda xx: jloss(xx).sum())(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    t = [torch.from_numpy(a) for a in (pre, post, post, mask)]
    got = PV.llava_per_sample_loss(model, tx, *t, compute_dtype=torch.float32,
                                   reduction_per_token=reduction)
    (g,) = torch.autograd.grad(got.sum(), tx)
    assert got.shape == (2,)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-4)
    assert np.linalg.norm(g.numpy() - ref_g) <= 1e-3 * np.linalg.norm(ref_g)


def test_resize_path_matches_jax(pair):
    """Pixels at another size go through the in-model bicubic resize."""
    tree, model = pair
    x = np.random.RandomState(1).rand(1, 3, 40, 40).astype(np.float32)
    ref = np.asarray(JV.encode_images(tree, jnp.asarray(x), CFG, compute_dtype=jnp.float32))
    got = PV.encode_images(model, torch.from_numpy(x), compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


def _decode_fns(tree, model, x, pre, max_total):
    jfns = JV.make_llava_decode_fns(tree, CFG, jnp.asarray(x), jnp.asarray(pre),
                                    max_total_len=max_total, compute_dtype=jnp.float32)
    pfns = PV.make_llava_decode_fns(model, torch.from_numpy(x), torch.from_numpy(pre),
                                    max_total_len=max_total, compute_dtype=torch.float32)
    return jfns, pfns


@pytest.mark.parametrize("beams", [1, 3])
def test_generation_tokens_match_jax(pair, beams):
    tree, model = pair
    x, pre, _, _ = _batch(2)
    toks, n_pad = PG.left_pad([[5, 6, 7, 8], [9, 10]], pad_id=0)
    jt, jn = map(jnp.asarray, JG.left_pad([[5, 6, 7, 8], [9, 10]], pad_id=0))
    (jpf, jdf), (ppf, pdf) = _decode_fns(tree, model, x, pre, toks.shape[1] + 6)
    kw = dict(max_new_tokens=6, eos_id=2, pad_id=0)
    pt, pn = torch.from_numpy(toks).long(), torch.from_numpy(n_pad).long()
    if beams == 1:
        ref = JG.greedy_generate(jpf, jdf, jt, jn, **kw)
        got = PG.greedy_generate(ppf, pdf, pt, pn, **kw)
    else:
        ref = JG.beam_generate(jpf, jdf, jt, jn, num_beams=beams, length_penalty=1.0, **kw)
        got = PG.beam_generate(ppf, pdf, pt, pn, num_beams=beams, length_penalty=1.0, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=1e-4, rtol=1e-4)
    assert PG.strip_after_eos(got.tokens, 2) == JG.strip_after_eos(ref.tokens, 2)


def test_random_init_half_state_is_the_cast_of_float32():
    cfg = PV.LLAVA_CONFIGS["test-tiny"]
    full = init_random_state(cfg, 3)
    half = init_random_state(cfg, 3, dtype=torch.bfloat16)
    cast = PV.half_state(full)
    for k in full:
        assert half[k].dtype == cast[k].dtype and torch.equal(half[k], cast[k])
        keep32 = full[k].dim() < 2 or k.startswith("projector.")
        assert half[k].dtype == (torch.float32 if keep32 else torch.bfloat16)
    m32, m16 = PV.Llava.from_state(cfg, full), PV.Llava.from_state(cfg, cast)
    assert m16.projector.w1 is not None and m16.projector.w1.data_ptr() == m32.projector.w1.data_ptr()
    assert not any(p.requires_grad for p in m16.parameters())


def test_unported_configs_raise():
    """LLaVA-MPT is ported; an int8 KV cache with it is refused, as in JAX
    (the int8 cache is llama-family only)."""
    cfg = PV.LLAVA_CONFIGS["test-tiny-mpt"]
    model = PV.Llava.from_state(cfg, init_random_state(cfg, 0))
    x = torch.zeros(1, 3, 32, 32)
    with pytest.raises(ValueError, match="llama-family only"):
        PV.make_llava_decode_fns(model, x, torch.ones(1, 2, dtype=torch.long), max_total_len=4,
                                 kv_bits=8)
    with pytest.raises(ValueError, match="llama-family only"):
        JV.make_llava_decode_fns(JV.init_llava_params(jax.random.PRNGKey(0), JV.LLAVA_CONFIGS["test-tiny-mpt"]),
                                 JV.LLAVA_CONFIGS["test-tiny-mpt"], jnp.zeros((1, 3, 32, 32)),
                                 jnp.ones((1, 2), jnp.int32), max_total_len=4, kv_bits=8)
