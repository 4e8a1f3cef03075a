"""LLaVA-MPT and the `linear` projector (robustvlm_tpu_torch.models.llava)
against the JAX package's on the same `test-tiny-mpt` weights (JAX's seed-0
init carried across by `params_from_jax`), float32 on the CPU: the
per-sample teacher-forced CE within 1e-5 relative, its pixel gradient within
1e-5 of its largest element, and greedy and beam tokens exactly, for
left-padded prompts of different lengths (the ALiBi distances of the
mid-sequence padding go through `kv_positions`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.models import generation as JG
from robustvlm_tpu.models.llava import model as JV
from robustvlm_tpu_torch.models import generation as PG
from robustvlm_tpu_torch.models.llava import model as PV
from robustvlm_tpu_torch.models.llava.convert import half_state, init_random_state, params_from_jax

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_OF_LARGEST = 1e-5


def _configs(projector_type):
    j, p = JV.LLAVA_CONFIGS["test-tiny-mpt"], PV.LLAVA_CONFIGS["test-tiny-mpt"]
    if projector_type != j.projector_type:
        j = dataclasses.replace(j, projector_type=projector_type)
        p = dataclasses.replace(p, projector_type=projector_type)
    return j, p


@pytest.fixture(scope="module", params=["mlp2x_gelu", "linear"])
def pair(request):
    jcfg, pcfg = _configs(request.param)
    tree = JV.init_llava_params(jax.random.PRNGKey(0), jcfg)
    state = params_from_jax(jax.tree.map(np.asarray, tree))
    return jcfg, tree, PV.Llava.from_state(pcfg, state)


def _batch(seed, s=32):
    rng = np.random.RandomState(seed)
    x = rng.rand(2, 3, s, s).astype(np.float32)
    pre = rng.randint(3, 500, (2, 5))
    post = rng.randint(3, 500, (2, 9))
    mask = np.zeros((2, 9), np.float32)
    mask[0, 4:8] = 1.0
    mask[1, 2:9] = 1.0
    return x, pre, post, mask


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_loss_and_pixel_gradient_match_jax(pair, reduction):
    jcfg, tree, model = pair
    x, pre, post, mask = _batch(0)

    def jloss(xx):
        return JV.llava_per_sample_loss(tree, xx, jnp.asarray(pre), jnp.asarray(post), jnp.asarray(post),
                                        jnp.asarray(mask), jcfg, compute_dtype=jnp.float32,
                                        reduction_per_token=reduction)

    ref = np.asarray(jloss(jnp.asarray(x)))
    ref_g = np.asarray(jax.grad(lambda xx: jloss(xx).sum())(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = PV.llava_per_sample_loss(model, tx, *(torch.from_numpy(a) for a in (pre, post, post, mask)),
                                   compute_dtype=torch.float32, reduction_per_token=reduction)
    (g,) = torch.autograd.grad(got.sum(), tx)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=LOSS_RTOL)
    assert np.abs(ref_g).max() > 0
    assert np.abs(g.numpy() - ref_g).max() <= GRAD_OF_LARGEST * np.abs(ref_g).max()


def test_projector_layout(pair):
    jcfg, _, model = pair
    names = {k for k in model.state_dict() if k.startswith("projector.")}
    assert names == ({"projector.w1", "projector.b1"} if jcfg.projector_type == "linear"
                     else {"projector.w1", "projector.b1", "projector.w2", "projector.b2"})
    assert model.cfg.n_image_tokens == jcfg.n_image_tokens


@pytest.mark.parametrize("beams", [1, 3])
def test_generation_tokens_match_jax(pair, beams):
    """Two prompts of different lengths, left-padded: the shorter one's pad
    sits between [pre | image] and its tokens."""
    jcfg, tree, model = pair
    x, pre, _, _ = _batch(2)
    seqs = [[5, 6, 7, 8, 9, 10, 11], [12, 13]]
    toks, n_pad = PG.left_pad(seqs, pad_id=0)
    jt, jn = map(jnp.asarray, JG.left_pad(seqs, pad_id=0))
    max_total = toks.shape[1] + 6
    jpf, jdf = JV.make_llava_decode_fns(tree, jcfg, jnp.asarray(x), jnp.asarray(pre),
                                        max_total_len=max_total, compute_dtype=jnp.float32)
    ppf, pdf = PV.make_llava_decode_fns(model, torch.from_numpy(x), torch.from_numpy(pre),
                                        max_total_len=max_total, compute_dtype=torch.float32)
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


def test_short_prompt_padded_decodes_as_alone(pair):
    """The position table makes a padded prompt's first token the one it
    decodes alone (slot distances would overstate ALiBi distances by the
    pad)."""
    _, _, model = pair
    x, pre, _, _ = _batch(3)
    x, pre = torch.from_numpy(x[:1]).repeat(2, 1, 1, 1), torch.from_numpy(pre[:1]).repeat(2, 1)
    kw = dict(max_new_tokens=1, eos_id=2, pad_id=0)

    def first_logits(seqs):
        toks, n_pad = PG.left_pad(seqs, pad_id=0)
        pf, df = PV.make_llava_decode_fns(model, x[:len(seqs)], pre[:len(seqs)],
                                          max_total_len=toks.shape[1] + 1, compute_dtype=torch.float32)
        return PG.greedy_generate(pf, df, torch.from_numpy(toks).long(),
                                  torch.from_numpy(n_pad).long(), **kw).scores

    alone = first_logits([[12, 13]])
    padded = first_logits([[5, 6, 7, 8, 9], [12, 13]])
    np.testing.assert_allclose(padded[1:].numpy(), alone.numpy(), rtol=1e-5, atol=1e-6)


def test_random_init_and_half_state():
    cfg = PV.LLAVA_CONFIGS["test-tiny-mpt"]
    full = init_random_state(cfg, 3)
    half = init_random_state(cfg, 3, dtype=torch.bfloat16)
    assert set(full) == set(PV.Llava(cfg).state_dict())
    for k, v in half_state(full).items():
        assert torch.equal(half[k], v)
    assert torch.equal(full["mpt.norm_f"], torch.ones_like(full["mpt.norm_f"]))
    assert half["projector.w2"].dtype == torch.float32 and half["mpt.blocks.0.attn.wqkv"].dtype == torch.bfloat16


def test_kv_bits_is_llama_family_only():
    cfg = PV.LLAVA_CONFIGS["test-tiny-mpt"]
    model = PV.Llava.from_state(cfg, init_random_state(cfg, 0))
    with pytest.raises(ValueError, match="llama-family only"):
        PV.make_llava_decode_fns(model, torch.zeros(1, 3, 32, 32), torch.zeros(1, 2, dtype=torch.long),
                                 max_total_len=4, kv_bits=8)
