"""The port's BLIP-2 (robustvlm_tpu_torch.models.blip2) against the JAX
package's on the same `test-tiny` weights (the JAX init carried across by
`params_from_jax`), float32 on the CPU: vision features, the Q-Former's
output and the logits within 1e-5 of their largest element; the per-sample
loss within 1e-5 relative and its pixel gradient within 1e-5 of its largest
element; greedy and beam tokens exactly for left-padded prompts of different
lengths; the importer bit-equal to JAX's `import_blip2_state_dict` on a tiny
random HF `Blip2ForConditionalGeneration`; bf16's half state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.models import generation as JG
from robustvlm_tpu.models.blip2 import model as JB
from robustvlm_tpu_torch.models import generation as PG
from robustvlm_tpu_torch.models.blip2 import model as PB
from robustvlm_tpu_torch.models.blip2.convert import init_random_state, params_from_jax

torch.set_num_threads(1)

CFG = JB.BLIP2_CONFIGS["test-tiny"]
PCFG = PB.BLIP2_CONFIGS["test-tiny"]
TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    tree = JB.init_blip2_params(jax.random.PRNGKey(0), CFG)
    return tree, PB.Blip2.from_state(PCFG, params_from_jax(jax.tree.map(np.asarray, tree)))


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def _pixels(seed, size=32, b=2):
    return np.random.RandomState(seed).rand(b, 3, size, size).astype(np.float32)


def test_configs_equal_jax():
    for name, cfg in JB.BLIP2_CONFIGS.items():
        p = PB.BLIP2_CONFIGS[name]
        assert (p.vision.__dict__, p.qformer.__dict__, p.opt.__dict__, p.num_query_tokens) == \
            (cfg.vision.__dict__, cfg.qformer.__dict__, cfg.opt.__dict__, cfg.num_query_tokens)


def test_vision_and_qformer_match_jax(pair):
    tree, model = pair
    x = np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32)  # normalized pixels
    jimg = JB.blip2_vision_forward(tree, jnp.asarray(x), CFG)
    img = PB.blip2_vision_forward(model, torch.from_numpy(x))
    _close(img.numpy(), jimg)
    jq = JB.qformer_forward(tree, jimg, CFG)
    q = PB.qformer_forward(model, img)
    assert q.dtype == torch.float32
    _close(q.numpy(), jq)
    _close(PB.blip2_image_features(model, torch.from_numpy(x)).numpy(),
           JB.blip2_image_features(tree, jnp.asarray(x), CFG))


@pytest.mark.parametrize("size", [32, 40], ids=["native", "resized"])
def test_logits_match_jax(pair, size):
    tree, model = pair
    x = _pixels(1, size)
    toks = np.random.RandomState(2).randint(3, CFG.opt.vocab_size, (2, 6))
    ref = JB.blip2_forward(tree, jnp.asarray(x), jnp.asarray(toks), CFG)
    got = PB.blip2_forward(model, torch.from_numpy(x), torch.from_numpy(toks))
    assert got.shape == (2, CFG.num_query_tokens + 6, CFG.opt.vocab_size)
    _close(got.numpy(), ref)


def test_loss_and_pixel_gradient_match_jax(pair):
    tree, model = pair
    x = _pixels(3)
    rng = np.random.RandomState(4)
    toks = rng.randint(3, CFG.opt.vocab_size, (2, 8))
    mask = np.zeros((2, 8), np.float32)
    mask[0, 3:6] = 1.0
    mask[1, 1:8] = 1.0
    t = [jnp.asarray(a) for a in (toks, toks, mask)]

    def jloss(xx):
        return JB.blip2_per_sample_loss(tree, xx, *t, CFG)

    ref = np.asarray(jloss(jnp.asarray(x)))
    ref_g = np.asarray(jax.grad(lambda xx: jloss(xx).sum())(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = PB.blip2_per_sample_loss(model, tx, torch.from_numpy(toks), torch.from_numpy(toks),
                                   torch.from_numpy(mask))
    (g,) = torch.autograd.grad(got.sum(), tx)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=TOL)
    _close(g.numpy(), ref_g)


@pytest.mark.parametrize("beams", [1, 3])
def test_generation_tokens_match_jax(pair, beams):
    tree, model = pair
    x = _pixels(5)
    seqs = [[1, 5, 6, 7, 8], [1, 9, 10]]
    toks, n_pad = PG.left_pad(seqs, pad_id=0)
    jt, jn = map(jnp.asarray, JG.left_pad(seqs, pad_id=0))
    total = toks.shape[1] + 6
    jpf, jdf = JB.make_blip2_decode_fns(tree, CFG, jnp.asarray(x), max_total_len=total)
    ppf, pdf = PB.make_blip2_decode_fns(model, torch.from_numpy(x), max_total_len=total,
                                        compute_dtype=torch.float32)
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


def test_random_init_half_state_is_the_cast_of_float32():
    full = init_random_state(PCFG, 0)
    half = init_random_state(PCFG, 0, dtype=torch.bfloat16)
    assert half.keys() == full.keys()
    for k, v in full.items():
        keeps = v.dim() < 2 or k == "query_tokens" or k.startswith("language_projection.")
        assert half[k].dtype == (torch.float32 if keeps else torch.bfloat16), k
        assert torch.equal(half[k], v.to(half[k].dtype)), k
    assert torch.equal(full["opt.lm_head"], full["opt.tok_embedding"].T)
    assert torch.equal(full["qformer.layers.0.cross.ln_g"], torch.ones(CFG.qformer.width))
    assert "qformer.layers.1.cross.q_w" not in full  # cross-attention on group leaders only


def test_bf16_model_equals_float32_weights_cast_at_use(pair):
    """The bf16 model (half_state) gives the loss the JAX function gives with
    float32 weights at compute_dtype bfloat16: LayerNorm reads float32 g/b."""
    tree, model = pair
    half = PB.Blip2.from_state(PCFG, PB.half_state(model.state_dict()))
    x = _pixels(6, b=1)
    toks = np.random.RandomState(7).randint(3, CFG.opt.vocab_size, (1, 6))
    mask = np.ones((1, 6), np.float32)
    ref = JB.blip2_per_sample_loss(tree, jnp.asarray(x), jnp.asarray(toks), jnp.asarray(toks),
                                   jnp.asarray(mask), CFG, compute_dtype=jnp.bfloat16)
    got = PB.blip2_per_sample_loss(half, torch.from_numpy(x), torch.from_numpy(toks),
                                   torch.from_numpy(toks), torch.from_numpy(mask),
                                   compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-2)


@pytest.fixture(scope="module")
def hf_model():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.Blip2Config(
        vision_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, image_size=32,
                           patch_size=8, intermediate_size=64, hidden_act="gelu"),
        qformer_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                            intermediate_size=64, encoder_hidden_size=32, cross_attention_frequency=2,
                            hidden_act="gelu"),
        text_config=dict(model_type="opt", hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                         ffn_dim=128, vocab_size=128, word_embed_proj_dim=64, max_position_embeddings=64,
                         activation_function="relu", do_layer_norm_before=True),
        num_query_tokens=4, image_token_index=120)
    return transformers.Blip2ForConditionalGeneration(cfg).eval()


def test_importer_bit_equal_to_jax(hf_model):
    from robustvlm_tpu.models.blip2.import_torch import import_blip2_state_dict as jax_import
    from robustvlm_tpu_torch.models.blip2.import_torch import load_blip2_checkpoint

    sd = hf_model.state_dict()
    ours = load_blip2_checkpoint(sd, PCFG)
    ref = params_from_jax(jax.tree.map(np.asarray, jax_import(sd, CFG)))
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32 and ours[k].is_contiguous(), k
        assert torch.equal(ours[k], v), k
    PB.Blip2.from_state(PCFG, ours)  # every parameter, strictly
