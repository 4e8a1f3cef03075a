"""The port's OpenFlamingo (robustvlm_tpu_torch.models.flamingo) against the
JAX package's on the same `test-tiny` weights, float32 on the CPU. The JAX
init carries across by `params_from_jax`, with both gates of every
cross-attention block opened to 0.5 (the reference initialises them at 0,
where the model ignores its image). Limits: the resampler, the masked
cross-attention, the gated block, the encoder and the logits within 1e-5
abs; the per-sample loss within 1e-5 relative and its pixel gradient within
1e-4 of its largest element; greedy and 3-beam tokens exactly; the
checkpoint importer leaf for leaf."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.models import generation as JG
from robustvlm_tpu.models.flamingo import import_torch as JI
from robustvlm_tpu.models.flamingo import model as JF
from robustvlm_tpu_torch.models import generation as PG
from robustvlm_tpu_torch.models.clip.convert import export_visual_state_dict
from robustvlm_tpu_torch.models.clip.model import CLIP
from robustvlm_tpu_torch.models.flamingo import convert as PC
from robustvlm_tpu_torch.models.flamingo import import_torch as PI
from robustvlm_tpu_torch.models.flamingo import model as PF
from test_torch_mpt import _jnp, _torch_like, _within_rounding

torch.set_num_threads(1)

MEDIA = 511  # WordTokenizer(512).media_token_id
JCFG = dataclasses.replace(JF.FLAMINGO_CONFIGS["test-tiny"], media_token_id=MEDIA)
PCFG = dataclasses.replace(PF.FLAMINGO_CONFIGS["test-tiny"], media_token_id=MEDIA)
ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    tree = jax.jit(JF.init_flamingo_params, static_argnums=1)(jax.random.PRNGKey(0), JCFG)
    for gate in ("attn_gate", "ff_gate"):
        tree["xattn"][gate] = jnp.full_like(tree["xattn"][gate], 0.5)
    model = PF.Flamingo.from_state(PCFG, PC.params_from_jax(jax.tree.map(np.asarray, tree)))
    return tree, model


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


def test_perceiver_resampler_matches_jax(pair):
    tree, model = pair
    x = np.random.RandomState(0).randn(2, 2, 1, 16, 64).astype(np.float32)
    ref = JF.perceiver_resampler(tree["perceiver"], jnp.asarray(x), JCFG)
    got = PF.perceiver_resampler(model.perceiver, torch.from_numpy(x), PCFG)
    assert got.shape == (2, 2, PCFG.num_latents, 64)
    _close(got, ref)


# media locations (B, T_txt): two media slots; a row whose first media comes
# late (its earlier tokens attend to nothing)
LOCS = np.array([[1, 0, 0, 1, 0, 0], [0, 0, 1, 0, 0, 1]], bool)


@pytest.mark.parametrize("case", ["immediate_media", "no_locations", "cached_media"])
def test_masked_cross_attention_matches_jax(pair, case):
    tree, model = pair
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 64).astype(np.float32)
    media = rng.randn(2, 2, PCFG.num_latents, 64).astype(np.float32)
    locs = None if case == "no_locations" else LOCS
    cached = case == "cached_media"
    jp = jax.tree.map(lambda a: a[0], tree["xattn"])["attn"]
    ref = jax.jit(lambda *a: JF.masked_cross_attention(*a, jp, JCFG.resampler_heads, locs, cached))(
        jnp.asarray(x), jnp.asarray(media))
    got = PF.masked_cross_attention(torch.from_numpy(x), torch.from_numpy(media), model.xattn[0].attn,
                                    PCFG.resampler_heads,
                                    None if locs is None else torch.from_numpy(locs), cached)
    _close(got, ref)
    if case == "immediate_media":
        # no preceding media: exactly 0; after the second media, only its latents
        assert torch.all(got[1, :2] == 0) and torch.any(got[1, 2:] != 0)
        only_second = media.copy()
        only_second[:, 0] = rng.randn(2, PCFG.num_latents, 64)
        moved = PF.masked_cross_attention(torch.from_numpy(x), torch.from_numpy(only_second),
                                          model.xattn[0].attn, PCFG.resampler_heads,
                                          torch.from_numpy(locs))
        torch.testing.assert_close(moved[0, 3:], got[0, 3:], rtol=0, atol=0)
        assert torch.any(moved[0, :3] != got[0, :3])


def test_gated_xattn_block_matches_jax(pair):
    tree, model = pair
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 64).astype(np.float32)
    media = rng.randn(2, 2, PCFG.num_latents, 64).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], tree["xattn"])
    ref = JF.gated_xattn_block(jnp.asarray(x), jnp.asarray(media), jp, JCFG.resampler_heads,
                               jnp.asarray(LOCS))
    got = PF.gated_xattn_block(torch.from_numpy(x), torch.from_numpy(media), model.xattn[1],
                               PCFG.resampler_heads, torch.from_numpy(LOCS))
    _close(got, ref)


def _vision(seed, b=2, t=2, size=32):
    return np.random.RandomState(seed).rand(b, t, 1, 3, size, size).astype(np.float32)


def test_encode_vision_matches_jax(pair):
    tree, model = pair
    vx = _vision(3)
    ref = JF.encode_vision(tree, jnp.asarray(vx), JCFG, compute_dtype=jnp.float32)
    got = PF.encode_vision(model, torch.from_numpy(vx), compute_dtype=torch.float32)
    assert got.shape == (2, 2, PCFG.num_latents, 64)
    _close(got, ref)


def _lang():
    lang = np.random.RandomState(4).randint(3, 500, (2, 10))
    lang[0, [0, 5]] = MEDIA
    lang[1, [2, 7]] = MEDIA
    lang[1, 9] = 0
    mask = np.zeros((2, 10), np.float32)
    mask[0, 6:] = 1.0
    mask[1, 3:7] = 1.0
    return lang, mask


def test_flamingo_forward_matches_jax(pair):
    tree, model = pair
    vx, (lang, _) = _vision(5), _lang()
    ref = jax.jit(lambda v, t: JF.flamingo_forward(tree, v, t, JCFG, compute_dtype=jnp.float32))(
        jnp.asarray(vx), jnp.asarray(lang))
    got = PF.flamingo_forward(model, torch.from_numpy(vx), torch.from_numpy(lang),
                              compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 10, PCFG.mpt.vocab_size)
    _close(got, ref)


def test_loss_and_pixel_gradient_match_jax(pair):
    tree, model = pair
    vx, (lang, mask) = _vision(6), _lang()

    def jloss(v):
        return JF.flamingo_per_sample_loss(tree, v, jnp.asarray(lang), jnp.asarray(lang),
                                           jnp.asarray(mask), JCFG, compute_dtype=jnp.float32)

    ref, ref_g = map(np.asarray, jax.jit(lambda v: (jloss(v), jax.grad(lambda u: jloss(u).sum())(v)))(
        jnp.asarray(vx)))
    tv = torch.from_numpy(vx).requires_grad_(True)
    t = torch.from_numpy(lang)
    got = PF.flamingo_per_sample_loss(model, tv, t, t, torch.from_numpy(mask),
                                      compute_dtype=torch.float32)
    (g,) = torch.autograd.grad(got.sum(), tv)
    assert got.shape == (2,)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=0)
    assert np.abs(ref_g).max() > 0 and torch.abs(g).max() > 0
    assert np.abs(g.numpy() - ref_g).max() <= 1e-4 * np.abs(ref_g).max()


def test_unset_media_token_raises(pair):
    _, model = pair
    bare = PF.Flamingo.from_state(PF.FLAMINGO_CONFIGS["test-tiny"], model.state_dict())
    with pytest.raises(ValueError, match="media_token_id"):
        PF.flamingo_forward(bare, torch.zeros(1, 1, 1, 3, 32, 32), torch.zeros(1, 3, dtype=torch.long))


@pytest.mark.parametrize("beams", [1, 3])
def test_generation_tokens_match_jax(pair, beams):
    """Greedy, and 3-beam search, whose (cache, media_locations) carry is
    reordered through `reorder_carry`."""
    tree, model = pair
    vx = _vision(7, t=1)
    seqs = [[MEDIA, 5, 6, 7, 8], [MEDIA, 9, 10]]
    toks, n_pad = PG.left_pad(seqs, pad_id=0)
    jt, jn = map(jnp.asarray, JG.left_pad(seqs, pad_id=0))
    total = toks.shape[1] + 6
    kw = dict(max_new_tokens=6, eos_id=2, pad_id=0)

    @jax.jit
    def jgen(v, t, n):
        jpf, jdf = JF.make_flamingo_decode_fns(tree, JCFG, v, max_total_len=total,
                                               compute_dtype=jnp.float32)
        if beams == 1:
            return JG.greedy_generate(jpf, jdf, t, n, **kw)
        return JG.beam_generate(jpf, jdf, t, n, num_beams=beams, length_penalty=1.0, **kw)

    ref = jgen(jnp.asarray(vx), jt, jn)
    ppf, pdf = PF.make_flamingo_decode_fns(model, torch.from_numpy(vx), max_total_len=total,
                                           compute_dtype=torch.float32)
    pt, pn = torch.from_numpy(toks).long(), torch.from_numpy(n_pad).long()
    if beams == 1:
        got = PG.greedy_generate(ppf, pdf, pt, pn, **kw)
    else:
        got = PG.beam_generate(ppf, pdf, pt, pn, num_beams=beams, length_penalty=1.0, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=1e-4, rtol=1e-4)


def _random_checkpoints():
    """OpenFlamingo-, mosaicml MPT- and torch visual-layout state dicts of the
    tiny config, random from a seed."""
    gen = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=gen)

    dv, dl, inner, d = 64, 64, JCFG.resampler_heads * JCFG.resampler_dim_head, 64
    of = {"perceiver.latents": r(JCFG.num_latents, dv), "perceiver.norm.weight": r(dv),
          "perceiver.norm.bias": r(dv), "lang_encoder.transformer.wte.weight": r(512, dl)}
    for i in range(JCFG.resampler_depth):
        p = f"perceiver.layers.{i}."
        of.update({p + "0.norm_media.weight": r(dv), p + "0.norm_media.bias": r(dv),
                   p + "0.norm_latents.weight": r(dv), p + "0.norm_latents.bias": r(dv),
                   p + "0.to_q.weight": r(inner, dv), p + "0.to_kv.weight": r(2 * inner, dv),
                   p + "0.to_out.weight": r(dv, inner), p + "1.0.weight": r(dv),
                   p + "1.0.bias": r(dv), p + "1.1.weight": r(4 * dv, dv),
                   p + "1.3.weight": r(dv, 4 * dv)})
    for i in range(JCFG.n_xattn):
        p = f"lang_encoder.gated_cross_attn_layers.{i}."
        of.update({p + "attn.norm.weight": r(dl), p + "attn.norm.bias": r(dl),
                   p + "attn.to_q.weight": r(inner, dl), p + "attn.to_kv.weight": r(2 * inner, dv),
                   p + "attn.to_out.weight": r(dl, inner), p + "ff.0.weight": r(dl),
                   p + "ff.0.bias": r(dl), p + "ff.1.weight": r(4 * dl, dl),
                   p + "ff.3.weight": r(dl, 4 * dl), p + "attn_gate": r(1), p + "ff_gate": r(1)})
    mpt = {"transformer.wte.weight": r(512, d), "transformer.norm_f.weight": r(d)}
    for i in range(JCFG.mpt.n_layers):
        b = f"transformer.blocks.{i}."
        mpt.update({b + "norm_1.weight": r(d), b + "norm_2.weight": r(d),
                    b + "attn.Wqkv.weight": r(3 * d, d), b + "attn.out_proj.weight": r(d, d),
                    b + "ffn.up_proj.weight": r(4 * d, d), b + "ffn.down_proj.weight": r(d, 4 * d)})
    clip = CLIP(PCFG.vision).init_random_(1)
    visual = export_visual_state_dict(clip.state_dict(), PCFG.vision)
    return of, mpt, visual


@pytest.mark.parametrize("layout", ["visual_only", "open_clip", "tecoa"])
def test_checkpoint_import_equals_jax(pair, layout):
    """`load_flamingo_checkpoint` against the JAX loader on the three
    checkpoints (the visual tower bare, under open_clip's `visual.` prefix,
    or nested as TeCoA saves it): equal leaves, and a model loads them."""
    of, mpt, visual = _random_checkpoints()
    if layout == "open_clip":
        visual = {"visual." + k: v for k, v in visual.items()}
    elif layout == "tecoa":
        visual = {"vision_encoder_state_dict": visual}
    ref = PC.params_from_jax(jax.tree.map(np.asarray, JI.load_flamingo_checkpoint(
        of, JCFG, mpt_path=mpt, visual_path=visual)))
    got = PI.load_flamingo_checkpoint(of, PCFG, mpt_path=mpt, visual_path=visual)
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k].reshape(got[k].shape)), k
    PF.Flamingo.from_state(PCFG, got)  # loads strictly
    assert torch.equal(got["mpt.tok_embedding"], of["lang_encoder.transformer.wte.weight"])


# `_ln`'s calls: the cross-attention's over the bf16 text at MPT-7B's width,
# the Perceiver's in float32 at ViT-L/14's, the float32 stage's text (rows
# cut to 15)
LN_CALLS = [(torch.bfloat16, 4096), (torch.float32, 1024), (torch.float32, 4096)]


@pytest.mark.parametrize("dtype,w", LN_CALLS, ids=["bf16_4096", "fp32_1024", "fp32_4096"])
def test_ln_cpu_matches_jax(dtype, w):
    """On the CPU, `_ln` (`block_ops`' plain LayerNorm) is the JAX model's
    `_ln` to float32 rounding: the forward and the gradients in x, g and
    b."""
    gen = torch.Generator().manual_seed(w)
    x = (torch.randn(3, 5, w, generator=gen) * 2 + 0.5).to(dtype)
    g = 1 + 0.1 * torch.randn(w, generator=gen)
    b = 0.1 * torch.randn(w, generator=gen)
    dy = torch.randn(3, 5, w, generator=gen).to(dtype)
    xa, ga, ba = (t.clone().requires_grad_(True) for t in (x, g, b))
    y = PF._ln(xa, ga, ba)
    got = (y.detach(), *torch.autograd.grad(y, (xa, ga, ba), dy))
    yj, vjp = jax.vjp(JF._ln, _jnp(x), _jnp(g), _jnp(b))
    for a, r in zip(got, (yj, *vjp(_jnp(dy)))):
        assert _within_rounding(a, _torch_like(r, a))


# `test-tiny` at head dims the attention kernels build: MPT 2 heads of 64,
# the vision tower 1 head of 64
CARD_CFG = dataclasses.replace(
    PCFG, mpt=dataclasses.replace(PCFG.mpt, d_model=128, n_heads=2),
    vision=dataclasses.replace(PCFG.vision, vision=dataclasses.replace(PCFG.vision.vision, heads=1)))


def _tiny_on_card(dev):
    """CARD_CFG in bf16 (`half_state`) on the card: gates opened to 0.5 and
    every 1-D parameter moved off its init, so the LayerNorms' gains and
    biases count."""
    state = PC.init_random_state(CARD_CFG, 0, device=dev, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)
    for k, v in state.items():
        if k.endswith("_gate"):
            v.fill_(0.5)
        elif v.dim() == 1:
            v.add_(0.2 * torch.randn(v.shape, generator=gen, device=dev))
    return PF.Flamingo.from_state(CARD_CFG, state)


@pytest.mark.cuda
def test_cuda_tiny_layer_norms_on_the_kernels(monkeypatch):
    """`test-tiny` on the card (CARD_CFG), the per-sample loss and its pixel
    gradient in bf16: every LayerNorm of MPT (2 L + 1, bias-free), the cross-attention
    blocks (2 each, bf16) and the Perceiver (3 a layer + 1, float32) goes
    through `block_ops.layer_norm`, one launch each forward and one each
    backward but for the two that read no gradient (the first block's
    attention LN reads the token embeddings, the first Perceiver layer's
    latent LN the frozen latents); each call on its own inputs within the
    kernels' limits of its module's CPU arithmetic."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from test_torch_block_ops import card_call_matches_cpu, record_layer_norms

    from robustvlm_tpu_torch.models.mpt import model as PM
    from robustvlm_tpu_torch.ops import kernels
    from robustvlm_tpu_torch.ops.image import normalize_clip

    dev = torch.device("cuda")
    model = _tiny_on_card(dev)
    vx = torch.from_numpy(_vision(7)).to(dev)
    lang, mask = (torch.from_numpy(a).to(dev) for a in _lang())
    kernels.reset_launches()
    with torch.no_grad():  # the vision tower's own LayerNorms (CLIP's route)
        model.vision(normalize_clip(vx.flatten(0, 2)), compute_dtype=torch.bfloat16, tokens=True)
    tower = kernels.launches()["layer_norm_fwd"]
    calls = record_layer_norms(monkeypatch)
    tv = vx.clone().requires_grad_(True)
    kernels.reset_launches()
    loss = PF.flamingo_per_sample_loss(model, tv, lang, lang, mask, compute_dtype=torch.bfloat16)
    fwd = kernels.launches()
    (grad,) = torch.autograd.grad(loss.sum(), tv)
    both = kernels.launches()
    cfg = CARD_CFG
    n = (2 * cfg.mpt.n_layers + 1) + 2 * cfg.n_xattn + (3 * cfg.resampler_depth + 1)
    assert len(calls) == n and fwd["layer_norm_fwd"] == tower + n and fwd["layer_norm_bwd"] == 0
    assert both["layer_norm_bwd"] == tower + n - 2
    assert sum(b is None for _, _, b, _ in calls) == 2 * cfg.mpt.n_layers + 1
    assert sum(x.dtype == torch.float32 for x, _, _, _ in calls) == 3 * cfg.resampler_depth + 1
    assert torch.isfinite(grad).all() and grad.abs().max() > 0

    monkeypatch.undo()  # stop recording: the CPU route calls `block_ops.layer_norm` too

    def cpu_fn(x, g, b, eps):
        return PM.layer_norm(x, g, eps) if b is None else PF._ln(x, g, b)

    for i, call in enumerate(calls):
        assert card_call_matches_cpu(call, cpu_fn, i), i


def test_random_init_keeps_zero_gates_and_half_layout():
    """The port's random init mirrors the reference's zero gates; its bf16
    draw equals `half_state` of the float32 one."""
    full = PC.init_random_state(PCFG, 0)
    half = PC.init_random_state(PCFG, 0, dtype=torch.bfloat16)
    assert all(float(full[f"xattn.{i}.{g}"]) == 0.0
               for i in range(PCFG.n_xattn) for g in ("attn_gate", "ff_gate"))
    ref = PF.half_state(full)
    assert set(half) == set(ref)
    for k in ref:
        assert half[k].dtype == ref[k].dtype and torch.equal(half[k], ref[k]), k
    assert half["perceiver.layers.0.attn.to_q"].dtype == torch.float32
    assert half["mpt.blocks.0.attn.wqkv"].dtype == torch.bfloat16
