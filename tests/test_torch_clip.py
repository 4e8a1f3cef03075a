"""The port's CLIP (robustvlm_tpu_torch.models.clip) and in-model ops against
the JAX package, fp32 on the CPU, with the same weights on both sides.

`params_from_jax` carries a JAX `init_clip_params(test-tiny)` tree across;
encode_image / encode_text match at atol=1e-5, the pixel gradient of the
zero-shot logits at 1e-4. The openai-layout loader matches the JAX importer
on the same numpy state dict exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.eval.classifier import make_embedding_fn as jax_embedding_fn
from robustvlm_tpu.eval.classifier import make_zero_shot_classifier as jax_zero_shot
from robustvlm_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS
from robustvlm_tpu.models.clip import encode_image as jax_encode_image
from robustvlm_tpu.models.clip import encode_text as jax_encode_text
from robustvlm_tpu.models.clip import init_clip_params
from robustvlm_tpu.models.clip.import_torch import export_visual_state_dict, import_clip_state_dict
from robustvlm_tpu.models.clip.tokenizer import HashTokenizer as JaxHashTokenizer
from robustvlm_tpu.ops import image as jax_image
from robustvlm_tpu.ops import losses as jax_losses
from robustvlm_tpu_torch.eval.classifier import make_embedding_fn, make_zero_shot_classifier
from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, load_clip_checkpoint, params_from_jax
from robustvlm_tpu_torch.models.clip.tokenizer import HashTokenizer
from robustvlm_tpu_torch.ops import image, losses

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    cfg = JAX_CONFIGS["test-tiny"]
    jparams = init_clip_params(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, jparams)
    model = CLIP(CLIP_CONFIGS["test-tiny"])
    model.load_state_dict(params_from_jax(tree))
    return cfg, jparams, tree, model


def _images(n=2, size=32, seed=0):
    return np.random.RandomState(seed).rand(n, 3, size, size).astype(np.float32)


def test_config_table_matches_jax():
    for name, cfg in CLIP_CONFIGS.items():
        j = JAX_CONFIGS[name]
        assert (cfg.embed_dim, cfg.image_size, cfg.patch_size, cfg.vocab_size,
                cfg.context_length, cfg.quick_gelu) == (
            j.embed_dim, j.image_size, j.patch_size, j.vocab_size,
            j.context_length, j.quick_gelu)
        assert (cfg.vision.width, cfg.vision.layers, cfg.vision.heads) == (
            j.vision.width, j.vision.layers, j.vision.heads)
        assert (cfg.text.width, cfg.text.layers, cfg.text.heads) == (
            j.text.width, j.text.layers, j.text.heads)


def test_params_from_jax_covers_every_parameter(tiny):
    _, _, tree, model = tiny
    sd = params_from_jax(tree)
    assert set(sd) == set(model.state_dict())
    assert all(not p.requires_grad for p in model.parameters())  # frozen


@pytest.mark.parametrize("normalize", [False, True])
def test_encode_image_matches_jax(tiny, normalize):
    cfg, jparams, _, model = tiny
    x = _images()
    xn = np.asarray(jax_image.normalize_clip(jnp.asarray(x)))
    ref = np.asarray(jax_encode_image(jparams, jnp.asarray(xn), cfg, normalize=normalize))
    got = model.encode_image(image.normalize_clip(torch.from_numpy(x)), normalize=normalize)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_encode_image_tokens_and_skip_last_match_jax(tiny):
    cfg, jparams, _, model = tiny
    x = _images(seed=1)
    ref = np.asarray(jax_encode_image(jparams, jnp.asarray(x), cfg, tokens=True, n_skip_last=1))
    got = model.encode_image(torch.from_numpy(x), tokens=True, n_skip_last=1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_encode_text_matches_jax(tiny):
    cfg, jparams, _, model = tiny
    texts = ["a photo of a cat", "This is a photo of a truck", "dog"]
    toks = JaxHashTokenizer(cfg.vocab_size, cfg.context_length)(texts)
    assert np.array_equal(toks, HashTokenizer(cfg.vocab_size, cfg.context_length)(texts))
    for normalize in (False, True):
        ref = np.asarray(jax_encode_text(jparams, jnp.asarray(toks), cfg, normalize=normalize))
        got = model.encode_text(torch.from_numpy(toks).long(), normalize=normalize)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_normalize_and_resize_match_jax():
    x = _images(2, 16, seed=2)
    np.testing.assert_allclose(
        image.normalize_clip(torch.from_numpy(x)).numpy(),
        np.asarray(jax_image.normalize_clip(jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        image.resize_bicubic(torch.from_numpy(x), 32).numpy(),
        np.asarray(jax_image.resize_bicubic(jnp.asarray(x), 32)), atol=1e-6, rtol=1e-5)


def _temb(cfg, n_cls=5, seed=3):
    t = np.random.RandomState(seed).randn(cfg.embed_dim, n_cls).astype(np.float32)
    return t / np.linalg.norm(t, axis=0, keepdims=True)


@pytest.mark.parametrize("resize", [False, True])
def test_zero_shot_logits_and_pixel_grad_match_jax(tiny, resize):
    """Logits and their pixel gradient, with normalize (and the bicubic
    resize from a smaller input) inside the model."""
    cfg, jparams, _, model = tiny
    size = 16 if resize else 32
    x = _images(3, size, seed=4)
    temb = _temb(cfg)
    jfn = jax_zero_shot(jparams, cfg, jnp.asarray(temb), resize_to=32 if resize else None)
    tfn = make_zero_shot_classifier(model, torch.from_numpy(temb), resize_to=32 if resize else None)
    np.testing.assert_allclose(tfn(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jfn(jnp.asarray(x))), atol=1e-4, rtol=1e-5)
    w = np.random.RandomState(5).randn(3, 5).astype(np.float32)
    gref = jax.grad(lambda xx: jnp.sum(jfn(xx) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tfn(xt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("output_normalize", [False, True])
def test_embedding_fn_matches_jax(tiny, output_normalize):
    """The FARE/TeCoA wrapper: [0,1] pixels -> image embedding, normalize inside."""
    cfg, jparams, _, model = tiny
    x = _images(seed=7)
    ref = np.asarray(jax_embedding_fn(jparams, cfg, output_normalize=output_normalize)(jnp.asarray(x)))
    got = make_embedding_fn(model, output_normalize=output_normalize)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def _openai_state_dict(tree, cfg):
    """A full openai-layout state dict (numpy) built from a JAX tree."""
    rng = np.random.RandomState(6)
    sd = {f"visual.{k}": v for k, v in export_visual_state_dict(tree["visual"], cfg).items()}
    t = tree["text"]
    sd["token_embedding.weight"] = np.asarray(t["token_embedding"])
    sd["positional_embedding"] = np.asarray(t["positional_embedding"])
    sd["ln_final.weight"] = np.asarray(t["ln_final"]["g"]) + rng.randn(cfg.text.width).astype(np.float32) * 0.1
    sd["ln_final.bias"] = np.asarray(t["ln_final"]["b"])
    sd["text_projection"] = np.asarray(t["text_projection"])
    sd["logit_scale"] = np.asarray(tree["logit_scale"])
    bl = t["blocks"]
    for i in range(cfg.text.layers):
        rb = f"transformer.resblocks.{i}."
        sd[rb + "ln_1.weight"] = np.asarray(bl["ln_1"]["g"][i])
        sd[rb + "ln_1.bias"] = rng.randn(cfg.text.width).astype(np.float32) * 0.1
        sd[rb + "attn.in_proj_weight"] = np.asarray(bl["attn"]["qkv_w"][i]).T.copy()
        sd[rb + "attn.in_proj_bias"] = rng.randn(3 * cfg.text.width).astype(np.float32) * 0.1
        sd[rb + "attn.out_proj.weight"] = np.asarray(bl["attn"]["out_w"][i]).T.copy()
        sd[rb + "attn.out_proj.bias"] = np.asarray(bl["attn"]["out_b"][i])
        sd[rb + "ln_2.weight"] = np.asarray(bl["ln_2"]["g"][i])
        sd[rb + "ln_2.bias"] = np.asarray(bl["ln_2"]["b"][i])
        sd[rb + "mlp.c_fc.weight"] = np.asarray(bl["mlp"]["fc_w"][i]).T.copy()
        sd[rb + "mlp.c_fc.bias"] = np.asarray(bl["mlp"]["fc_b"][i])
        sd[rb + "mlp.c_proj.weight"] = np.asarray(bl["mlp"]["proj_w"][i]).T.copy()
        sd[rb + "mlp.c_proj.bias"] = np.asarray(bl["mlp"]["proj_b"][i])
    return sd


def _assert_same(port_sd, jax_tree):
    ref = params_from_jax(jax.tree.map(np.asarray, jax_tree))
    assert set(port_sd) == set(ref)
    for k in ref:
        assert torch.equal(port_sd[k], ref[k]), k


def test_openai_loader_matches_jax_importer(tiny):
    cfg, _, tree, _ = tiny
    sd = _openai_state_dict(tree, cfg)
    _assert_same(load_clip_checkpoint(sd, CLIP_CONFIGS["test-tiny"]), import_clip_state_dict(sd, cfg))


def test_visual_only_overlay_and_beta_interpolation(tiny):
    cfg, _, tree, model = tiny
    full = _openai_state_dict(tree, cfg)
    other = init_clip_params(jax.random.PRNGKey(1), cfg)
    vis = {k: torch.from_numpy(np.asarray(v).copy())
           for k, v in export_visual_state_dict(jax.tree.map(np.asarray, other["visual"]), cfg).items()}
    base = load_clip_checkpoint(full, CLIP_CONFIGS["test-tiny"])
    over = load_clip_checkpoint({"vision_encoder_state_dict": vis}, CLIP_CONFIGS["test-tiny"], base=base)
    jref = dict(import_clip_state_dict(full, cfg))
    jref["visual"] = other["visual"]
    _assert_same(over, jref)
    with pytest.raises(ValueError):
        load_clip_checkpoint(vis, CLIP_CONFIGS["test-tiny"])
    # beta-interpolation of two full checkpoints, as the JAX loader does
    full2 = {k: v * 0.5 + 0.1 for k, v in full.items()}
    from robustvlm_tpu.models.clip.import_torch import load_clip_checkpoint as jax_load

    _assert_same(
        load_clip_checkpoint(full, CLIP_CONFIGS["test-tiny"], beta=0.3, interpolate_with=full2),
        jax_load(full, cfg, beta=0.3, interpolate_with=full2),
    )


def test_losses_match_jax():
    rng = np.random.RandomState(7)
    logits = rng.randn(6, 12).astype(np.float32) * 3
    y = rng.randint(0, 12, 6)
    y[0] = int(np.argmax(logits[0]))
    yt = (y + 3) % 12
    tl, ty, tyt = torch.from_numpy(logits), torch.from_numpy(y), torch.from_numpy(yt)
    jl, jy, jyt = jnp.asarray(logits), jnp.asarray(y), jnp.asarray(yt)
    for got, ref in [
        (losses.ce_loss(tl, ty, reduction="none"), jax_losses.ce_loss(jl, jy, reduction="none")),
        (losses.ce_loss(tl, ty), jax_losses.ce_loss(jl, jy)),
        (losses.dlr_loss(tl, ty), jax_losses.dlr_loss(jl, jy)),
        (losses.dlr_loss_targeted(tl, ty, tyt), jax_losses.dlr_loss_targeted(jl, jy, jyt)),
    ]:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
