"""The port's ConvNeXt CLIP tower (robustvlm_tpu_torch.models.clip.convnext)
against the JAX package's, at test-tiny-convnext (dims 8-64, depths 1-1-2-1,
32 px), on the same weights (a JAX tree through `params_from_jax`).

- zero-shot logits within 1e-5 and their pixel gradient within 1e-4, each
  of the largest magnitude of JAX's (float32; the logits carry CLIP's scale
  of 100); bf16 logits within 2e-2 of the largest;
- the open_clip TimmModel-layout importer gives, bit for bit, the tree JAX's
  importer gives, and the exporter gives back the state dict it read;
- `convnext_base_w` is JAX's config field for field, and the ViT-only
  options raise as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.eval.classifier import make_zero_shot_classifier as jax_classifier
from robustvlm_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS
from robustvlm_tpu.models.clip import init_clip_params
from robustvlm_tpu.models.clip.convnext import export_convnext_state_dict as jax_export
from robustvlm_tpu.models.clip.convnext import import_convnext_state_dict as jax_import
from robustvlm_tpu_torch.eval.classifier import make_zero_shot_classifier
from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, params_from_jax
from robustvlm_tpu_torch.models.clip.convert import export_visual_state_dict, load_clip_checkpoint
from robustvlm_tpu_torch.models.clip.convnext import export_convnext_state_dict, import_convnext_state_dict
from robustvlm_tpu_torch.models.clip.model import cast_matrices_

torch.set_num_threads(1)
NAME = "test-tiny-convnext"


@pytest.fixture(scope="module")
def both():
    cfg = JAX_CONFIGS[NAME]
    tree = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(0), cfg))
    # a layer scale of 1e-6 hides the blocks: open it so they count
    for st in tree["visual"]["stages"]:
        st["blocks"]["gamma"] = np.full_like(st["blocks"]["gamma"], 0.5)
    model = CLIP(CLIP_CONFIGS[NAME], device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return cfg, tree, model


def _inputs(n_cls=5):
    rng = np.random.RandomState(1)
    x = rng.rand(2, 3, 32, 32).astype(np.float32)
    temb = rng.randn(64, n_cls).astype(np.float32)
    return x, temb / np.linalg.norm(temb, axis=0, keepdims=True)


def test_logits_and_pixel_gradient_match_jax(both):
    cfg, tree, model = both
    x, temb = _inputs()
    jfn = jax_classifier(jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(temb), jit=False)
    ref = np.asarray(jfn(jnp.asarray(x)))
    jgrad = np.asarray(jax.grad(lambda xx: jfn(xx)[:, 0].sum())(jnp.asarray(x)))
    fn = make_zero_shot_classifier(model, torch.from_numpy(temb))
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = fn(xt)
    (grad,) = torch.autograd.grad(logits[:, 0].sum(), xt)
    assert np.abs(logits.detach().numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.abs(grad.numpy() - jgrad).max() <= 1e-4 * np.abs(jgrad).max()
    assert np.abs(ref).max() > 1.0  # the logits are not vanishing


def test_bf16_layout_matches_jax(both):
    cfg, tree, model = both
    x, temb = _inputs()
    ref = np.asarray(jax_classifier(jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(temb),
                                    compute_dtype=jnp.bfloat16)(jnp.asarray(x)))
    m16 = CLIP(CLIP_CONFIGS[NAME], device="cpu")
    m16.load_state_dict(model.state_dict())
    cast_matrices_(m16.visual, torch.bfloat16)
    assert m16.visual.stem.norm_g.dtype == torch.float32 and m16.visual.stem.w.dtype == torch.bfloat16
    got = make_zero_shot_classifier(m16, torch.from_numpy(temb), compute_dtype=torch.bfloat16)(
        torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


def test_importer_matches_jax_bit_for_bit(both):
    cfg, tree, model = both
    sd = jax_export(tree["visual"], cfg.convnext)
    ours = import_convnext_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd.items()},
                                      CLIP_CONFIGS[NAME].convnext)
    theirs = params_from_jax({"visual": jax.tree.map(np.asarray, jax_import(sd, cfg.convnext))})
    assert set(ours) == set(theirs)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    back = export_convnext_state_dict(model.state_dict(), CLIP_CONFIGS[NAME].convnext)
    assert set(back) == set(sd)
    for k in sd:
        assert np.array_equal(back[k], np.asarray(sd[k])), k


def test_checkpoint_loads_and_exports(both, tmp_path):
    _, tree, model = both
    cfg = CLIP_CONFIGS[NAME]
    visual = {k: v.clone() for k, v in export_visual_state_dict(model.state_dict(), cfg).items()}
    path = tmp_path / "visual_only.pt"
    torch.save(visual, path)
    sd = load_clip_checkpoint(str(path), cfg, base=model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_config_matches_jax():
    for name in ("convnext_base_w", NAME):
        j, t = JAX_CONFIGS[name], CLIP_CONFIGS[name]
        assert (t.embed_dim, t.image_size, t.patch_size, t.vision_arch, t.quick_gelu) == (
            j.embed_dim, j.image_size, j.patch_size, j.vision_arch, j.quick_gelu)
        assert (t.text.width, t.text.layers, t.text.heads) == (j.text.width, j.text.layers, j.text.heads)
        jc, tc = j.convnext, t.convnext
        assert (tc.depths, tc.dims, tc.patch_size, tc.kernel_size, tc.mlp_ratio, tc.ln_eps) == (
            jc.depths, jc.dims, jc.patch_size, jc.kernel_size, jc.mlp_ratio, jc.ln_eps)


def test_vit_only_options_raise(both):
    _, _, model = both
    x = torch.zeros(1, 3, 32, 32)
    for kw in ({"tokens": True}, {"n_skip_last": 1}):
        with pytest.raises(ValueError, match="ViT-tower"):
            model.encode_image(x, **kw)


def test_random_init_scheme():
    model = CLIP(CLIP_CONFIGS[NAME], device="cpu").init_random_(0)
    v = model.visual
    assert torch.equal(v.stages[1].blocks[0].gamma, torch.full((16,), 1e-6))
    assert torch.equal(v.head.norm_g, torch.ones(64)) and not v.stem.w.eq(0).all()
    assert torch.isfinite(model.encode_image(torch.rand(1, 3, 32, 32))).all()
