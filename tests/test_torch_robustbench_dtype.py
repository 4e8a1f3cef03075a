"""The robustbench CLI's bfloat16 tower against the float32 model cast at use
and against JAX's bfloat16 classifier.

A test-tiny checkpoint whose every visual LayerNorm gain and bias and every
visual bias carries 0.1 * N(0, 1) (random init's g = 1 and b = 0 are exact
in bf16 and would hide a rounded LayerNorm) goes through `--pretrained`
under `--compute_dtype bfloat16`. The CLI's logits must equal, bit for bit,
those of the same float32 model called with compute_dtype=bfloat16 (the
cast at use), and lie within 2e-2 of the largest |logit| of JAX's
`make_zero_shot_classifier(..., compute_dtype=jnp.bfloat16)` on the same
weights. A tower cast whole to bf16 (1-D parameters rounded) is shown to
differ, so the comparison can fail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.benchmark import templates as JT
from robustvlm_tpu.eval.classifier import build_text_classifier as jax_build_text_classifier
from robustvlm_tpu.eval.classifier import make_zero_shot_classifier as jax_zero_shot
from robustvlm_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS
from robustvlm_tpu.models.clip import init_clip_params, load_clip_checkpoint as jax_load_clip_checkpoint
from robustvlm_tpu.models.clip.import_torch import export_visual_state_dict
from robustvlm_tpu.models.clip.tokenizer import HashTokenizer as JaxHashTokenizer
from robustvlm_tpu_torch.eval import robustbench
from robustvlm_tpu_torch.eval.classifier import make_zero_shot_classifier

torch.set_num_threads(1)


def perturbed_tree(seed: int = 0):
    """test-tiny JAX params (numpy) with every visual LayerNorm g/b and
    visual bias moved by 0.1 * N(0, 1)."""
    cfg = JAX_CONFIGS["test-tiny"]
    tree = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(0), cfg))
    r = np.random.RandomState(seed)
    v = tree["visual"]

    def bump(d, k):
        d[k] = (d[k] + 0.1 * r.randn(*d[k].shape)).astype(np.float32)

    for ln in (v["ln_pre"], v["ln_post"], v["blocks"]["ln_1"], v["blocks"]["ln_2"]):
        bump(ln, "g")
        bump(ln, "b")
    for k in ("qkv_b", "out_b"):
        bump(v["blocks"]["attn"], k)
    for k in ("fc_b", "proj_b"):
        bump(v["blocks"]["mlp"], k)
    bump(v, "class_embedding")
    return cfg, tree


def openai_state_dict(tree, cfg):
    """The tree as a full openai-layout CLIP state dict (numpy)."""
    sd = {f"visual.{k}": v for k, v in export_visual_state_dict(tree["visual"], cfg).items()}
    t = tree["text"]
    sd.update({"token_embedding.weight": t["token_embedding"],
               "positional_embedding": t["positional_embedding"],
               "ln_final.weight": t["ln_final"]["g"], "ln_final.bias": t["ln_final"]["b"],
               "text_projection": t["text_projection"], "logit_scale": tree["logit_scale"]})
    bl = t["blocks"]
    for i in range(cfg.text.layers):
        rb = f"transformer.resblocks.{i}."
        sd.update({rb + "ln_1.weight": bl["ln_1"]["g"][i], rb + "ln_1.bias": bl["ln_1"]["b"][i],
                   rb + "attn.in_proj_weight": bl["attn"]["qkv_w"][i].T.copy(),
                   rb + "attn.in_proj_bias": bl["attn"]["qkv_b"][i],
                   rb + "attn.out_proj.weight": bl["attn"]["out_w"][i].T.copy(),
                   rb + "attn.out_proj.bias": bl["attn"]["out_b"][i],
                   rb + "ln_2.weight": bl["ln_2"]["g"][i], rb + "ln_2.bias": bl["ln_2"]["b"][i],
                   rb + "mlp.c_fc.weight": bl["mlp"]["fc_w"][i].T.copy(), rb + "mlp.c_fc.bias": bl["mlp"]["fc_b"][i],
                   rb + "mlp.c_proj.weight": bl["mlp"]["proj_w"][i].T.copy(),
                   rb + "mlp.c_proj.bias": bl["mlp"]["proj_b"][i]})
    return sd


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg, tree = perturbed_tree()
    path = tmp_path_factory.mktemp("ckpt") / "perturbed.pt"
    torch.save(openai_state_dict(tree, cfg), path)
    return cfg, str(path)


def _args(path, dtype):
    return robustbench.build_parser().parse_args(
        ["--device", "cpu", "--clip_model_name", "test-tiny", "--dataset", "synthetic", "--template", "std",
         "--pretrained", path, "--compute_dtype", dtype])


def test_cli_bf16_logits_equal_the_cast_at_use_model_and_jax(ckpt):
    cfg, path = ckpt
    x = torch.from_numpy(np.random.RandomState(1).rand(6, 3, 32, 32).astype(np.float32))
    model, logits_fn, _ = robustbench.build_classifier(_args(path, "bfloat16"), torch.device("cpu"))
    assert model.visual.ln_pre.g.dtype == torch.float32 and model.visual.blocks[0].attn.qkv_b.dtype == torch.float32
    assert model.visual.blocks[0].attn.qkv_w.dtype == torch.bfloat16
    with torch.no_grad():
        got = logits_fn(x)

    ref_model = robustbench.load_model(_args(path, "float32"), torch.device("cpu"))
    temb = logits_fn.text_embedding
    with torch.no_grad():
        ref = make_zero_shot_classifier(ref_model, temb, compute_dtype=torch.bfloat16)(x)
        ref_model.visual.to(torch.bfloat16)  # the whole tower rounded once, 1-D parameters too
        whole = make_zero_shot_classifier(ref_model, temb, compute_dtype=torch.bfloat16)(x)
    assert torch.equal(got, ref)
    assert not torch.equal(got, whole)

    jparams = jax_load_clip_checkpoint(path, cfg, base_params=init_clip_params(jax.random.PRNGKey(0), cfg))
    jt = JaxHashTokenizer(cfg.vocab_size, cfg.context_length)
    jtemb = jax_build_text_classifier(jparams, cfg, lambda t: jnp.asarray(jt(t)), JT.get_classnames("imagenet1k"))
    jref = np.asarray(jax_zero_shot(jparams, cfg, jtemb, compute_dtype=jnp.bfloat16)(jnp.asarray(x.numpy())))
    scale = np.abs(jref).max()
    assert np.abs(got.numpy() - jref).max() <= 2e-2 * scale
