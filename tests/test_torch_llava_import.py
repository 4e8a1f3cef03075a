"""The port's HF LLaMA / LLaVA importers (robustvlm_tpu_torch.models.
{llama,llava}.import_torch) against the JAX package's importers plus
`params_from_jax`, on random HF-layout state dicts made from a seeded JAX
init as tests/test_llava.py builds them: every tensor bit-equal. Covers
test-tiny with both projector types and its HF tower under both prefixes,
test-tiny-mpt under `transformer.`, the robust open_clip tower plain and in
TeCoA's `vision_encoder_state_dict` wrapper, directories of `torch.save` /
`.safetensors` shards, one `.pt` file, and the tied-`lm_head` fallback."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from robustvlm_tpu.models.clip.import_torch import export_visual_state_dict as j_export_visual
from robustvlm_tpu.models.llama import import_torch as JL
from robustvlm_tpu.models.llava import import_torch as JI
from robustvlm_tpu.models.llava.model import LLAVA_CONFIGS as J_CONFIGS
from robustvlm_tpu.models.llava.model import init_llava_params
from robustvlm_tpu_torch.models.llama import import_torch as PL
from robustvlm_tpu_torch.models.llama.model import LLAMA_CONFIGS
from robustvlm_tpu_torch.models.llava import import_torch as PI
from robustvlm_tpu_torch.models.llava.convert import params_from_jax
from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS, Llava


def _cfgs(name, projector_type="mlp2x_gelu"):
    j, p = J_CONFIGS[name], LLAVA_CONFIGS[name]
    return (dataclasses.replace(j, projector_type=projector_type),
            dataclasses.replace(p, projector_type=projector_type))


def _np(a):
    return np.ascontiguousarray(np.asarray(a, np.float32))


def _hf_llama(tree, cfg, sd, tied=False):
    """The HF LlamaForCausalLM keys of a JAX llama tree, (out, in) Linears."""
    b = tree["blocks"]
    sd["model.embed_tokens.weight"] = _np(tree["tok_embedding"])
    sd["model.norm.weight"] = _np(tree["norm"])
    if not tied:
        sd["lm_head.weight"] = _np(np.asarray(tree["lm_head"]).T)
    for i in range(cfg.n_layers):
        lay = f"model.layers.{i}."
        sd[lay + "input_layernorm.weight"] = _np(b["attn_norm"][i])
        sd[lay + "post_attention_layernorm.weight"] = _np(b["ffn_norm"][i])
        for n in ("q", "k", "v", "o"):
            sd[lay + f"self_attn.{n}_proj.weight"] = _np(np.asarray(b["attn"][f"w{n}"][i]).T)
        for n in ("gate", "up", "down"):
            sd[lay + f"mlp.{n}_proj.weight"] = _np(np.asarray(b["mlp"][f"w_{n}"][i]).T)


def _hf_mpt(tree, cfg, sd):
    b = tree["blocks"]
    sd["transformer.wte.weight"] = _np(tree["tok_embedding"])
    sd["transformer.norm_f.weight"] = _np(tree["norm_f"])
    for i in range(cfg.n_layers):
        blk = f"transformer.blocks.{i}."
        sd[blk + "norm_1.weight"] = _np(b["norm_1"][i])
        sd[blk + "norm_2.weight"] = _np(b["norm_2"][i])
        sd[blk + "attn.Wqkv.weight"] = _np(np.asarray(b["attn"]["wqkv"][i]).T)
        sd[blk + "attn.out_proj.weight"] = _np(np.asarray(b["attn"]["out_w"][i]).T)
        sd[blk + "ffn.up_proj.weight"] = _np(np.asarray(b["mlp"]["up_w"][i]).T)
        sd[blk + "ffn.down_proj.weight"] = _np(np.asarray(b["mlp"]["down_w"][i]).T)


def _hf_vision(vis, cfg, prefix, sd):
    """HF CLIPVisionModel keys of a JAX visual tree: q/k/v split, (out, in)."""
    w = cfg.vision.width
    emb = prefix + "vision_model.embeddings."
    sd[emb + "patch_embedding.weight"] = _np(np.asarray(vis["patch_embed"]).T.reshape(w, 3, cfg.patch_size,
                                                                                      cfg.patch_size))
    sd[emb + "class_embedding"] = _np(vis["class_embedding"])
    sd[emb + "position_embedding.weight"] = _np(vis["positional_embedding"])
    for ln, key in (("ln_pre", "pre_layrnorm"), ("ln_post", "post_layernorm")):
        sd[prefix + f"vision_model.{key}.weight"] = _np(vis[ln]["g"])
        sd[prefix + f"vision_model.{key}.bias"] = _np(vis[ln]["b"])
    b = vis["blocks"]
    for i in range(cfg.vision.layers):
        lay = f"{prefix}vision_model.encoder.layers.{i}."
        qkv_w, qkv_b = np.asarray(b["attn"]["qkv_w"][i]).T, np.asarray(b["attn"]["qkv_b"][i])
        for j, n in enumerate("qkv"):
            sd[lay + f"self_attn.{n}_proj.weight"] = _np(qkv_w[j * w:(j + 1) * w])
            sd[lay + f"self_attn.{n}_proj.bias"] = _np(qkv_b[j * w:(j + 1) * w])
        sd[lay + "self_attn.out_proj.weight"] = _np(np.asarray(b["attn"]["out_w"][i]).T)
        sd[lay + "self_attn.out_proj.bias"] = _np(b["attn"]["out_b"][i])
        for k in (1, 2):
            sd[lay + f"layer_norm{k}.weight"] = _np(b[f"ln_{k}"]["g"][i])
            sd[lay + f"layer_norm{k}.bias"] = _np(b[f"ln_{k}"]["b"][i])
        sd[lay + "mlp.fc1.weight"] = _np(np.asarray(b["mlp"]["fc_w"][i]).T)
        sd[lay + "mlp.fc1.bias"] = _np(b["mlp"]["fc_b"][i])
        sd[lay + "mlp.fc2.weight"] = _np(np.asarray(b["mlp"]["proj_w"][i]).T)
        sd[lay + "mlp.fc2.bias"] = _np(b["mlp"]["proj_b"][i])


def _hf_llava(jcfg, seed=3, tower_prefix="vision_tower.vision_tower.", tied=False):
    """A random HF-layout LLaVA state dict (numpy) and its JAX source tree."""
    tree = init_llava_params(jax.random.PRNGKey(seed), jcfg)
    base = "model." if jcfg.lm_family == "llama" else "transformer."
    sd = {}
    pr = tree["projector"]
    sd[base + "mm_projector.0.weight"] = _np(np.asarray(pr["w1"]).T)
    sd[base + "mm_projector.0.bias"] = _np(pr["b1"])
    if jcfg.projector_type != "linear":
        sd[base + "mm_projector.2.weight"] = _np(np.asarray(pr["w2"]).T)
        sd[base + "mm_projector.2.bias"] = _np(pr["b2"])
    if tower_prefix is not None:
        _hf_vision(tree["vision"], jcfg.vision, base + tower_prefix, sd)
    if jcfg.lm_family == "llama":
        _hf_llama(tree["llama"], jcfg.llama, sd, tied=tied)
    else:
        _hf_mpt(tree["mpt"], jcfg.mpt, sd)
    return sd, tree


def _robust_tower(tree, jcfg):
    """An open_clip visual state dict (`conv1.weight`, ...) of a tower that
    differs from the checkpoint's own."""
    vis = jax.tree.map(lambda a: np.asarray(a) * 0.5 + 0.25, tree["vision"])
    return {k: _np(v) for k, v in j_export_visual(vis, jcfg.vision).items()}


def _assert_bit_equal(port, jax_tree):
    ref = params_from_jax(jax.tree.map(np.asarray, jax_tree))
    assert set(port) == set(ref)
    for k, v in ref.items():
        assert port[k].dtype == torch.float32 and port[k].is_contiguous(), k
        assert torch.equal(port[k], v), k


def _as_torch(sd):
    return {k: torch.from_numpy(v.copy()) for k, v in sd.items()}


CASES = {  # id: (config, projector, HF tower prefix or None, robust tower: None | plain | wrapped)
    "tiny-mlp": ("test-tiny", "mlp2x_gelu", "vision_tower.vision_tower.", None),
    "tiny-linear": ("test-tiny", "linear", "vision_tower.", None),
    "tiny-mpt": ("test-tiny-mpt", "mlp2x_gelu", "vision_tower.", None),
    "tiny-robust-plain": ("test-tiny", "mlp2x_gelu", None, "plain"),
    "tiny-robust-wrapped": ("test-tiny", "mlp2x_gelu", None, "wrapped"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_import_llava_state_dict_bit_equal_jax(case):
    name, proj, prefix, robust = CASES[case]
    jcfg, pcfg = _cfgs(name, proj)
    sd, tree = _hf_llava(jcfg, tower_prefix=prefix)
    rob = _robust_tower(tree, jcfg) if robust else None
    ref = JI.import_llava_state_dict(sd, jcfg, robust_vision_sd=rob)
    got = PI.import_llava_state_dict(_as_torch(sd), pcfg,
                                     robust_vision_sd=None if rob is None else _as_torch(rob))
    _assert_bit_equal(got, ref)
    Llava.from_state(pcfg, got)  # every parameter present, none extra


@pytest.mark.parametrize("layout", ["bin-shards", "safetensors-shards", "one-pt"])
def test_load_llava_checkpoint_bit_equal_jax(tmp_path, layout):
    """A checkpoint on disk and a robust tower file in the TeCoA wrapper,
    read by both loaders."""
    jcfg, pcfg = _cfgs("test-tiny")
    sd, tree = _hf_llava(jcfg, seed=5, tower_prefix=None)
    sd = _as_torch(sd)
    keys = sorted(sd)
    if layout == "one-pt":
        path = tmp_path / "llava.pt"
        torch.save(sd, path)
    else:
        path = tmp_path / "llava"
        path.mkdir()
        halves = ({k: sd[k] for k in keys[::2]}, {k: sd[k] for k in keys[1::2]})
        for i, part in enumerate(halves):
            if layout == "bin-shards":
                torch.save(part, path / f"pytorch_model-0000{i + 1}-of-00002.bin")
            else:
                from safetensors.torch import save_file

                save_file(part, str(path / f"model-0000{i + 1}-of-00002.safetensors"))
    rob = tmp_path / "fare.pt"
    torch.save({"vision_encoder_state_dict": _as_torch(_robust_tower(tree, jcfg))}, rob)
    ref = JI.load_llava_checkpoint(str(path), jcfg, robust_vision_path=str(rob))
    got = PI.load_llava_checkpoint(str(path), pcfg, robust_vision_path=str(rob))
    _assert_bit_equal(got, ref)


def test_load_llama_checkpoint_tied_head_bit_equal_jax(tmp_path):
    """Without `lm_head.weight` the embedding is the head, in both."""
    jcfg, _ = _cfgs("test-tiny")
    sd, _ = _hf_llava(jcfg, seed=7, tower_prefix=None, tied=True)
    assert "lm_head.weight" not in sd
    path = tmp_path / "llama.pt"
    torch.save(_as_torch(sd), path)
    cfg = LLAMA_CONFIGS["test-tiny"]
    ref = JL.load_llama_checkpoint(str(path), jcfg.llama)
    got = PL.load_llama_checkpoint(str(path), cfg)
    _assert_bit_equal(got, ref)
    assert torch.equal(got["lm_head"], got["tok_embedding"].T)


def test_missing_tower_and_missing_file_raise(tmp_path):
    jcfg, pcfg = _cfgs("test-tiny")
    sd, _ = _hf_llava(jcfg, tower_prefix=None)
    with pytest.raises(ValueError, match="no vision tower"):
        PI.import_llava_state_dict(_as_torch(sd), pcfg)
    with pytest.raises(FileNotFoundError):
        PI.load_llava_checkpoint(str(tmp_path / "absent"), pcfg)


@pytest.mark.parametrize("proj", ["mlp2x_gelu", "linear"])
def test_cli_loader_reads_projector_type_bit_equal_jax(tmp_path, proj):
    """`--llava_ckpt` builds the model with the checkpoint's own projector
    type (`checkpoint_config`), whichever type the CLI's config names; its
    weights are the JAX importer's for that type, bit-equal."""
    import argparse

    from robustvlm_tpu_torch.vlm_eval.run_evaluation import build_llava_models

    jcfg, pcfg = _cfgs("test-tiny", proj)
    sd, _ = _hf_llava(jcfg, seed=9)
    path = tmp_path / "llava.pt"
    torch.save(_as_torch(sd), path)
    args = argparse.Namespace(model_size="test-tiny", llava_ckpt=str(path), vision_encoder_pretrained="")
    model = build_llava_models(args, ("full",), torch.device("cpu"))["full"]
    assert model.cfg.projector_type == proj == PI.checkpoint_config(sd, LLAVA_CONFIGS["test-tiny"]).projector_type
    _assert_bit_equal(dict(model.state_dict()), JI.import_llava_state_dict(sd, jcfg))


def test_linear_projector_upstream_keys_load_the_same_weights():
    """LLaVA names its `linear` projector's keys `mm_projector.{weight,bias}`
    (a bare `nn.Linear`); the JAX naming is `mm_projector.0.*`. Both load
    the same weights, and both read as a linear projector."""
    jcfg, pcfg = _cfgs("test-tiny", "linear")
    sd, _ = _hf_llava(jcfg, seed=3)
    upstream = {("model.mm_projector." + k[len("model.mm_projector.0."):]
                 if k.startswith("model.mm_projector.0.") else k): v for k, v in sd.items()}
    assert "model.mm_projector.weight" in upstream and "model.mm_projector.0.weight" not in upstream
    base = LLAVA_CONFIGS["test-tiny"]
    assert PI.checkpoint_config(upstream, base).projector_type == "linear"
    got = PI.import_llava_state_dict(_as_torch(upstream), pcfg)
    ref = PI.import_llava_state_dict(_as_torch(sd), pcfg)
    assert got.keys() == ref.keys()
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    Llava.from_state(pcfg, got)  # every parameter present, none extra
