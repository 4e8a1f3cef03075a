"""HF `Blip2ForConditionalGeneration` checkpoints -> the port's `Blip2` state dict.

Counterpart of `robustvlm_tpu/models/blip2/import_torch.py`, for the
Salesforce/blip2-opt-* layout (and any state dict with its keys, such as a
tiny random HF model). Linear weights are transposed once: torch stores
(out, in), the port (in, out). Each tensor is converted in one torch copy
(`models/clip/convert._t`). The Q-Former keeps HF's layer order: layer i's
`crossattention.*` exists on the leaders (i % cross_attention_frequency ==
0) alone. OPT's LM head is the token embedding in every release.
`load_blip2_checkpoint` reads through `models/mpt/import_torch.load_state`:
an HF directory of shards, one `.pt`/`.bin`/`.safetensors` file, or a state
dict; no `transformers` needed.
"""

from __future__ import annotations

from typing import Any, Mapping

from robustvlm_tpu_torch.models.blip2.model import Blip2Config
from robustvlm_tpu_torch.models.clip.convert import StateDict, _t
from robustvlm_tpu_torch.models.mpt.import_torch import load_state
from robustvlm_tpu_torch.models.opt.model import OPTConfig

_VISION_BLOCK = {  # port leaf under visual.blocks.<i>. <- HF key under encoder.layers.{i}., transposed
    "ln_1.g": ("layer_norm1.weight", False),
    "ln_1.b": ("layer_norm1.bias", False),
    "attn.qkv_w": ("self_attn.qkv.weight", True),
    "attn.qkv_b": ("self_attn.qkv.bias", False),
    "attn.out_w": ("self_attn.projection.weight", True),
    "attn.out_b": ("self_attn.projection.bias", False),
    "ln_2.g": ("layer_norm2.weight", False),
    "ln_2.b": ("layer_norm2.bias", False),
    "mlp.fc_w": ("mlp.fc1.weight", True),
    "mlp.fc_b": ("mlp.fc1.bias", False),
    "mlp.proj_w": ("mlp.fc2.weight", True),
    "mlp.proj_b": ("mlp.fc2.bias", False),
}
_QFORMER_ATTN = {  # port leaf <- HF key under {attention,crossattention}.
    "q_w": ("attention.query.weight", True), "q_b": ("attention.query.bias", False),
    "k_w": ("attention.key.weight", True), "k_b": ("attention.key.bias", False),
    "v_w": ("attention.value.weight", True), "v_b": ("attention.value.bias", False),
    "out_w": ("output.dense.weight", True), "out_b": ("output.dense.bias", False),
    "ln_g": ("output.LayerNorm.weight", False), "ln_b": ("output.LayerNorm.bias", False),
}
_QFORMER_FFN = {  # port leaf under ffn. <- HF key under the layer
    "fc_w": ("intermediate_query.dense.weight", True), "fc_b": ("intermediate_query.dense.bias", False),
    "proj_w": ("output_query.dense.weight", True), "proj_b": ("output_query.dense.bias", False),
    "ln_g": ("output_query.LayerNorm.weight", False), "ln_b": ("output_query.LayerNorm.bias", False),
}
_OPT_BLOCK = {  # port leaf under opt.blocks.<i>. <- HF key under model.decoder.layers.{i}.
    "ln1.g": ("self_attn_layer_norm.weight", False), "ln1.b": ("self_attn_layer_norm.bias", False),
    **{f"attn.w{n}": (f"self_attn.{p}_proj.weight", True) for n, p in zip("qkvo", ("q", "k", "v", "out"))},
    **{f"attn.b{n}": (f"self_attn.{p}_proj.bias", False) for n, p in zip("qkvo", ("q", "k", "v", "out"))},
    # HF names the pre-FFN norm `final_layer_norm` inside each layer
    "ln2.g": ("final_layer_norm.weight", False), "ln2.b": ("final_layer_norm.bias", False),
    "mlp.fc1": ("fc1.weight", True), "mlp.b1": ("fc1.bias", False),
    "mlp.fc2": ("fc2.weight", True), "mlp.b2": ("fc2.bias", False),
}


def _import_vision(sd: Mapping[str, Any], cfg: Blip2Config) -> StateDict:
    vc = cfg.vision
    g = lambda k: sd["vision_model." + k]
    conv = g("embeddings.patch_embedding.weight")  # (W, 3, p, p)
    w = conv.shape[0]
    out = {
        "visual.patch_embed": _t(conv.reshape(w, -1), True),
        "visual.patch_bias": _t(g("embeddings.patch_embedding.bias")),
        "visual.class_embedding": _t(g("embeddings.class_embedding").reshape(-1)),
        "visual.positional_embedding": _t(g("embeddings.position_embedding").reshape(vc.n_tokens, w)),
        "visual.ln_post.g": _t(g("post_layernorm.weight")),
        "visual.ln_post.b": _t(g("post_layernorm.bias")),
    }
    for i in range(vc.layers):
        for ours, (theirs, transpose) in _VISION_BLOCK.items():
            out[f"visual.blocks.{i}.{ours}"] = _t(g(f"encoder.layers.{i}.{theirs}"), transpose)
    return out


def _import_qformer(sd: Mapping[str, Any], cfg: Blip2Config) -> StateDict:
    qc = cfg.qformer
    out = {"qformer.ln_embed.g": _t(sd["qformer.layernorm.weight"]),
           "qformer.ln_embed.b": _t(sd["qformer.layernorm.bias"])}
    for i in range(qc.layers):
        hf, ours = f"qformer.encoder.layer.{i}.", f"qformer.layers.{i}."
        subs = [("self_attn.", "attention.", _QFORMER_ATTN), ("ffn.", "", _QFORMER_FFN)]
        if i % qc.xattn_every == 0:
            subs.append(("cross.", "crossattention.", _QFORMER_ATTN))
        for port_sub, hf_sub, table in subs:
            for leaf, (theirs, transpose) in table.items():
                out[ours + port_sub + leaf] = _t(sd[hf + hf_sub + theirs], transpose)
    return out


def _import_opt(sd: Mapping[str, Any], cfg: OPTConfig, prefix: str = "language_model.") -> StateDict:
    dec = prefix + "model.decoder."
    tok = sd[dec + "embed_tokens.weight"]
    out = {"opt.tok_embedding": _t(tok),
           "opt.pos_embedding": _t(sd[dec + "embed_positions.weight"]),
           "opt.final_norm.g": _t(sd[dec + "final_layer_norm.weight"]),
           "opt.final_norm.b": _t(sd[dec + "final_layer_norm.bias"]),
           # tied to the embedding in every OPT and BLIP-2 release
           "opt.lm_head": _t(tok, True)}
    for i in range(cfg.n_layers):
        for ours, (theirs, transpose) in _OPT_BLOCK.items():
            out[f"opt.blocks.{i}.{ours}"] = _t(sd[f"{dec}layers.{i}.{theirs}"], transpose)
    return out


def import_blip2_state_dict(sd: Mapping[str, Any], cfg: Blip2Config) -> StateDict:
    """A full `Blip2ForConditionalGeneration` state dict -> the port's
    `Blip2` state dict (float32, on the CPU)."""
    out = {"query_tokens": _t(sd["query_tokens"].reshape(cfg.num_query_tokens, cfg.qformer.width)),
           "language_projection.w": _t(sd["language_projection.weight"], True),
           "language_projection.b": _t(sd["language_projection.bias"])}
    out.update(_import_vision(sd, cfg))
    out.update(_import_qformer(sd, cfg))
    out.update(_import_opt(sd, cfg.opt))
    return out


def import_blip2_torch_model(model, cfg: Blip2Config) -> StateDict:
    """Convert a live HF `Blip2ForConditionalGeneration` module."""
    return import_blip2_state_dict(model.state_dict(), cfg)


def load_blip2_checkpoint(path_or_sd, cfg: Blip2Config) -> StateDict:
    """A Salesforce/blip2-opt-* checkpoint (an HF directory of shards, one
    `.pt`/`.bin`/`.safetensors` file, or an in-memory state dict)."""
    return import_blip2_state_dict(load_state(path_or_sd), cfg)
