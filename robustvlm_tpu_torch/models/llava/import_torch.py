"""HF LLaVA-1.5 checkpoints -> the port's `Llava` state dict.

Counterpart of `robustvlm_tpu/models/llava/import_torch.py`, for the three
parts of a LLaVA checkpoint:
- the language model: LLaMA/Vicuna under `model.` (LlavaLlamaForCausalLM),
  MPT under `transformer.` (LlavaMPTForCausalLM);
- the projector, `<root>mm_projector.{0,2}.{weight,bias}` (`.0` alone for
  the `linear` type, which `checkpoint_config` reads off the keys);
- the vision tower: HF CLIPVisionModel keys (`<root>vision_tower.[vision_tower.]
  vision_model.*`), or a robust open_clip visual state dict (FARE/TeCoA,
  the port's own `export_visual_state_dict` format) in its place. The tower
  keeps every block; the forward skips the last one.
Linear weights are transposed once: torch stores (out, in), the port (in,
out).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch

from robustvlm_tpu_torch.models.clip.convert import StateDict, _t, visual_from_openai
from robustvlm_tpu_torch.models.clip.model import CLIPConfig
from robustvlm_tpu_torch.models.llama.import_torch import import_llama_state_dict
from robustvlm_tpu_torch.models.llava.model import LlavaConfig
from robustvlm_tpu_torch.models.mpt.import_torch import import_mpt_state_dict, load_state

_HF_VISION_BLOCK = {  # port leaf under blocks.<i>. <- HF key under encoder.layers.{i}., transposed
    "ln_1.g": ("layer_norm1.weight", False),
    "ln_1.b": ("layer_norm1.bias", False),
    "attn.out_w": ("self_attn.out_proj.weight", True),
    "attn.out_b": ("self_attn.out_proj.bias", False),
    "ln_2.g": ("layer_norm2.weight", False),
    "ln_2.b": ("layer_norm2.bias", False),
    "mlp.fc_w": ("mlp.fc1.weight", True),
    "mlp.fc_b": ("mlp.fc1.bias", False),
    "mlp.proj_w": ("mlp.fc2.weight", True),
    "mlp.proj_b": ("mlp.fc2.bias", False),
}


def import_hf_clip_vision(sd: Mapping[str, Any], cfg: CLIPConfig, prefix: str) -> StateDict:
    """An HF CLIPVisionModel state dict -> the port's `VisionTower` entries
    (no `vision.` prefix). HF keeps q, k and v as separate (out, in)
    Linears; the port fuses them into one (in, 3 out) qkv. HF spells the
    pre-norm `pre_layrnorm`. HF has no projection and LLaVA never uses one:
    `proj` is zeros."""
    emb = prefix + "vision_model.embeddings."
    conv = _t(sd[emb + "patch_embedding.weight"])  # (W, 3, p, p)
    w = conv.shape[0]
    out = {
        "patch_embed": conv.reshape(w, -1).T.contiguous(),
        "class_embedding": _t(sd[emb + "class_embedding"]),
        "positional_embedding": _t(sd[emb + "position_embedding.weight"]),
        "ln_pre.g": _t(sd[prefix + "vision_model.pre_layrnorm.weight"]),
        "ln_pre.b": _t(sd[prefix + "vision_model.pre_layrnorm.bias"]),
        "ln_post.g": _t(sd[prefix + "vision_model.post_layernorm.weight"]),
        "ln_post.b": _t(sd[prefix + "vision_model.post_layernorm.bias"]),
        "proj": torch.zeros(w, cfg.embed_dim),
    }
    for i in range(cfg.vision.layers):
        lay = f"{prefix}vision_model.encoder.layers.{i}."
        blk = f"blocks.{i}."
        qkv = [_t(sd[f"{lay}self_attn.{n}_proj.weight"]) for n in "qkv"]
        out[blk + "attn.qkv_w"] = torch.cat(qkv, dim=0).T.contiguous()
        out[blk + "attn.qkv_b"] = torch.cat([_t(sd[f"{lay}self_attn.{n}_proj.bias"]) for n in "qkv"])
        for ours, (theirs, transpose) in _HF_VISION_BLOCK.items():
            out[blk + ours] = _t(sd[lay + theirs], transpose)
    return out


def _vision_prefix(sd: Mapping[str, Any], base: str) -> str:
    """The HF tower's key prefix, which differs across LLaVA releases."""
    for cand in (base + "vision_tower.vision_tower.", base + "vision_tower."):
        if cand + "vision_model.embeddings.class_embedding" in sd:
            return cand
    raise ValueError("no vision tower found in LLaVA state dict")


def _root(cfg: LlavaConfig) -> str:
    return "model." if cfg.lm_family == "llama" else "transformer."


def checkpoint_config(sd: Mapping[str, Any], cfg: LlavaConfig) -> LlavaConfig:
    """`cfg` with the checkpoint's projector type: LLaVA-1.5's `mlp2x_gelu`
    stores `mm_projector.{0,2}`, the `linear` projector `mm_projector.0`
    alone (the JAX package's naming) or LLaVA's own `mm_projector`
    (`nn.Linear` unwrapped)."""
    two = _root(cfg) + "mm_projector.2.weight" in sd
    return dataclasses.replace(cfg, projector_type="mlp2x_gelu" if two else "linear")


def _first_projector(sd: Mapping[str, Any], base: str) -> str:
    """The key prefix of the projector's first linear: `mm_projector.0.`
    (a Sequential) or `mm_projector.` (LLaVA's bare linear projector)."""
    seq = base + "mm_projector.0."
    return seq if seq + "weight" in sd else base + "mm_projector."


def import_llava_state_dict(sd: Mapping[str, Any], cfg: LlavaConfig,
                            robust_vision_sd: Optional[Mapping[str, Any]] = None) -> StateDict:
    """A whole LLaVA state dict -> the port's `Llava` state dict (float32).
    `robust_vision_sd`, an open_clip visual state dict (`conv1.weight`, ...),
    replaces the checkpoint's HF tower."""
    base = _root(cfg)
    first = _first_projector(sd, base)
    out = {"projector.w1": _t(sd[first + "weight"], True),
           "projector.b1": _t(sd[first + "bias"])}
    if cfg.projector_type != "linear":
        out["projector.w2"] = _t(sd[base + "mm_projector.2.weight"], True)
        out["projector.b2"] = _t(sd[base + "mm_projector.2.bias"])
    if robust_vision_sd is not None:
        out.update({"vision." + k[len("visual."):]: v
                    for k, v in visual_from_openai(robust_vision_sd, cfg.vision).items()})
    else:
        vision = import_hf_clip_vision(sd, cfg.vision, _vision_prefix(sd, base))
        out.update({"vision." + k: v for k, v in vision.items()})
    if cfg.lm_family == "llama":
        out.update({"llama." + k: v for k, v in import_llama_state_dict(sd, cfg.llama).items()})
    else:
        # the MPT keys carry the `transformer.` root themselves
        out.update({"mpt." + k: v for k, v in import_mpt_state_dict(sd, cfg.mpt).items()})
    return out


def load_llava_checkpoint(path, cfg: LlavaConfig, robust_vision_path: Optional[str] = None) -> StateDict:
    """Read a LLaVA checkpoint (an HF directory of shards, one `.pt`/`.bin`/
    `.safetensors` file, or a state dict) and, when given, a robust tower
    file, unwrapping TeCoA's `vision_encoder_state_dict` nesting. `cfg`'s
    projector type is the one read; `checkpoint_config` gives the file's."""
    sd = load_state(path)
    rob = None
    if robust_vision_path:
        rob = load_state(robust_vision_path)
        if "vision_encoder_state_dict" in rob:
            rob = rob["vision_encoder_state_dict"]
    return import_llava_state_dict(sd, cfg, robust_vision_sd=rob)

