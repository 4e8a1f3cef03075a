"""OpenFlamingo checkpoints -> the port's `Flamingo` state dict.

Counterpart of `robustvlm_tpu/models/flamingo/import_torch.py`. The
published OpenFlamingo-9B checkpoint holds only the TRAINED modules: the
Perceiver, the gated cross-attention layers and the extended token
embedding; the frozen CLIP visual tower and MPT decoder come from their own
checkpoints (optionally a robust visual tower in place of CLIP's). Keys:
- `perceiver.latents`, `perceiver.layers.{d}.0.*` (attention),
  `perceiver.layers.{d}.1.*` (feed-forward), `perceiver.norm.*`;
- `lang_encoder.gated_cross_attn_layers.{j}.{attn,ff,attn_gate,ff_gate}`,
  one entry a cross-attention layer;
- `lang_encoder.transformer.wte.weight`, the embedding with <image> and
  <|endofchunk|>.
Linear weights are transposed once: torch stores (out, in), the port (in,
out).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

from robustvlm_tpu_torch.models.clip.convert import StateDict, _t, visual_from_openai
from robustvlm_tpu_torch.models.flamingo.model import FlamingoConfig
from robustvlm_tpu_torch.models.mpt.import_torch import import_mpt_state_dict, load_state

_PERCEIVER_LAYER = {  # port leaf under perceiver.layers.<i>. <- key under layers.{i}., transposed
    "attn.ln_media_g": ("0.norm_media.weight", False),
    "attn.ln_media_b": ("0.norm_media.bias", False),
    "attn.ln_lat_g": ("0.norm_latents.weight", False),
    "attn.ln_lat_b": ("0.norm_latents.bias", False),
    "attn.to_q": ("0.to_q.weight", True),
    "attn.to_kv": ("0.to_kv.weight", True),
    "attn.to_out": ("0.to_out.weight", True),
    "ff.ln_g": ("1.0.weight", False),
    "ff.ln_b": ("1.0.bias", False),
    "ff.w1": ("1.1.weight", True),
    "ff.w2": ("1.3.weight", True),
}
_XATTN = {  # port leaf under xattn.<i>. <- key under {i}., transposed
    "attn.ln_g": ("attn.norm.weight", False),
    "attn.ln_b": ("attn.norm.bias", False),
    "attn.to_q": ("attn.to_q.weight", True),
    "attn.to_kv": ("attn.to_kv.weight", True),
    "attn.to_out": ("attn.to_out.weight", True),
    "ff.ln_g": ("ff.0.weight", False),
    "ff.ln_b": ("ff.0.bias", False),
    "ff.w1": ("ff.1.weight", True),
    "ff.w2": ("ff.3.weight", True),
}


def _get(sd, key: str, transpose: bool):
    return _t(sd[key], transpose)


def import_perceiver(sd: Mapping[str, Any], cfg: FlamingoConfig, prefix: str = "perceiver.") -> StateDict:
    out = {"perceiver.latents": _get(sd, prefix + "latents", False),
           "perceiver.norm_g": _get(sd, prefix + "norm.weight", False),
           "perceiver.norm_b": _get(sd, prefix + "norm.bias", False)}
    for i in range(cfg.resampler_depth):
        for ours, (theirs, transpose) in _PERCEIVER_LAYER.items():
            out[f"perceiver.layers.{i}.{ours}"] = _get(sd, f"{prefix}layers.{i}.{theirs}", transpose)
    return out


def import_xattn(sd: Mapping[str, Any], cfg: FlamingoConfig,
                 prefix: str = "lang_encoder.gated_cross_attn_layers.") -> StateDict:
    out = {}
    for i in range(cfg.n_xattn):
        for ours, (theirs, transpose) in _XATTN.items():
            out[f"xattn.{i}.{ours}"] = _get(sd, f"{prefix}{i}.{theirs}", transpose)
        for gate in ("attn_gate", "ff_gate"):
            out[f"xattn.{i}.{gate}"] = _get(sd, f"{prefix}{i}.{gate}", False).reshape(())
    return out


def import_flamingo_checkpoint(of_sd: Mapping[str, Any], cfg: FlamingoConfig, *,
                               mpt_sd: Mapping[str, Any], visual_sd: Mapping[str, Any]) -> StateDict:
    """The whole state dict from the three source checkpoints; the OF
    checkpoint's extended embedding replaces MPT's."""
    out = {f"mpt.{k}": v for k, v in import_mpt_state_dict(mpt_sd, cfg.mpt).items()}
    wte = next((k for k in of_sd if k.endswith("transformer.wte.weight")), None)
    if wte is not None:
        out["mpt.tok_embedding"] = _get(of_sd, wte, False)
    out.update({"vision." + k[len("visual."):]: v
                for k, v in visual_from_openai(visual_sd, cfg.vision).items()})
    out.update(import_perceiver(of_sd, cfg))
    out.update(import_xattn(of_sd, cfg))
    return out


def load_flamingo_checkpoint(of_path, cfg: FlamingoConfig, *, mpt_path, visual_path,
                             robust_visual_path: Optional[str] = None) -> StateDict:
    """Read the three checkpoints (a robust visual tower in place of CLIP's
    when given): TeCoA's `vision_encoder_state_dict` nesting and a full
    open_clip state dict's `visual.` prefix are unwrapped."""
    visual = load_state(robust_visual_path or visual_path)
    if "vision_encoder_state_dict" in visual:
        visual = visual["vision_encoder_state_dict"]
    if any(k.startswith("visual.") for k in visual):
        visual = {k[len("visual."):]: v for k, v in visual.items() if k.startswith("visual.")}
    return import_flamingo_checkpoint(load_state(of_path), cfg, mpt_sd=load_state(mpt_path),
                                      visual_sd=visual)
