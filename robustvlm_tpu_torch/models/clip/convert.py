"""CLIP weights into the port's state dict.

Counterpart of `robustvlm_tpu/models/clip/import_torch.py`:

- `params_from_jax` flattens a JAX parameter tree (numpy leaves; stacked
  per-layer block tensors) into the port's state dict, by name;
- `load_clip_checkpoint` reads the published checkpoint families: full
  openai/open_clip CLIP state dicts (`visual.conv1.weight`, ...),
  visual-only fine-tunes (FARE: `conv1.weight`, ...) overlaid on a base
  model's state dict, TeCoA dicts nested under `vision_encoder_state_dict`,
  and beta-interpolation of two checkpoints.

Linear weights are transposed once at import: torch stores (out, in), the
port (like the JAX package) stores (in, out) for `x @ w`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from robustvlm_tpu_torch.models.clip.model import CLIPConfig

StateDict = Dict[str, torch.Tensor]


def _to_np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.asarray(v, dtype=np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(_to_np(a), dtype=np.float32, copy=True))


def params_from_jax(tree: Mapping[str, Any]) -> StateDict:
    """A JAX CLIP parameter tree (nested dicts of numpy arrays) -> the
    port's state dict. `blocks` subtrees carry a leading layer axis, which
    becomes the `blocks.<i>.` index."""
    out: StateDict = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for key, val in node.items():
            name = prefix + key
            if key == "blocks":
                n_layers = _first_leaf(val).shape[0]
                for i in range(n_layers):
                    walk(_index(val, i), f"{name}.{i}.")
            elif isinstance(val, Mapping):
                walk(val, name + ".")
            else:
                out[name] = _t(val)

    walk(tree, "")
    return out


def _first_leaf(node):
    while isinstance(node, Mapping):
        node = next(iter(node.values()))
    return np.asarray(node)


def _index(node, i: int):
    if isinstance(node, Mapping):
        return {k: _index(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def _blocks_from_openai(sd: Mapping[str, Any], prefix: str, n_layers: int, out_prefix: str) -> StateDict:
    out: StateDict = {}
    for i in range(n_layers):
        rb = f"{prefix}transformer.resblocks.{i}."
        ob = f"{out_prefix}.blocks.{i}."
        g = lambda k: sd[rb + k]
        out[ob + "ln_1.g"] = _t(g("ln_1.weight"))
        out[ob + "ln_1.b"] = _t(g("ln_1.bias"))
        out[ob + "attn.qkv_w"] = _t(_to_np(g("attn.in_proj_weight")).T)
        out[ob + "attn.qkv_b"] = _t(g("attn.in_proj_bias"))
        out[ob + "attn.out_w"] = _t(_to_np(g("attn.out_proj.weight")).T)
        out[ob + "attn.out_b"] = _t(g("attn.out_proj.bias"))
        out[ob + "ln_2.g"] = _t(g("ln_2.weight"))
        out[ob + "ln_2.b"] = _t(g("ln_2.bias"))
        out[ob + "mlp.fc_w"] = _t(_to_np(g("mlp.c_fc.weight")).T)
        out[ob + "mlp.fc_b"] = _t(g("mlp.c_fc.bias"))
        out[ob + "mlp.proj_w"] = _t(_to_np(g("mlp.c_proj.weight")).T)
        out[ob + "mlp.proj_b"] = _t(g("mlp.c_proj.bias"))
    return out


def visual_from_openai(sd: Mapping[str, Any], cfg: CLIPConfig, prefix: str = "") -> StateDict:
    """A torch visual-tower state dict (keys like `conv1.weight`) -> the
    port's `visual.*` entries."""
    g = lambda k: sd[prefix + k]
    conv = _to_np(g("conv1.weight"))  # (W, 3, p, p)
    out = {
        "visual.patch_embed": _t(conv.reshape(conv.shape[0], -1).T),
        "visual.class_embedding": _t(g("class_embedding")),
        "visual.positional_embedding": _t(g("positional_embedding")),
        "visual.ln_pre.g": _t(g("ln_pre.weight")),
        "visual.ln_pre.b": _t(g("ln_pre.bias")),
        "visual.ln_post.g": _t(g("ln_post.weight")),
        "visual.ln_post.b": _t(g("ln_post.bias")),
        "visual.proj": _t(g("proj")),
    }
    out.update(_blocks_from_openai(sd, prefix, cfg.vision.layers, "visual"))
    return out


def clip_from_openai(sd: Mapping[str, Any], cfg: CLIPConfig) -> StateDict:
    """A full openai/open_clip CLIP state dict -> the port's state dict."""
    g = lambda k: sd[k]
    out = visual_from_openai(sd, cfg, prefix="visual.")
    out.update({
        "text.token_embedding": _t(g("token_embedding.weight")),
        "text.positional_embedding": _t(g("positional_embedding")),
        "text.ln_final.g": _t(g("ln_final.weight")),
        "text.ln_final.b": _t(g("ln_final.bias")),
        "text.text_projection": _t(g("text_projection")),
        "logit_scale": _t(g("logit_scale")),
    })
    out.update(_blocks_from_openai(sd, "", cfg.text.layers, "text"))
    return out


def _read(path_or_sd) -> Mapping[str, Any]:
    sd = torch.load(path_or_sd, map_location="cpu", weights_only=False) if isinstance(path_or_sd, str) else path_or_sd
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "vision_encoder_state_dict" in sd:  # TeCoA layout
        sd = sd["vision_encoder_state_dict"]
    return sd


def _interpolate(sd1: Mapping, sd2: Mapping, beta: float) -> Dict[str, np.ndarray]:
    """beta * sd1 + (1 - beta) * sd2, elementwise."""
    return {k: beta * _to_np(sd1[k]) + (1.0 - beta) * _to_np(sd2[k]) for k in sd1}


def load_clip_checkpoint(
    path_or_sd,
    cfg: CLIPConfig,
    base: Optional[Mapping[str, torch.Tensor]] = None,
    beta: Optional[float] = None,
    interpolate_with=None,
) -> StateDict:
    """Any reference-ecosystem checkpoint -> the port's state dict.

    Full CLIP state dicts load standalone; visual-only and TeCoA dicts
    overlay the `visual.*` entries of `base` (a port state dict that
    provides the text tower); `beta` with `interpolate_with` interpolates
    two checkpoints."""
    sd = _read(path_or_sd)
    if beta is not None and interpolate_with is not None:
        sd = _interpolate(sd, _read(interpolate_with), beta)
    if "visual.conv1.weight" in sd:
        return clip_from_openai(sd, cfg)
    if "conv1.weight" in sd:
        if base is None:
            raise ValueError("visual-only checkpoint needs a base state dict for the text tower")
        out = {k: v for k, v in base.items() if not k.startswith("visual.")}
        out.update(visual_from_openai(sd, cfg))
        return out
    raise ValueError(f"unrecognized checkpoint keys: {list(sd)[:5]} ...")
