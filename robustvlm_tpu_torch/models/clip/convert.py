"""CLIP weights into the port's state dict.

Counterpart of `robustvlm_tpu/models/clip/import_torch.py`:

- `params_from_jax` flattens a JAX parameter tree (numpy leaves; stacked
  per-layer block tensors; lists, such as the ConvNeXt tower's stages, by
  index) into the port's state dict, by name; the JAX
  package's weight-only quantized leaves (the `QuantizedWeight` (q, s) and
  `PackedQ4Weight` (p, s) named tuples of the LLaMA serving layout) become
  the port's quantized modules (`ops/quant.py`) with their codes as they
  are, which `ops/quant.install_quantized` puts into a model;
- `export_visual_state_dict` is the inverse of `visual_from_openai`: the
  visual tower as a torch-layout state dict (`conv1.weight`, ...), the
  checkpoint format the upstream eval stack loads;
- `load_clip_checkpoint` reads the published checkpoint families: full
  openai/open_clip CLIP state dicts (`visual.conv1.weight`, ...),
  visual-only fine-tunes (FARE: `conv1.weight`, ...) overlaid on a base
  model's state dict, TeCoA dicts nested under `vision_encoder_state_dict`,
  and beta-interpolation of two checkpoints; ViT towers in the openai layout
  and ConvNeXt towers in open_clip's TimmModel layout (`trunk.*`,
  `convnext.py`).

Linear weights are transposed once at import: torch stores (out, in), the
port (like the JAX package) stores (in, out) for `x @ w`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from robustvlm_tpu_torch.models.clip.convnext import export_convnext_state_dict, import_convnext_state_dict
from robustvlm_tpu_torch.models.clip.model import CLIPConfig
from robustvlm_tpu_torch.ops.quant import PackedQ4Weight, QuantizedWeight

StateDict = Dict[str, torch.Tensor]


def _to_np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.asarray(v, dtype=np.float32)


def _t(a, transpose: bool = False) -> torch.Tensor:
    """A checkpoint tensor (torch or numpy) as a new row-major float32 CPU
    tensor, transposed when asked: one copy (a 7B checkpoint is 6.7 B
    values), never a view of the checkpoint's, and a transposed view is
    copied in row order, so the weights are laid out as if drawn in place."""
    if isinstance(a, torch.Tensor):
        src = a.detach().cpu()
        src = src.T if transpose else src
        return torch.empty(src.shape, dtype=torch.float32).copy_(src)
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.T if transpose else a, dtype=np.float32, order="C"))


def _leaf(v):
    fields = getattr(v, "_fields", None)
    if fields is None:
        return _t(v)
    if fields == ("q", "s"):
        return QuantizedWeight(torch.from_numpy(np.array(v.q, np.int8)), _t(v.s))
    if fields == ("p", "s"):
        return PackedQ4Weight(torch.from_numpy(np.array(v.p, np.uint8)), _t(v.s))
    raise ValueError(f"unknown quantized leaf with fields {fields}")


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX parameter tree (nested dicts of numpy arrays) -> the port's
    state dict. `blocks` subtrees carry a leading layer axis, which becomes
    the `blocks.<i>.` index."""
    out: Dict[str, Any] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for key, val in node.items():
            name = prefix + key
            if key == "blocks":
                n_layers = _first_leaf(val).shape[0]
                for i in range(n_layers):
                    walk(_index(val, i), f"{name}.{i}.")
            elif isinstance(val, Mapping):
                walk(val, name + ".")
            elif isinstance(val, (list, tuple)) and not hasattr(val, "_fields"):
                walk({str(i): v for i, v in enumerate(val)}, name + ".")
            else:
                out[name] = _leaf(val)

    walk(tree, "")
    return out


def _first_leaf(node):
    while isinstance(node, Mapping):
        node = next(iter(node.values()))
    if hasattr(node, "_fields"):  # a quantized leaf: its first array
        node = node[0]
    return np.asarray(node)


def _index(node, i: int):
    if isinstance(node, Mapping):
        return {k: _index(v, i) for k, v in node.items()}
    if hasattr(node, "_fields"):
        return type(node)(*(np.asarray(a)[i] for a in node))
    return np.asarray(node)[i]


def _blocks_from_openai(sd: Mapping[str, Any], prefix: str, n_layers: int, out_prefix: str) -> StateDict:
    out: StateDict = {}
    for i in range(n_layers):
        rb = f"{prefix}transformer.resblocks.{i}."
        ob = f"{out_prefix}.blocks.{i}."
        g = lambda k: sd[rb + k]
        out[ob + "ln_1.g"] = _t(g("ln_1.weight"))
        out[ob + "ln_1.b"] = _t(g("ln_1.bias"))
        out[ob + "attn.qkv_w"] = _t(g("attn.in_proj_weight"), True)
        out[ob + "attn.qkv_b"] = _t(g("attn.in_proj_bias"))
        out[ob + "attn.out_w"] = _t(g("attn.out_proj.weight"), True)
        out[ob + "attn.out_b"] = _t(g("attn.out_proj.bias"))
        out[ob + "ln_2.g"] = _t(g("ln_2.weight"))
        out[ob + "ln_2.b"] = _t(g("ln_2.bias"))
        out[ob + "mlp.fc_w"] = _t(g("mlp.c_fc.weight"), True)
        out[ob + "mlp.fc_b"] = _t(g("mlp.c_fc.bias"))
        out[ob + "mlp.proj_w"] = _t(g("mlp.c_proj.weight"), True)
        out[ob + "mlp.proj_b"] = _t(g("mlp.c_proj.bias"))
    return out


def visual_from_openai(sd: Mapping[str, Any], cfg: CLIPConfig, prefix: str = "") -> StateDict:
    """A torch visual-tower state dict (keys like `conv1.weight`, or
    `trunk.stem.0.weight` for a ConvNeXt tower) -> the port's `visual.*`
    entries."""
    if cfg.vision_arch == "convnext":
        return import_convnext_state_dict(sd, cfg.convnext, prefix)
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


def export_visual_state_dict(sd: Mapping[str, torch.Tensor], cfg: CLIPConfig) -> StateDict:
    """The port's `visual.*` entries -> a torch visual-tower state dict
    (float32, on the CPU), the inverse of `visual_from_openai`."""
    if cfg.vision_arch == "convnext":
        return {k: torch.from_numpy(v) for k, v in export_convnext_state_dict(sd, cfg.convnext).items()}
    g = lambda k: sd["visual." + k].detach().float().cpu()
    w, p = cfg.vision.width, cfg.patch_size
    out = {
        "conv1.weight": g("patch_embed").T.reshape(w, 3, p, p),
        "class_embedding": g("class_embedding"),
        "positional_embedding": g("positional_embedding"),
        "ln_pre.weight": g("ln_pre.g"),
        "ln_pre.bias": g("ln_pre.b"),
    }
    for i in range(cfg.vision.layers):
        rb, ob = f"transformer.resblocks.{i}.", f"blocks.{i}."
        for theirs, ours, transpose in (
            ("ln_1.weight", "ln_1.g", False), ("ln_1.bias", "ln_1.b", False),
            ("attn.in_proj_weight", "attn.qkv_w", True), ("attn.in_proj_bias", "attn.qkv_b", False),
            ("attn.out_proj.weight", "attn.out_w", True), ("attn.out_proj.bias", "attn.out_b", False),
            ("ln_2.weight", "ln_2.g", False), ("ln_2.bias", "ln_2.b", False),
            ("mlp.c_fc.weight", "mlp.fc_w", True), ("mlp.c_fc.bias", "mlp.fc_b", False),
            ("mlp.c_proj.weight", "mlp.proj_w", True), ("mlp.c_proj.bias", "mlp.proj_b", False),
        ):
            t = g(ob + ours)
            out[rb + theirs] = t.T if transpose else t
    out.update({"ln_post.weight": g("ln_post.g"), "ln_post.bias": g("ln_post.b"), "proj": g("proj")})
    return {k: v.contiguous() for k, v in out.items()}


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
    if "visual.conv1.weight" in sd or "visual.trunk.stem.0.weight" in sd:
        return clip_from_openai(sd, cfg)
    if "conv1.weight" in sd or "trunk.stem.0.weight" in sd:
        if base is None:
            raise ValueError("visual-only checkpoint needs a base state dict for the text tower")
        out = {k: v for k, v in base.items() if not k.startswith("visual.")}
        out.update(visual_from_openai(sd, cfg))
        return out
    raise ValueError(f"unrecognized checkpoint keys: {list(sd)[:5]} ...")
