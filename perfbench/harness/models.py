"""The port's models built from a configuration file, with the benchmark's
own weights (`harness.weights`) assigned to them.

The port is imported inside each function: the harness's other modules,
and the tests that walk its imports, stay free of it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from harness import weights as W


# --------------------------------------------------------------------- CLIP
def clip_config(cfg: Dict):
    """The port's CLIPConfig for an open_clip-style configuration."""
    from robustvlm_tpu_torch.models.clip.model import CLIPConfig, TransformerConfig

    v, t = cfg["vision_cfg"], cfg["text_cfg"]
    return CLIPConfig(
        "perfbench", cfg["embed_dim"], v["image_size"], v["patch_size"],
        TransformerConfig(v["width"], v["layers"], v["width"] // v.get("head_width", 64)),
        TransformerConfig(t["width"], t["layers"], t["heads"]),
        vocab_size=t["vocab_size"], context_length=t["context_length"], quick_gelu=cfg["quick_gelu"])


def clip_std(name: str, cfg: Dict) -> float:
    """The normal std of a CLIP weight (the port's `init_random_` scheme)."""
    if name == "text.token_embedding":
        return 0.02
    if name == "text.positional_embedding":
        return 0.01
    if name.startswith("text."):
        return cfg["text_cfg"]["width"] ** -0.5
    return cfg["vision_cfg"]["width"] ** -0.5


def clip_specs(cfg: Dict, matrices=torch.float32, prefix: str = "") -> Dict[str, W.Spec]:
    """Weight specs of a whole CLIP: matrices (2-D and up) in `matrices`,
    1-D and 0-D parameters in float32."""
    from robustvlm_tpu_torch.models.clip.model import CLIP

    pc = clip_config(cfg)
    specs = {}
    for name, shape in W.meta_shapes(lambda: CLIP(pc)).items():
        leaf = name.rsplit(".", 1)[-1]
        dtype = matrices if len(shape) >= 2 else torch.float32
        if leaf == "g":
            init = ("ones",)
        elif leaf in ("b", "qkv_b", "out_b", "fc_b", "proj_b"):
            init = ("zeros",)
        elif name == "logit_scale":
            init = ("fill", math.log(1 / 0.07))
        else:
            init = ("normal", clip_std(name, cfg))
        specs[prefix + name] = (shape, dtype, init)
    return specs


def build_clip(cfg: Dict, state: Dict[str, torch.Tensor]):
    """The port's CLIP holding `state`'s tensors themselves (frozen)."""
    from robustvlm_tpu_torch.models.clip.model import CLIP

    with torch.device("meta"):
        model = CLIP(clip_config(cfg))
    model.load_state_dict(state, assign=True, strict=True)
    return model.requires_grad_(False)


# ----------------------------------------------------------------- Flamingo
def flamingo_config(cfg: Dict, media_token_id: int):
    """The port's FlamingoConfig for an OpenFlamingo configuration."""
    from robustvlm_tpu_torch.models.flamingo.model import FlamingoConfig
    from robustvlm_tpu_torch.models.mpt.model import MPTConfig

    lang, per = cfg["lang"], cfg["perceiver"]
    mpt = MPTConfig("mpt-7b", lang["d_model"], lang["n_layers"], lang["n_heads"], lang["vocab_size"],
                    expansion_ratio=lang["expansion_ratio"], norm_eps=lang["norm_eps"],
                    alibi_bias_max=float(lang["alibi_bias_max"]), max_seq_len=lang["max_seq_len"])
    vision = dataclasses.replace(clip_config(cfg["vision"]), name="ViT-L-14")
    return FlamingoConfig("openflamingo-9b", mpt, vision,
                          cross_attn_every_n_layers=cfg["cross_attn_every_n_layers"],
                          resampler_depth=per["depth"], resampler_heads=per["heads"],
                          resampler_dim_head=per["dim_head"], num_latents=per["num_latents"],
                          media_token_id=media_token_id, ff_mult=per["ff_mult"])


def _norm_leaf(leaf: str) -> bool:
    return leaf in ("g", "norm_1", "norm_2", "norm_f") or leaf.endswith("_g")


def flamingo_std(name: str, shape: Tuple, cfg: Dict) -> float:
    """The normal std of an OpenFlamingo weight (the port's
    `init_random_state` scheme)."""
    leaf = name.rsplit(".", 1)[-1]
    d = cfg["lang"]["d_model"]
    if name.startswith("vision."):
        return cfg["vision"]["vision_cfg"]["width"] ** -0.5
    if name.startswith("mpt."):
        if leaf == "tok_embedding":
            return 0.02
        if leaf == "down_w":
            return (cfg["lang"]["expansion_ratio"] * d) ** -0.5
        return d ** -0.5
    if leaf == "latents":
        return 1.0
    return shape[0] ** -0.5


def flamingo_specs(cfg: Dict, gate: float) -> Dict[str, W.Spec]:
    """Weight specs in the bf16 layout the eval holds: matrices bfloat16,
    the Perceiver and every 1-D and 0-D parameter float32; both gates of
    every cross-attention block at `gate`."""
    from robustvlm_tpu_torch.models.flamingo.model import Flamingo

    specs = {}
    for name, shape in W.meta_shapes(lambda: Flamingo(flamingo_config(cfg, 0))).items():
        leaf = name.rsplit(".", 1)[-1]
        keep32 = len(shape) < 2 or name.startswith("perceiver.")
        dtype = torch.float32 if keep32 else torch.bfloat16
        if leaf in ("attn_gate", "ff_gate"):
            init = ("fill", gate)
        elif _norm_leaf(leaf):
            init = ("ones",)
        elif leaf == "b" or leaf.endswith("_b"):
            init = ("zeros",)
        else:
            init = ("normal", flamingo_std(name, shape, cfg))
        specs[name] = (shape, dtype, init)
    return specs


def build_flamingo(cfg: Dict, state: Dict[str, torch.Tensor], media_token_id: int):
    from robustvlm_tpu_torch.models.flamingo.model import Flamingo

    return Flamingo.from_state(flamingo_config(cfg, media_token_id), state)
