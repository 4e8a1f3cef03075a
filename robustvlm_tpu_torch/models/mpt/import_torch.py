"""MPT checkpoints in mosaicml's HF layout -> the port's state dict.

Counterpart of `robustvlm_tpu/models/mpt/import_torch.py`. Keys:
`transformer.wte.weight`, `transformer.blocks.{i}.{norm_1.weight,
attn.Wqkv.weight, attn.out_proj.weight, norm_2.weight, ffn.up_proj.weight,
ffn.down_proj.weight}`, `transformer.norm_f.weight`; MPT-7B is bias-free.
Linear weights are transposed once: torch stores (out, in), the port (in,
out). `load_state` reads what the checkpoint flags name: a state dict, a
`.pt`/`.bin`/`.safetensors` file, or an HF directory of shards.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import torch

from robustvlm_tpu_torch.models.clip.convert import StateDict, _t, _to_np
from robustvlm_tpu_torch.models.mpt.model import MPTConfig

_BLOCK = {  # port leaf <- HF key under transformer.blocks.{i}., transposed
    "norm_1": ("norm_1.weight", False),
    "norm_2": ("norm_2.weight", False),
    "attn.wqkv": ("attn.Wqkv.weight", True),
    "attn.out_w": ("attn.out_proj.weight", True),
    "mlp.up_w": ("ffn.up_proj.weight", True),
    "mlp.down_w": ("ffn.down_proj.weight", True),
}


def import_mpt_state_dict(sd: Mapping[str, Any], cfg: MPTConfig, prefix: str = "") -> StateDict:
    """A mosaicml MPT state dict -> the port's `MPT` state dict (float32)."""
    out = {"tok_embedding": _t(sd[prefix + "transformer.wte.weight"]),
           "norm_f": _t(sd[prefix + "transformer.norm_f.weight"])}
    for i in range(cfg.n_layers):
        for ours, (theirs, transpose) in _BLOCK.items():
            a = _to_np(sd[f"{prefix}transformer.blocks.{i}.{theirs}"])
            out[f"blocks.{i}.{ours}"] = _t(a.T if transpose else a)
    return out


def load_state(path_or_sd) -> Mapping[str, Any]:
    """A state dict from a mapping, a module, a file or an HF directory."""
    if not isinstance(path_or_sd, str):
        return path_or_sd.state_dict() if hasattr(path_or_sd, "state_dict") else path_or_sd
    if os.path.isdir(path_or_sd):
        names = sorted(os.listdir(path_or_sd))
        shards = [n for n in names if n.endswith(".safetensors")] or \
            [n for n in names if n.endswith((".bin", ".pt"))]
        sd: Dict[str, Any] = {}
        for n in shards:
            sd.update(load_state(os.path.join(path_or_sd, n)))
        return sd
    if path_or_sd.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path_or_sd)
    sd = torch.load(path_or_sd, map_location="cpu", weights_only=False)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def load_mpt_checkpoint(path_or_sd, cfg: MPTConfig, prefix: str = "") -> StateDict:
    return import_mpt_state_dict(load_state(path_or_sd), cfg, prefix=prefix)
