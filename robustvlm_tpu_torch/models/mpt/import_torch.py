"""MPT checkpoints in mosaicml's HF layout -> the port's state dict.

Counterpart of `robustvlm_tpu/models/mpt/import_torch.py`. Keys:
`transformer.wte.weight`, `transformer.blocks.{i}.{norm_1.weight,
attn.Wqkv.weight, attn.out_proj.weight, norm_2.weight, ffn.up_proj.weight,
ffn.down_proj.weight}`, `transformer.norm_f.weight`; MPT-7B is bias-free.
Linear weights are transposed once: torch stores (out, in), the port (in,
out). `load_state` reads what the checkpoint flags name: a state dict, a
`.pt`/`.bin`/`.safetensors` file, or an HF directory of shards; the LLaMA
and LLaVA importers read through it too.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import torch

from robustvlm_tpu_torch.models.clip.convert import StateDict, _t
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
            out[f"blocks.{i}.{ours}"] = _t(sd[f"{prefix}transformer.blocks.{i}.{theirs}"], transpose)
    return out


def load_state(path_or_sd) -> Mapping[str, Any]:
    """A state dict from a mapping, a module, a file or an HF directory (the
    reader of every checkpoint loader of the port). A directory merges its
    `.safetensors` shards, else its `.bin`/`.pt` shards; `.bin`/`.pt` need
    torch alone, `.safetensors` the `safetensors` package (an optional
    import: without it such a checkpoint raises, naming the package)."""
    if not isinstance(path_or_sd, (str, os.PathLike)):
        return path_or_sd.state_dict() if hasattr(path_or_sd, "state_dict") else path_or_sd
    path = os.fspath(path_or_sd)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    if os.path.isdir(path):
        names = sorted(os.listdir(path))
        shards = [n for n in names if n.endswith(".safetensors")] or \
            [n for n in names if n.endswith((".bin", ".pt"))]
        if not shards:
            raise FileNotFoundError(f"no .safetensors, .bin or .pt shard in {path}")
        sd: Dict[str, Any] = {}
        for n in shards:
            sd.update(load_state(os.path.join(path, n)))
        return sd
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"{path}: reading .safetensors needs the `safetensors` package") from e
        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def load_mpt_checkpoint(path_or_sd, cfg: MPTConfig, prefix: str = "") -> StateDict:
    return import_mpt_state_dict(load_state(path_or_sd), cfg, prefix=prefix)
