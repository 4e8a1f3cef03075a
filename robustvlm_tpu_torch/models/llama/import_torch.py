"""HF LlamaForCausalLM checkpoints -> the port's `Llama` state dict.

Counterpart of `robustvlm_tpu/models/llama/import_torch.py`. Keys:
`model.embed_tokens.weight`, `model.layers.{i}.{input_layernorm,
post_attention_layernorm}.weight`, `model.layers.{i}.self_attn.{q,k,v,o}_proj.weight`,
`model.layers.{i}.mlp.{gate,up,down}_proj.weight`, `model.norm.weight` and
`lm_head.weight` (the token embedding when the checkpoint ties it). HF's
rotary convention (half-split rotate_half, q/k rows permuted in the
checkpoint) is the port's `apply_rope`, so nothing is re-permuted. Linear
weights are transposed once: torch stores (out, in), the port (in, out).
`load_llama_checkpoint` reads through `models/mpt/import_torch.load_state`.
"""

from __future__ import annotations

from typing import Any, Mapping

from robustvlm_tpu_torch.models.clip.convert import StateDict, _t
from robustvlm_tpu_torch.models.llama.model import LlamaConfig
from robustvlm_tpu_torch.models.mpt.import_torch import load_state

_BLOCK = {  # port leaf under blocks.<i>. <- HF key under model.layers.{i}., transposed
    "attn_norm": ("input_layernorm.weight", False),
    "ffn_norm": ("post_attention_layernorm.weight", False),
    "attn.wq": ("self_attn.q_proj.weight", True),
    "attn.wk": ("self_attn.k_proj.weight", True),
    "attn.wv": ("self_attn.v_proj.weight", True),
    "attn.wo": ("self_attn.o_proj.weight", True),
    "mlp.w_gate": ("mlp.gate_proj.weight", True),
    "mlp.w_up": ("mlp.up_proj.weight", True),
    "mlp.w_down": ("mlp.down_proj.weight", True),
}


def import_llama_state_dict(sd: Mapping[str, Any], cfg: LlamaConfig, prefix: str = "") -> StateDict:
    """An HF LLaMA state dict -> the port's `Llama` state dict (float32)."""
    out = {"tok_embedding": _t(sd[prefix + "model.embed_tokens.weight"]),
           "norm": _t(sd[prefix + "model.norm.weight"])}
    for i in range(cfg.n_layers):
        for ours, (theirs, transpose) in _BLOCK.items():
            out[f"blocks.{i}.{ours}"] = _t(sd[f"{prefix}model.layers.{i}.{theirs}"], transpose)
    head = prefix + "lm_head.weight"
    # a checkpoint with tied embeddings has no lm_head: the embedding is the head
    out["lm_head"] = _t(sd[head if head in sd else prefix + "model.embed_tokens.weight"], True)
    return out


def load_llama_checkpoint(path_or_sd, cfg: LlamaConfig, prefix: str = "") -> StateDict:
    """From a state dict, a `.pt`/`.bin`/`.safetensors` file or an HF
    directory of shards."""
    return import_llama_state_dict(load_state(path_or_sd), cfg, prefix=prefix)
