"""LLaVA weights into the port's state dict.

- `params_from_jax`: the JAX LLaVA tree ({"vision", "projector", "llama"},
  numpy leaves, blocks stacked on a leading layer axis) -> the `Llava` state
  dict, by name; the vision tower through the CLIP converter.
- `init_random_state`: scaled-normal random weights drawn on the device from
  a seed (the scheme of the JAX `init_llava_params`, not its numbers). Each
  tensor is drawn in float32 in a fixed order, so the bfloat16 state made
  directly equals `half_state` of the float32 one: a run that needs only
  the half model never holds float32 matrices.

Loading published checkpoints (HF LLaVA + the robust vision towers) waits
for a checkpoint in the repository to test it against (ROADMAP A10).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from robustvlm_tpu_torch.models.clip.convert import StateDict
from robustvlm_tpu_torch.models.clip.convert import params_from_jax as _tree_to_state
from robustvlm_tpu_torch.models.llama.convert import reject_quantized
from robustvlm_tpu_torch.models.llava.model import Llava, LlavaConfig, half_state


def params_from_jax(tree: Mapping[str, Any]) -> StateDict:
    """A JAX LLaVA parameter tree -> the port's `Llava` state dict."""
    if "mpt" in tree:
        raise NotImplementedError("LLaVA-MPT is not ported (ROADMAP A11, OpenFlamingo/MPT)")
    if "layers" in tree:
        raise NotImplementedError("the per-layer serving layout is not ported (ROADMAP A13, serving)")
    reject_quantized(tree)
    return _tree_to_state(tree)


def _std(name: str, shape, cfg: LlavaConfig) -> float:
    """Normal std of a matrix (0 for the ones/zeros leaves, see below)."""
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("vision."):
        return cfg.vision.vision.width ** -0.5
    if name.startswith("projector."):
        return shape[0] ** -0.5  # fan-in: vision width for w1, lm dim for w2
    if leaf == "tok_embedding":
        return 0.02
    if leaf == "w_down":
        return cfg.llama.ffn_dim ** -0.5
    return cfg.llama.dim ** -0.5


@torch.no_grad()
def init_random_state(cfg: LlavaConfig, seed: int = 0, device="cpu",
                      dtype=torch.float32) -> StateDict:
    """Random weights on `device`: LayerNorm/RMSNorm gains 1, biases 0, every
    other tensor normal with a fan-in std. dtype bfloat16 gives
    `half_state` of the float32 draw."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in Llava(cfg).state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    out: StateDict = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("g", "attn_norm", "ffn_norm", "norm"):
            t = torch.ones(shape, device=device)
        elif leaf in ("b", "qkv_b", "out_b", "fc_b", "proj_b", "b1", "b2"):
            t = torch.zeros(shape, device=device)
        else:
            t = torch.randn(shape, generator=gen, device=device) * _std(name, shape, cfg)
        out[name] = t
        if dtype == torch.bfloat16:
            out.update(half_state({name: t}))
    return out
