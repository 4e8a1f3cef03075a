"""LLaVA weights into the port's state dict.

- `params_from_jax`: the JAX LLaVA tree ({"vision", "projector", "llama"}
  or {"vision", "projector", "mpt"}, numpy leaves, blocks stacked on a
  leading layer axis; a `linear` projector holds w1/b1 only) -> the `Llava`
  state dict, by name. Weight-only quantized LM leaves carry across as the port's
  quantized modules; the per-layer serving layout (a `layers` tuple of
  block trees, one per layer) maps onto the same `llama.blocks.<i>.` names,
  since the port's layers are separate modules anyway.
- `init_random_state`: scaled-normal random weights drawn on the device from
  a seed (the scheme of the JAX `init_llava_params`, not its numbers). Each
  tensor is drawn in float32 in a fixed order, so the bfloat16 state made
  directly equals `half_state` of the float32 one: a run that needs only
  the half model never holds float32 matrices.

Published checkpoints (HF LLaVA with an HF or a robust open_clip tower) load
through `import_torch.py`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from robustvlm_tpu_torch.models.clip.convert import StateDict
from robustvlm_tpu_torch.models.clip.convert import params_from_jax as _tree_to_state
from robustvlm_tpu_torch.models.llava.model import Llava, LlavaConfig, half_state
from robustvlm_tpu_torch.models.mpt.convert import draw, matrix_std


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX LLaVA parameter tree -> the port's `Llava` state dict."""
    tree = dict(tree)
    layers = tree.pop("layers", None)
    out = _tree_to_state(tree)
    for i, bp in enumerate(layers or ()):  # the per-layer layout: one block tree a layer
        out.update({f"llama.blocks.{i}.{k}": v for k, v in _tree_to_state(bp).items()})
    return out


def _std(name: str, shape, cfg: LlavaConfig) -> float:
    """Normal std of a matrix (0 for the ones/zeros leaves, see below)."""
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("mpt."):
        return matrix_std(leaf, cfg.mpt)
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
    other tensor normal with a fan-in std (an MPT LM as
    `models/mpt/convert.py` draws it). dtype bfloat16 gives `half_state` of
    the float32 draw."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in Llava(cfg).state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    out: StateDict = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("mpt."):
            t = draw(shape, leaf, _std(name, shape, cfg), gen, device)
        elif leaf in ("g", "attn_norm", "ffn_norm", "norm"):
            t = torch.ones(shape, device=device)
        elif leaf in ("b", "qkv_b", "out_b", "fc_b", "proj_b", "b1", "b2"):
            t = torch.zeros(shape, device=device)
        else:
            t = torch.randn(shape, generator=gen, device=device) * _std(name, shape, cfg)
        out[name] = t
        if dtype == torch.bfloat16:
            out.update(half_state({name: t}))
    return out
