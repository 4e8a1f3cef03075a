"""OpenFlamingo weights into the port's state dict.

- `params_from_jax`: the JAX Flamingo tree ({"vision", "perceiver",
  "xattn", "mpt"}, numpy leaves) -> the `Flamingo` state dict, by name.
  The vision tower and the MPT go through the CLIP tree walker (their
  `blocks` carry a leading layer axis); the Perceiver's layers and the
  cross-attention blocks, stacked on a leading axis in JAX, are unstacked
  into `perceiver.layers.<i>.` and `xattn.<i>.`.
- `init_random_state`: scaled-normal random weights drawn on the device
  from a seed (the scheme of the JAX `init_flamingo_params`, not its
  numbers), with both gates of every cross-attention block at 0, as in the
  reference. Each tensor is drawn in float32 in a fixed order, so the
  bfloat16 state made directly equals `half_state` of the float32 one.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from robustvlm_tpu_torch.models.clip.convert import StateDict, _index
from robustvlm_tpu_torch.models.clip.convert import params_from_jax as _tree_to_state
from robustvlm_tpu_torch.models.flamingo.model import Flamingo, FlamingoConfig, half_state
from robustvlm_tpu_torch.models.mpt.convert import draw, matrix_std


def _prefixed(tree: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {prefix + k: v for k, v in _tree_to_state(tree).items()}


def _unstacked(tree: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """A subtree whose leaves carry a leading layer axis -> `prefix<i>.` leaves."""
    n = np.asarray(next(iter(_tree_to_state(tree).values()))).shape[0]
    out: Dict[str, Any] = {}
    for i in range(n):
        out.update(_prefixed(_index(tree, i), f"{prefix}{i}."))
    return out


def params_from_jax(tree: Mapping[str, Any]) -> StateDict:
    """A JAX Flamingo parameter tree -> the port's `Flamingo` state dict."""
    perceiver = dict(tree["perceiver"])
    layers = perceiver.pop("layers")
    out = _prefixed(tree["vision"], "vision.")
    out.update(_prefixed(perceiver, "perceiver."))
    out.update(_unstacked(layers, "perceiver.layers."))
    out.update(_unstacked(tree["xattn"], "xattn."))
    out.update(_prefixed(tree["mpt"], "mpt."))
    return out


def _std(name: str, shape, cfg: FlamingoConfig) -> float:
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("vision."):
        return cfg.vision.vision.width ** -0.5
    if name.startswith("mpt."):
        return matrix_std(leaf, cfg.mpt)
    if leaf == "latents":
        return 1.0
    return shape[0] ** -0.5  # fan-in of the (in, out) Perceiver and cross-attention matrices


@torch.no_grad()
def init_random_state(cfg: FlamingoConfig, seed: int = 0, device="cpu",
                      dtype=torch.float32) -> StateDict:
    """Random weights on `device`, the gates 0. dtype bfloat16 gives
    `half_state` of the float32 draw without holding it."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in Flamingo(cfg).state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    out: StateDict = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("attn_gate", "ff_gate"):
            t = torch.zeros(shape, device=device)
        else:
            t = draw(shape, leaf, _std(name, shape, cfg), gen, device)
        out[name] = t
        if dtype == torch.bfloat16:
            out.update(half_state({name: t}))
    return out
