"""MPT weights into the port's state dict.

- `params_from_jax`: a JAX MPT tree (numpy leaves, blocks stacked on a
  leading layer axis) -> the `MPT` state dict, by name
  (`blocks.<i>.attn.wqkv`, ...).
- `matrix_std` / `init_random_state`: scaled-normal random weights drawn on
  the device from a seed (the scheme of the JAX `init_mpt_params`, not its
  numbers): the token embedding at 0.02, `down_w` at its fan-in, every other
  matrix at d_model^-0.5; norm gains 1, biases 0.
"""

from __future__ import annotations

from typing import Tuple

import torch

from robustvlm_tpu_torch.models.clip.convert import StateDict
from robustvlm_tpu_torch.models.clip.convert import params_from_jax
from robustvlm_tpu_torch.models.mpt.model import MPT, MPTConfig

__all__ = ["init_random_state", "matrix_std", "params_from_jax"]


def matrix_std(leaf: str, cfg: MPTConfig) -> float:
    """Normal std of an MPT matrix by its leaf name."""
    if leaf == "tok_embedding":
        return 0.02
    if leaf == "down_w":
        return (cfg.expansion_ratio * cfg.d_model) ** -0.5
    return cfg.d_model ** -0.5


def draw(shape: Tuple[int, ...], leaf: str, std: float, gen: torch.Generator, device) -> torch.Tensor:
    """One leaf of a random init: norm gains (`g`, `norm*`) 1, biases 0,
    else normal * std in float32."""
    if leaf in ("g", "norm_1", "norm_2", "norm_f") or leaf.endswith("_g"):
        return torch.ones(shape, device=device)
    if leaf in ("b",) or leaf.endswith("_b"):
        return torch.zeros(shape, device=device)
    return torch.randn(shape, generator=gen, device=device) * std


@torch.no_grad()
def init_random_state(cfg: MPTConfig, seed: int = 0, device="cpu") -> StateDict:
    """Random float32 MPT weights on `device`."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in MPT(cfg).state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    out: StateDict = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        out[name] = draw(shape, leaf, matrix_std(leaf, cfg), gen, device)
    return out
