"""OPT weights into the port's state dict.

- `params_from_jax`: a JAX OPT tree (numpy leaves, blocks stacked on a
  leading layer axis) -> the `OPT` state dict, by name
  (`blocks.<i>.attn.wq`, ...).
- `init_random_state`: scaled-normal random weights drawn on the device from
  a seed (the scheme of the JAX `init_opt_params`, not its numbers): the
  token embedding at 0.02 with the LM head its transpose, positions at 0.01,
  every block matrix at dim^-0.5; LayerNorm gains 1, biases 0.

HF `OPTForCausalLM` checkpoints load through `models/blip2/import_torch.py`.
"""

from __future__ import annotations

import torch

from robustvlm_tpu_torch.models.clip.convert import StateDict, params_from_jax
from robustvlm_tpu_torch.models.opt.model import OPT, OPTConfig

__all__ = ["init_random_state", "params_from_jax"]


def _std(name: str, cfg: OPTConfig) -> float:
    leaf = name.rsplit(".", 1)[-1]
    return {"tok_embedding": 0.02, "pos_embedding": 0.01}.get(leaf, cfg.dim ** -0.5)


@torch.no_grad()
def init_random_state(cfg: OPTConfig, seed: int = 0, device="cpu") -> StateDict:
    """Random float32 OPT weights on `device`, drawn in the state dict's
    order."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in OPT(cfg).state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    out: StateDict = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "lm_head":
            out[name] = out["tok_embedding"].T.contiguous()
        elif leaf == "g":
            out[name] = torch.ones(shape, device=device)
        elif len(shape) == 1:
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.randn(shape, generator=gen, device=device) * _std(name, cfg)
    return out
