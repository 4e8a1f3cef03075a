"""BLIP-2 weights into the port's state dict.

- `params_from_jax`: the JAX BLIP-2 tree ({"visual", "query_tokens",
  "qformer", "language_projection", "opt"}, numpy leaves) -> the `Blip2`
  state dict. Vision and OPT blocks are stacked on a leading layer axis and
  carry across by name; the Q-Former's grouped layout is unrolled into
  layers: `groups.self` and `groups.ffn` leaves are (n_groups, freq, ...),
  layer g * freq + j taking [g, j], and `groups.cross` (n_groups, ...)
  belongs to each group's leader, layer g * freq, alone.
- `init_random_state`: scaled-normal random weights drawn on the device from
  a seed (the scheme of the JAX `init_blip2_params`, not its numbers):
  vision matrices and embeddings at width^-0.5, Q-Former matrices and the
  language projection at the Q-Former width^-0.5, the query tokens at 0.02,
  OPT as `models/opt/convert.py` draws it; LayerNorm gains 1, biases 0. Each
  tensor is drawn in float32 in a fixed order, so the bfloat16 state made
  directly equals `half_state` of the float32 one.

HF `Blip2ForConditionalGeneration` checkpoints load through `import_torch.py`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from robustvlm_tpu_torch.models.blip2.model import Blip2, Blip2Config, half_state
from robustvlm_tpu_torch.models.clip.convert import StateDict
from robustvlm_tpu_torch.models.clip.convert import params_from_jax as _tree_to_state
from robustvlm_tpu_torch.models.opt.convert import _std as _opt_std

__all__ = ["init_random_state", "params_from_jax"]

QFORMER_SUBLAYERS = {"self": "self_attn", "cross": "cross", "ffn": "ffn"}  # JAX group key -> port


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX BLIP-2 parameter tree -> the port's `Blip2` state dict."""
    tree = dict(tree)
    qformer = dict(tree.pop("qformer"))
    groups = qformer.pop("groups")
    out = _tree_to_state({**tree, "qformer": qformer})
    n_groups, freq = np.asarray(groups["self"]["q_w"]).shape[:2]
    for g in range(n_groups):
        for j in range(freq):
            pre = f"qformer.layers.{g * freq + j}."
            for ours in ("self", "ffn"):
                out.update({f"{pre}{QFORMER_SUBLAYERS[ours]}.{k}": v for k, v in
                            _tree_to_state({k: np.asarray(a)[g, j] for k, a in groups[ours].items()}).items()})
        out.update({f"qformer.layers.{g * freq}.cross.{k}": v for k, v in
                    _tree_to_state({k: np.asarray(a)[g] for k, a in groups["cross"].items()}).items()})
    return out


def _std(name: str, cfg: Blip2Config) -> float:
    if name.startswith("opt."):
        return _opt_std(name, cfg.opt)
    if name.startswith("visual."):
        return cfg.vision.width ** -0.5
    if name == "query_tokens":
        return 0.02
    return cfg.qformer.width ** -0.5


@torch.no_grad()
def init_random_state(cfg: Blip2Config, seed: int = 0, device="cpu",
                      dtype=torch.float32) -> StateDict:
    """Random weights on `device` (see the module docstring); dtype
    bfloat16 gives `half_state` of the float32 draw."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in Blip2(cfg).state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    out: StateDict = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if name == "opt.lm_head":
            t = out["opt.tok_embedding"].float().T.contiguous()
        elif leaf in ("g", "ln_g"):
            t = torch.ones(shape, device=device)
        elif len(shape) == 1 and name != "visual.class_embedding":
            t = torch.zeros(shape, device=device)
        else:
            t = torch.randn(shape, generator=gen, device=device) * _std(name, cfg)
        out.update(half_state({name: t}) if dtype == torch.bfloat16 else {name: t})
    return out
