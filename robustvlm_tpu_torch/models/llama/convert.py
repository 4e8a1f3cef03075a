"""LLaMA weights into the port's state dict.

`params_from_jax` carries a JAX llama tree (numpy leaves, blocks stacked on a
leading layer axis) across by name: `blocks.<i>.attn.wq`, ... The JAX
package's weight-only quantized leaves (`QuantizedWeight`,
`PackedQ4Weight`) belong to the serving slice and are refused.
"""

from __future__ import annotations

from typing import Any, Mapping

from robustvlm_tpu_torch.models.clip.convert import StateDict
from robustvlm_tpu_torch.models.clip.convert import params_from_jax as _tree_to_state


def reject_quantized(node: Any, path: str = "") -> None:
    """Raise on a quantized leaf (a named tuple of codes and scales)."""
    if isinstance(node, Mapping):
        for k, v in node.items():
            reject_quantized(v, f"{path}{k}.")
    elif hasattr(node, "_fields"):
        raise NotImplementedError(
            f"{path.rstrip('.')}: quantized weights are not ported (ROADMAP A13, serving)")


def params_from_jax(tree: Mapping[str, Any]) -> StateDict:
    """A JAX llama parameter tree -> the port's `Llama` state dict."""
    reject_quantized(tree)
    return _tree_to_state(tree)
