"""LLaMA weights into the port's state dict.

`params_from_jax` carries a JAX llama tree (numpy leaves, blocks stacked on a
leading layer axis) across by name: `blocks.<i>.attn.wq`, ... Weight-only
quantized leaves become the port's quantized modules
(`models/clip/convert.params_from_jax`).
"""

from robustvlm_tpu_torch.models.clip.convert import params_from_jax

__all__ = ["params_from_jax"]
