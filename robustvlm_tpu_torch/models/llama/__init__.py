from robustvlm_tpu_torch.models.llama.convert import params_from_jax
from robustvlm_tpu_torch.models.llama.model import (
    LLAMA_CONFIGS,
    Llama,
    LlamaConfig,
    init_cache,
    llama_forward,
)

__all__ = ["LLAMA_CONFIGS", "Llama", "LlamaConfig", "init_cache", "llama_forward",
           "params_from_jax"]
