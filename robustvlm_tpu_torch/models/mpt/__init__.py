from robustvlm_tpu_torch.models.mpt.convert import init_random_state, params_from_jax
from robustvlm_tpu_torch.models.mpt.model import (
    MPT,
    MPT_CONFIGS,
    MPTConfig,
    alibi_slopes,
    init_mpt_cache,
    mpt_forward,
)

__all__ = ["MPT", "MPT_CONFIGS", "MPTConfig", "alibi_slopes", "init_mpt_cache",
           "init_random_state", "mpt_forward", "params_from_jax"]
