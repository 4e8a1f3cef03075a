from robustvlm_tpu_torch.models.opt.convert import init_random_state, params_from_jax
from robustvlm_tpu_torch.models.opt.model import (
    OPT,
    OPT_CONFIGS,
    POS_OFFSET,
    OPTConfig,
    init_opt_cache,
    layer_norm,
    opt_forward,
)

__all__ = ["OPT", "OPT_CONFIGS", "OPTConfig", "POS_OFFSET", "init_opt_cache", "init_random_state",
           "layer_norm", "opt_forward", "params_from_jax"]
