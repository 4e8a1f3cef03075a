from robustvlm_tpu_torch.models.flamingo.convert import init_random_state, params_from_jax
from robustvlm_tpu_torch.models.flamingo.import_torch import (
    import_flamingo_checkpoint,
    load_flamingo_checkpoint,
)
from robustvlm_tpu_torch.models.flamingo.model import (
    FLAMINGO_CONFIGS,
    Flamingo,
    FlamingoConfig,
    encode_vision,
    flamingo_forward,
    flamingo_per_sample_loss,
    half_state,
    make_flamingo_decode_fns,
)

__all__ = ["FLAMINGO_CONFIGS", "Flamingo", "FlamingoConfig", "encode_vision", "flamingo_forward",
           "flamingo_per_sample_loss", "half_state", "import_flamingo_checkpoint",
           "init_random_state", "load_flamingo_checkpoint", "make_flamingo_decode_fns",
           "params_from_jax"]
