from robustvlm_tpu_torch.models.llava.convert import init_random_state, params_from_jax
from robustvlm_tpu_torch.models.llava.import_torch import import_llava_state_dict, load_llava_checkpoint
from robustvlm_tpu_torch.models.llava.model import (
    LLAVA_CONFIGS,
    Llava,
    LlavaConfig,
    encode_images,
    half_state,
    llava_forward,
    llava_per_sample_loss,
    make_llava_decode_fns,
)

__all__ = ["LLAVA_CONFIGS", "Llava", "LlavaConfig", "encode_images", "half_state",
           "import_llava_state_dict", "init_random_state", "llava_forward",
           "llava_per_sample_loss", "load_llava_checkpoint", "make_llava_decode_fns",
           "params_from_jax"]
