from robustvlm_tpu_torch.models.blip2.convert import init_random_state, params_from_jax
from robustvlm_tpu_torch.models.blip2.model import (
    BLIP2_CONFIGS,
    Blip2,
    Blip2Config,
    Blip2VisionConfig,
    QFormerConfig,
    blip2_forward,
    blip2_image_features,
    blip2_per_sample_loss,
    blip2_vision_forward,
    half_state,
    make_blip2_decode_fns,
    qformer_forward,
)

__all__ = [
    "BLIP2_CONFIGS",
    "Blip2",
    "Blip2Config",
    "Blip2VisionConfig",
    "QFormerConfig",
    "blip2_forward",
    "blip2_image_features",
    "blip2_per_sample_loss",
    "blip2_vision_forward",
    "half_state",
    "init_random_state",
    "make_blip2_decode_fns",
    "params_from_jax",
    "qformer_forward",
]
