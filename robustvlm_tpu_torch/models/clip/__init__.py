from robustvlm_tpu_torch.models.clip.convert import (
    clip_from_openai,
    export_visual_state_dict,
    load_clip_checkpoint,
    params_from_jax,
    visual_from_openai,
)
from robustvlm_tpu_torch.models.clip.model import (
    CLIP,
    CLIP_CONFIGS,
    CLIPConfig,
    TransformerConfig,
)

__all__ = [
    "CLIP",
    "CLIP_CONFIGS",
    "CLIPConfig",
    "TransformerConfig",
    "clip_from_openai",
    "export_visual_state_dict",
    "load_clip_checkpoint",
    "params_from_jax",
    "visual_from_openai",
]
