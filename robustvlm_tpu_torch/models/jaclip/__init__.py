from robustvlm_tpu_torch.models.jaclip.model import (  # noqa: F401
    JACLIP_CONFIGS,
    BertTextConfig,
    JaCLIP,
    JaCLIPConfig,
    build_ja_text_classifier,
    default_position_ids,
    get_ja_tokenizer,
    wrap_hf_ja_tokenizer,
)
