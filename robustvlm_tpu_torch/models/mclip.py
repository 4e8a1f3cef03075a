"""Multilingual open_clip models: an XLM-RoBERTa text tower beside the CLIP
ViT vision tower.

Counterpart of `robustvlm_tpu/models/mclip.py`: the benchmark's two
multilingual rows (xlm-roberta-base-ViT-B-32, xlm-roberta-large-ViT-H-14)
as open_clip's HFTextEncoder builds them: an XLM-RoBERTa encoder (the
RoBERTa tower of `models/jaclip`, with a 250k vocabulary), the
attention-masked mean of the last hidden state, and `proj='mlp'`. The
vision tower is the port's CLIP ViT, so zero-shot classification under
attack, and the multilingual classname and template tables (`--language`),
work as for CLIP. `transformers` is an optional import: without a local
tokenizer directory the hash tokenizer runs (<s> ... </s> around hashed
word ids).
"""

from __future__ import annotations

from typing import Dict, Optional

from robustvlm_tpu_torch.models.clip.convert import _t, visual_from_openai
from robustvlm_tpu_torch.models.clip.model import CLIP_CONFIGS
from robustvlm_tpu_torch.models.jaclip.import_torch import (
    find_prefix,
    import_hf_roberta,
    logit_scale_of,
    read_state_dict,
)
from robustvlm_tpu_torch.models.jaclip.model import (  # noqa: F401
    BertTextConfig,
    JaCLIP,
    JaCLIPConfig,
    as_tokens,
    build_ja_text_classifier as build_mclip_text_classifier,
    hash_tokenizer,
)

# HF xlm-roberta-base / -large (RoBERTa architecture, vocab 250002, 514
# positions, pad 1, offset 2); the vision towers are open_clip's GELU ViTs
_XLMR_BASE = BertTextConfig(vocab_size=250002, hidden=768, layers=12, heads=12, intermediate=3072,
                            max_positions=514, pool="mean")
_XLMR_LARGE = BertTextConfig(vocab_size=250002, hidden=1024, layers=24, heads=16, intermediate=4096,
                             max_positions=514, pool="mean")

MCLIP_CONFIGS: Dict[str, JaCLIPConfig] = {
    "xlm-roberta-base-ViT-B-32": JaCLIPConfig(
        "xlm-roberta-base-ViT-B-32", _XLMR_BASE, CLIP_CONFIGS["ViT-B-32-laion"], embed_dim=512,
        proj_arch="mlp"),
    "xlm-roberta-large-ViT-H-14": JaCLIPConfig(
        "xlm-roberta-large-ViT-H-14", _XLMR_LARGE, CLIP_CONFIGS["ViT-H-14"], embed_dim=1024,
        proj_arch="mlp"),
    "test-tiny-mclip": JaCLIPConfig(
        "test-tiny-mclip",
        BertTextConfig(vocab_size=128, hidden=32, layers=2, heads=2, intermediate=64, max_positions=64,
                       pool="mean"),
        CLIP_CONFIGS["test-tiny"], embed_dim=CLIP_CONFIGS["test-tiny"].embed_dim, proj_arch="mlp"),
}


def import_open_clip_mclip(path: str, cfg: JaCLIPConfig):
    """An open_clip multilingual checkpoint -> the port's state dict: the HF
    text tower under `text.transformer.`, the MLP projection as
    `text.proj.0.weight` / `text.proj.2.weight` (GELU at 1 has no
    parameters), the ViT under `visual.`."""
    sd = read_state_dict(path)
    text_prefix = find_prefix(sd, "embeddings.word_embeddings.weight")
    if text_prefix is None:
        raise ValueError("mclip checkpoint: no HF text tower found (missing "
                         f"*embeddings.word_embeddings.weight). First keys: {sorted(sd)[:10]}")
    out = import_hf_roberta(sd, cfg.text, prefix=text_prefix)
    proj_prefix = find_prefix(sd, "proj.0.weight")
    if proj_prefix is None:
        raise ValueError("mclip checkpoint: no MLP text projection (*proj.0.weight / "
                         f"*proj.2.weight). Near misses: {[k for k in sd if 'proj' in k][:10]}")
    out["text_projection.fc_w"] = _t(sd[proj_prefix + "proj.0.weight"], True)
    out["text_projection.out_w"] = _t(sd[proj_prefix + "proj.2.weight"], True)
    vis_prefix = find_prefix(sd, "conv1.weight")
    if vis_prefix is None:  # '' is a legitimate unprefixed tower
        raise ValueError(f"mclip checkpoint: no ViT vision tower found (*conv1.weight). "
                         f"First keys: {sorted(sd)[:10]}")
    out.update(visual_from_openai(sd, cfg.vision, prefix=vis_prefix))
    out["logit_scale"] = logit_scale_of(sd)
    return out


def get_mclip_tokenizer(path: Optional[str], cfg: JaCLIPConfig, max_len: int = 77):
    """tokenize(texts) -> (input_ids, attention_mask). With a local HF
    tokenizer dir (xlm-roberta layout), open_clip's HFTokenizer: padded to
    max_len with the special tokens (<s> ... </s>); without one, the hash
    tokenizer (<s> = 0, hashed words from 3, </s> = 2)."""
    if path:
        import numpy as np
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(path)

        def tokenize(texts):
            out = tok(list(texts), padding="max_length", truncation=True, max_length=max_len,
                      return_tensors="np")
            return as_tokens(np.asarray(out["input_ids"]), np.asarray(out["attention_mask"]))

        return tokenize
    return hash_tokenizer(cfg.text, max_len, first=0, lo=3, last=2)
