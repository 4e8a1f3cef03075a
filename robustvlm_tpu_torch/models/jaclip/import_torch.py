"""Torch checkpoints of the ja_clip family into the port's state dict.

Counterpart of `robustvlm_tpu/models/jaclip/import_torch.py`:

1. `import_hf_roberta`: a bare `transformers` RobertaModel/BertModel state
   dict -> the port's `text.*` entries (linear weights transposed to (in,
   out)); the text half of (2).
2. `import_rinna_jaclip`: the composite rinna japanese-clip checkpoint: the
   text encoder in HF-BERT layout under some prefix, a `text_projection`
   linear, and an openai-layout vision tower (rinna's is ViT-B/16). The
   prefixes are found from the keys, and a layout that does not fit raises
   with a summary of the keys it found.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional

import torch

from robustvlm_tpu_torch.models.clip.convert import _t, visual_from_openai
from robustvlm_tpu_torch.models.jaclip.model import LOGIT_SCALE_INIT, BertTextConfig, JaCLIPConfig

# (port leaf, HF key under encoder.layer.<i>., transposed)
_LAYER = (
    ("q_w", "attention.self.query.weight", True), ("q_b", "attention.self.query.bias", False),
    ("k_w", "attention.self.key.weight", True), ("k_b", "attention.self.key.bias", False),
    ("v_w", "attention.self.value.weight", True), ("v_b", "attention.self.value.bias", False),
    ("o_w", "attention.output.dense.weight", True), ("o_b", "attention.output.dense.bias", False),
    ("ln1_w", "attention.output.LayerNorm.weight", False),
    ("ln1_b", "attention.output.LayerNorm.bias", False),
    ("ff1_w", "intermediate.dense.weight", True), ("ff1_b", "intermediate.dense.bias", False),
    ("ff2_w", "output.dense.weight", True), ("ff2_b", "output.dense.bias", False),
    ("ln2_w", "output.LayerNorm.weight", False), ("ln2_b", "output.LayerNorm.bias", False),
)


def import_hf_roberta(sd: Mapping[str, Any], cfg: BertTextConfig, prefix: str = "",
                      out_prefix: str = "text.") -> Dict[str, torch.Tensor]:
    """An HF RobertaModel/BertModel state dict -> the port's text entries."""
    g = lambda k: sd[prefix + k]  # noqa: E731
    o = out_prefix
    out = {
        o + "word_emb": _t(g("embeddings.word_embeddings.weight")),
        o + "pos_emb": _t(g("embeddings.position_embeddings.weight")),
        o + "type_emb": _t(g("embeddings.token_type_embeddings.weight")),
        o + "emb_ln_w": _t(g("embeddings.LayerNorm.weight")),
        o + "emb_ln_b": _t(g("embeddings.LayerNorm.bias")),
    }
    for i in range(cfg.layers):
        for ours, theirs, transpose in _LAYER:
            out[f"{o}blocks.{i}.{ours}"] = _t(g(f"encoder.layer.{i}.{theirs}"), transpose)
    return out


def find_prefix(keys: Iterable[str], probe: str) -> Optional[str]:
    """The shortest p such that p + probe is a key ('' included), or None."""
    cands = [k[: -len(probe)] for k in keys if k.endswith(probe)]
    return min(cands, key=len) if cands else None


def read_state_dict(path: str) -> Dict[str, Any]:
    """A checkpoint's state dict, unwrapped from a training checkpoint's
    `state_dict` and DataParallel's `module.` prefixes."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return {k.removeprefix("module."): v for k, v in sd.items()}


def logit_scale_of(sd: Mapping[str, Any]) -> torch.Tensor:
    return _t(sd["logit_scale"]) if "logit_scale" in sd else torch.tensor(LOGIT_SCALE_INIT)


def import_rinna_jaclip(path: str, cfg: JaCLIPConfig) -> Dict[str, torch.Tensor]:
    sd = read_state_dict(path)
    text_prefix = find_prefix(sd, "embeddings.word_embeddings.weight")
    if text_prefix is None:
        raise ValueError(
            "ja_clip checkpoint: no HF-BERT text tower found (missing "
            f"*embeddings.word_embeddings.weight). First keys: {sorted(sd)[:10]}")
    out = import_hf_roberta(sd, cfg.text, prefix=text_prefix)
    proj_key = next((k for k in sd if k.endswith("text_projection.weight") or k == "text_projection"), None)
    if proj_key is None:
        raise ValueError("ja_clip checkpoint: no text_projection found. Keys near misses: "
                         f"{[k for k in sd if 'proj' in k][:10]}")
    proj = sd[proj_key]
    # an HF Linear (out, in) -> (in, out)
    out["text_projection"] = _t(proj, transpose=proj.shape[0] == cfg.embed_dim)
    # '' is a legitimate unprefixed tower: only a missing match means 'visual.'
    vis_prefix = find_prefix(sd, "conv1.weight")
    out.update(visual_from_openai(sd, cfg.vision, prefix="visual." if vis_prefix is None else vis_prefix))
    out["logit_scale"] = logit_scale_of(sd)
    return out
