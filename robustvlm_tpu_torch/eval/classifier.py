"""Zero-shot classification wrappers: the threat-model adapter layer.

Counterpart of `robustvlm_tpu/eval/classifier.py`. Logits are
`logit_scale * normalize(encode_image(normalize_clip(resize(x)))) @ T`, with
T the (D, C) matrix of (optionally template-ensembled) class text
embeddings. The returned modules take raw [0,1] pixels: attacks see pixels,
and differentiation flows through resize and normalization.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from robustvlm_tpu_torch.benchmark.templates import format_prompts
from robustvlm_tpu_torch.models.clip.model import CLIP
from robustvlm_tpu_torch.ops.image import normalize_clip, resize_bicubic

STD_TEMPLATE = "This is a photo of a {}"


@torch.no_grad()
def build_text_classifier(
    model: CLIP,
    tokenize: Callable[[Sequence[str]], torch.Tensor],
    classnames: Sequence[str],
    templates: Optional[Sequence[str]] = None,
    chunk_size: int = 500,
) -> torch.Tensor:
    """(D, C) column-normalized class embedding matrix, on the model's device.

    templates=None -> the std single template; otherwise per class the mean
    of the normalized template embeddings, re-normalized."""
    device = model.logit_scale.device

    def enc(texts):
        return model.encode_text(tokenize(texts).to(device), normalize=True)

    if templates is None:
        texts = [STD_TEMPLATE.format(c) for c in classnames]
        embs = [enc(texts[i : i + chunk_size]) for i in range(0, len(texts), chunk_size)]
        return torch.cat(embs, dim=0).T.contiguous()
    cols = []
    for c in classnames:
        e = enc(format_prompts(templates, c)).mean(dim=0)
        cols.append(e / torch.linalg.norm(e))
    return torch.stack(cols, dim=1)


class ZeroShotClassifier(nn.Module):
    """x01 (B, 3, H, W) -> (B, C) logits; resize and normalize inside."""

    def __init__(self, model: CLIP, text_embedding: torch.Tensor, scale: torch.Tensor,
                 resize_to: Optional[int], compute_dtype):
        super().__init__()
        self.model = model
        self.register_buffer("text_embedding", text_embedding)
        self.register_buffer("scale", scale)
        self.resize_to = resize_to
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if self.resize_to is not None:
            x = resize_bicubic(x, self.resize_to)
        e = self.model.encode_image(normalize_clip(x), normalize=True,
                                    compute_dtype=self.compute_dtype)
        return (e @ self.text_embedding) * self.scale


def make_zero_shot_classifier(
    model: CLIP,
    text_embedding: torch.Tensor,
    *,
    logit_scale: Optional[float] = 100.0,
    resize_to: Optional[int] = None,
    compute_dtype=torch.float32,
) -> ZeroShotClassifier:
    """logit_scale=None multiplies by exp(model.logit_scale); a float
    multiplies the logits directly (0 would zero them and is rejected)."""
    if logit_scale == 0:
        raise ValueError("logit_scale=0 zeroes all logits; use 1.0 for unscaled")
    device = model.logit_scale.device
    if logit_scale is None:
        scale = torch.exp(model.logit_scale.detach().float())
    else:
        scale = torch.tensor(logit_scale, dtype=torch.float32, device=device)
    return ZeroShotClassifier(model, text_embedding.float(), scale, resize_to, compute_dtype)


class EmbeddingModel(nn.Module):
    """x01 -> (B, D) image embedding, normalize inside (the FARE/TeCoA
    training wrapper)."""

    def __init__(self, model: CLIP, output_normalize: bool, compute_dtype):
        super().__init__()
        self.model = model
        self.output_normalize = output_normalize
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return self.model.encode_image(normalize_clip(x), normalize=self.output_normalize,
                                       compute_dtype=self.compute_dtype)


def make_embedding_fn(model: CLIP, *, output_normalize: bool = False,
                      compute_dtype=torch.float32) -> EmbeddingModel:
    return EmbeddingModel(model, output_normalize, compute_dtype)
