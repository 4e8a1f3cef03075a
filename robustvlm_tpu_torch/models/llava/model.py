"""LLaVA-1.5: CLIP vision tower -> MLP projector -> LLaMA token splice.

Counterpart of `robustvlm_tpu/models/llava/model.py`: the vision tower drops
its last transformer block (penultimate-layer features) and the CLS token;
the projector is `mlp2x_gelu` (exact GELU); the projected patch
tokens are spliced between the embedded prompt tokens before and after the
`<image>` placeholder; `llava_per_sample_loss` is the teacher-forced CE over
the answer span that the attacks maximize. Normalization and resizing live
inside the forward (the threat-model contract: pixels in [0,1]).

The projector runs in float32 whatever the compute dtype, as in JAX (its
input, the tower's tokens, is float32 and its weights are too). A model held
in bfloat16 (`half_state`) keeps the projector and every 1-D parameter in
float32, so it computes what the JAX package computes with float32 weights
cast at each matmul.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from robustvlm_tpu_torch.models.clip.model import CLIP_CONFIGS, CLIPConfig, VisionTower
from robustvlm_tpu_torch.models.llama.model import (
    LLAMA_CONFIGS,
    Llama,
    LlamaConfig,
    init_cache,
    llama_forward,
)
from robustvlm_tpu_torch.ops.image import normalize_clip, resize_bicubic

@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    name: str
    llama: LlamaConfig
    vision: CLIPConfig

    @property
    def lm_dim(self) -> int:
        return self.llama.dim

    @property
    def n_image_tokens(self) -> int:
        return self.vision.grid * self.vision.grid  # CLS dropped


class _Configs(dict):
    def __missing__(self, name):
        if name == "test-tiny-mpt":
            raise NotImplementedError("LLaVA-MPT is not ported (ROADMAP A11, OpenFlamingo/MPT)")
        raise KeyError(name)


LLAVA_CONFIGS: Dict[str, LlavaConfig] = _Configs({
    # LLaVA-1.5-7B: ViT-L/14-336 tower (576 tokens) + Vicuna-7B
    "llava-1.5-7b": LlavaConfig("llava-1.5-7b", LLAMA_CONFIGS["llama-7b"], CLIP_CONFIGS["ViT-L-14-336"]),
    "test-tiny": LlavaConfig("test-tiny", LLAMA_CONFIGS["test-tiny"], CLIP_CONFIGS["test-tiny"]),
})


class Projector(nn.Module):
    """`mlp2x_gelu`: linear, exact (erf) GELU, linear."""

    def __init__(self, cfg: LlavaConfig):
        super().__init__()
        wv, d = cfg.vision.vision.width, cfg.lm_dim
        self.w1 = nn.Parameter(torch.zeros(wv, d))
        self.b1 = nn.Parameter(torch.zeros(d))
        self.w2 = nn.Parameter(torch.zeros(d, d))
        self.b2 = nn.Parameter(torch.zeros(d))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        h = feats.float() @ self.w1.float() + self.b1.float()
        return F.gelu(h) @ self.w2.float() + self.b2.float()


class Llava(nn.Module):
    """Vision tower, projector and LM. Parameters are created frozen; load a
    state dict (`convert.py`) with `from_state`."""

    def __init__(self, cfg: LlavaConfig):
        super().__init__()
        self.cfg = cfg
        self.vision = VisionTower(cfg.vision)
        self.projector = Projector(cfg)
        self.llama = Llama(cfg.llama)
        self.requires_grad_(False)

    @classmethod
    def from_state(cls, cfg: LlavaConfig, state: Dict[str, torch.Tensor]) -> "Llava":
        """A model that holds `state`'s tensors themselves (no copy): built on
        the meta device, then assigned."""
        with torch.device("meta"):
            model = cls(cfg)
        model.load_state_dict(state, assign=True, strict=True)
        return model.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.llama.norm.device


def half_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The bfloat16 model's state: matrices in bf16 (one copy, made once),
    the projector and 1-D parameters shared with `state` in float32."""
    return {k: v if v.dim() < 2 or k.startswith("projector.") else v.to(torch.bfloat16)
            for k, v in state.items()}


def encode_images(model: Llava, pixels01: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """[0,1] NCHW pixels -> (B, n_image_tokens, lm_dim) float32 projected
    patch features; CLIP normalization and resize inside."""
    cfg = model.cfg
    x = pixels01
    if x.shape[-1] != cfg.vision.image_size or x.shape[-2] != cfg.vision.image_size:
        x = resize_bicubic(x, cfg.vision.image_size)
    # penultimate-layer features: the tower's last block is dropped
    feats = model.vision(normalize_clip(x), compute_dtype=compute_dtype, tokens=True, n_skip_last=1)
    return model.projector(feats[:, 1:])  # CLS dropped


def splice_embeddings(model: Llava, image_feats, pre_tokens, post_tokens) -> torch.Tensor:
    """[embed(pre); image; embed(post)] in the embedding table's dtype."""
    emb = model.llama.tok_embedding
    pre, post = emb[pre_tokens], emb[post_tokens]
    return torch.cat([pre, image_feats.to(pre.dtype), post], dim=1)


def llava_forward(model: Llava, pixels01, pre_tokens, post_tokens, *,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Multimodal forward -> float32 logits (B, T_pre + P + T_post, V)."""
    img = encode_images(model, pixels01, compute_dtype=compute_dtype)
    embeds = splice_embeddings(model, img, pre_tokens, post_tokens)
    return llama_forward(model.llama, inputs_embeds=embeds, compute_dtype=compute_dtype)


def llava_per_sample_loss(model: Llava, pixels01, pre_tokens, post_tokens, labels, label_mask, *,
                          compute_dtype=torch.bfloat16, reduction_per_token: str = "mean") -> torch.Tensor:
    """Teacher-forced per-sample CE over the answer span, (B,). labels and
    label_mask are (B, T_post): only post tokens carry loss. 'mean' is HF's
    CE (mean over unmasked tokens), 'sum' the summed CE."""
    logits = llava_forward(model, pixels01, pre_tokens, post_tokens, compute_dtype=compute_dtype)
    t_post = post_tokens.shape[1]
    pred = logits[:, -t_post - 1:-1]  # logits predicting post_tokens[t]
    lp = torch.log_softmax(pred, dim=-1)
    tok_lp = torch.gather(lp, -1, labels[..., None].long())[..., 0]
    masked = tok_lp * label_mask
    if reduction_per_token == "mean":
        return -masked.sum(dim=-1) / label_mask.sum(dim=-1).clamp(min=1.0)
    return -masked.sum(dim=-1)


def make_llava_decode_fns(model: Llava, pixels01, pre_tokens, *, max_total_len: int,
                          compute_dtype=torch.bfloat16, kv_bits: int = 0):
    """(prefill_fn, decode_fn) for models/generation.py: prefill runs the
    vision tower and the splice once, decode steps run the LM only. The
    stacked cache layout; the per-layer serving layout comes with serving."""
    if kv_bits:
        raise NotImplementedError("the int8 KV cache is not ported (ROADMAP A13, serving)")
    cfg = model.cfg
    img = encode_images(model, pixels01, compute_dtype=compute_dtype)
    t_prefix = pre_tokens.shape[1] + cfg.n_image_tokens
    dev = img.device

    def prefill_fn(tokens, kv_valid, positions):
        # tokens are the POST tokens; the prompt is pre + image + post
        b = tokens.shape[0]
        n_rep = b // img.shape[0]
        img_r = img.repeat_interleave(n_rep, dim=0) if n_rep > 1 else img
        pre_r = pre_tokens.repeat_interleave(n_rep, dim=0) if n_rep > 1 else pre_tokens
        embeds = splice_embeddings(model, img_r, pre_r, tokens)
        kv_valid_full = torch.cat([torch.ones(b, t_prefix, dtype=torch.bool, device=dev), kv_valid], dim=1)
        pos_full = torch.cat([torch.arange(t_prefix, device=dev)[None].expand(b, t_prefix),
                              t_prefix + positions], dim=1)
        cache = init_cache(cfg.llama, b, max_len=t_prefix + max_total_len, dtype=compute_dtype,
                           device=dev)
        logits, cache = llama_forward(model.llama, inputs_embeds=embeds, positions=pos_full,
                                      compute_dtype=compute_dtype, cache=cache, cache_pos=0,
                                      kv_mask=kv_valid_full)
        return logits[:, -1], cache

    def decode_fn(tok, cache, pos, kv_mask, qpos):
        b = tok.shape[0]
        kv_mask_full = torch.cat([torch.ones(b, t_prefix, dtype=torch.bool, device=dev), kv_mask], dim=1)
        return llama_forward(model.llama, tok, positions=t_prefix + qpos,
                             compute_dtype=compute_dtype, cache=cache, cache_pos=t_prefix + pos,
                             kv_mask=kv_mask_full)

    return prefill_fn, decode_fn
