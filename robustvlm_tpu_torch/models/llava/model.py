"""LLaVA-1.5: CLIP vision tower -> projector -> LLaMA (or MPT) token splice.

Counterpart of `robustvlm_tpu/models/llava/model.py`: the vision tower drops
its last transformer block (penultimate-layer features) and the CLS token;
the projector is `mlp2x_gelu` (exact GELU) or `linear`; the projected patch
tokens are spliced between the embedded prompt tokens before and after the
`<image>` placeholder; `llava_per_sample_loss` is the teacher-forced CE over
the answer span that the attacks maximize. Normalization and resizing live
inside the forward (the threat-model contract: pixels in [0,1]).

The language model is LLaMA/Vicuna (LLaVA-1.5) or MPT (LLaVA-MPT, a config
with `mpt` set). MPT's ALiBi bias depends on token distances, and
generation left-pads the post-image tokens, which puts the padding
mid-sequence (between [pre | image] and the post tokens): MPT's decode
carries a per-slot table of true positions (`kv_positions`) so that the
distances are the tokens' own.

The projector runs in float32 whatever the compute dtype, as in JAX (its
input, the tower's tokens, is float32 and its weights are too). A model held
in bfloat16 (`half_state`) keeps the projector and every 1-D parameter in
float32, so it computes what the JAX package computes with float32 weights
cast at each matmul.

A serving model may hold weight-only quantized LM leaves (`ops/quant.py`):
generation runs on them, the loss path refuses them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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
from robustvlm_tpu_torch.models.mpt.model import MPT, MPT_CONFIGS, MPTConfig, init_mpt_cache, mpt_forward
from robustvlm_tpu_torch.ops.image import normalize_clip, resize_bicubic
from robustvlm_tpu_torch.ops.quant import has_quantized, install_quantized


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    name: str
    llama: Optional[LlamaConfig]  # exactly one of llama and mpt is set
    vision: CLIPConfig
    # or "linear" (w1, b1 only); a checkpoint's own is read by
    # `import_torch.checkpoint_config`
    projector_type: str = "mlp2x_gelu"
    mpt: Optional[MPTConfig] = None  # LLaVA-MPT

    def __post_init__(self):
        if (self.llama is None) == (self.mpt is None):
            raise ValueError(f"{self.name}: a LLaVA config holds exactly one LM config, llama or mpt")

    @property
    def lm_family(self) -> str:
        return "llama" if self.mpt is None else "mpt"

    @property
    def lm_dim(self) -> int:
        return self.llama.dim if self.mpt is None else self.mpt.d_model

    @property
    def n_image_tokens(self) -> int:
        return self.vision.grid * self.vision.grid  # CLS dropped


LLAVA_CONFIGS: Dict[str, LlavaConfig] = {
    # LLaVA-1.5-7B: ViT-L/14-336 tower (576 tokens) + Vicuna-7B
    "llava-1.5-7b": LlavaConfig("llava-1.5-7b", LLAMA_CONFIGS["llama-7b"], CLIP_CONFIGS["ViT-L-14-336"]),
    # the robust tower in its place: the 224 px open_clip ViT-L/14 (256 tokens)
    "llava-1.5-7b-rob": LlavaConfig("llava-1.5-7b-rob", LLAMA_CONFIGS["llama-7b"], CLIP_CONFIGS["ViT-L-14"]),
    "test-tiny": LlavaConfig("test-tiny", LLAMA_CONFIGS["test-tiny"], CLIP_CONFIGS["test-tiny"]),
    # LLaVA-MPT; a full-size one pairs a tower with MPT-7B by dataclasses.replace
    "test-tiny-mpt": LlavaConfig("test-tiny-mpt", None, CLIP_CONFIGS["test-tiny"], mpt=MPT_CONFIGS["test-tiny"]),
}


class Projector(nn.Module):
    """`mlp2x_gelu`: linear, exact (erf) GELU, linear; `linear`: one linear."""

    def __init__(self, cfg: LlavaConfig):
        super().__init__()
        wv, d = cfg.vision.vision.width, cfg.lm_dim
        self.linear = cfg.projector_type == "linear"
        self.w1 = nn.Parameter(torch.zeros(wv, d))
        self.b1 = nn.Parameter(torch.zeros(d))
        if not self.linear:
            self.w2 = nn.Parameter(torch.zeros(d, d))
            self.b2 = nn.Parameter(torch.zeros(d))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        h = feats.float() @ self.w1.float() + self.b1.float()
        if self.linear:
            return h
        return F.gelu(h) @ self.w2.float() + self.b2.float()


class Llava(nn.Module):
    """Vision tower, projector and LM (`llama` or `mpt`, by the config's
    family). Parameters are created frozen; load a state dict (`convert.py`)
    with `from_state`."""

    def __init__(self, cfg: LlavaConfig):
        super().__init__()
        self.cfg = cfg
        self.vision = VisionTower(cfg.vision)
        self.projector = Projector(cfg)
        if cfg.lm_family == "llama":
            self.llama = Llama(cfg.llama)
        else:
            self.mpt = MPT(cfg.mpt)
        self.requires_grad_(False)

    @property
    def lm(self) -> nn.Module:
        return self.llama if self.cfg.lm_family == "llama" else self.mpt

    @classmethod
    def from_state(cls, cfg: LlavaConfig, state: Dict[str, object]) -> "Llava":
        """A model that holds `state`'s tensors themselves (no copy): built on
        the meta device, then assigned. Quantized leaves (`ops/quant.py`
        modules) take the place of their parameters."""
        with torch.device("meta"):
            model = cls(cfg)
        model.load_state_dict(install_quantized(model, state), assign=True, strict=True)
        return model.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.lm.tok_embedding.device


def _keeps_float32(name: str, t: torch.Tensor) -> bool:
    return t.dim() < 2 or name.startswith("projector.")


def half_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The bfloat16 model's state: matrices in bf16 (one copy, made once),
    the projector and 1-D parameters shared with `state` in float32."""
    return {k: v if _keeps_float32(k, v) else v.to(torch.bfloat16) for k, v in state.items()}


@torch.no_grad()
def to_half_layout_(model: Llava) -> Llava:
    """Hold the model's fp parameters as `half_state` holds them, in place,
    one parameter at a time (quantized leaves are buffers: untouched)."""
    for mod_name, mod in model.named_modules():
        for name, prm in list(mod._parameters.items()):
            full = f"{mod_name}.{name}" if mod_name else name
            if prm is not None and not _keeps_float32(full, prm) and prm.dtype != torch.bfloat16:
                mod._parameters[name] = nn.Parameter(prm.to(torch.bfloat16), requires_grad=False)
    return model


def encode_images(model: Llava, pixels01: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """[0,1] NCHW pixels -> (B, n_image_tokens, lm_dim) float32 projected
    patch features; CLIP normalization and resize inside."""
    cfg = model.cfg
    x = pixels01
    if x.shape[-1] != cfg.vision.image_size or x.shape[-2] != cfg.vision.image_size:
        x = resize_bicubic(x, cfg.vision.image_size)
    # penultimate-layer features: the tower's last block is skipped
    feats = model.vision(normalize_clip(x), compute_dtype=compute_dtype, tokens=True, n_skip_last=1)
    return model.projector(feats[:, 1:])  # CLS dropped


def splice_embeddings(model: Llava, image_feats, pre_tokens, post_tokens) -> torch.Tensor:
    """[embed(pre); image; embed(post)] in the embedding table's dtype."""
    emb = model.lm.tok_embedding
    pre, post = emb[pre_tokens], emb[post_tokens]
    return torch.cat([pre, image_feats.to(pre.dtype), post], dim=1)


def _lm_forward(model: Llava, **kw):
    """The configured family's forward, with the same keywords."""
    if model.cfg.lm_family == "llama":
        return llama_forward(model.llama, **kw)
    return mpt_forward(model.mpt, **kw)


def llava_forward(model: Llava, pixels01, pre_tokens, post_tokens, *,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Multimodal forward -> float32 logits (B, T_pre + P + T_post, V)."""
    img = encode_images(model, pixels01, compute_dtype=compute_dtype)
    embeds = splice_embeddings(model, img, pre_tokens, post_tokens)
    return _lm_forward(model, inputs_embeds=embeds, compute_dtype=compute_dtype)


def llava_per_sample_loss(model: Llava, pixels01, pre_tokens, post_tokens, labels, label_mask, *,
                          compute_dtype=torch.bfloat16, reduction_per_token: str = "mean") -> torch.Tensor:
    """Teacher-forced per-sample CE over the answer span, (B,). labels and
    label_mask are (B, T_post): only post tokens carry loss. 'mean' is HF's
    CE (mean over unmasked tokens), 'sum' the summed CE. Refuses a model with
    quantized leaves: the threat model is defined on the fp weights."""
    if has_quantized(model):
        raise ValueError("llava_per_sample_loss: the model holds quantized weights (serving-only); "
                         "the loss path needs the fp model")
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
    vision tower and the splice once, decode steps run the LM only, on fp or
    quantized LM weights alike. The cache is the stacked (L, B, ...) layout
    in both of the JAX package's param layouts (the module's layers are
    separate either way). The MPT family's carry is (cache, kv_positions),
    the true position of every cache slot, and `prefill_fn.reorder_carry`
    gathers both along the batch for beam search."""
    cfg = model.cfg
    if kv_bits and cfg.lm_family != "llama":
        raise ValueError("kv_bits is llama-family only")
    if kv_bits:
        raise NotImplementedError("the int8 KV cache is not ported (ROADMAP A13, serving)")
    img = encode_images(model, pixels01, compute_dtype=compute_dtype)
    t_prefix = pre_tokens.shape[1] + cfg.n_image_tokens
    dev = img.device
    use_kvpos = cfg.lm_family == "mpt"

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
        max_len = t_prefix + max_total_len
        kw = {}
        if use_kvpos:
            cache = init_mpt_cache(cfg.mpt, b, max_len=max_len, dtype=compute_dtype, device=dev)
            fill = torch.zeros(b, max_total_len - tokens.shape[1], dtype=pos_full.dtype, device=dev)
            kw["kv_positions"] = torch.cat([pos_full, fill], dim=1)
        else:
            cache = init_cache(cfg.llama, b, max_len=max_len, dtype=compute_dtype, device=dev)
        logits, cache = _lm_forward(model, inputs_embeds=embeds, positions=pos_full,
                                    compute_dtype=compute_dtype, cache=cache, cache_pos=0,
                                    kv_mask=kv_valid_full, **kw)
        return logits[:, -1], ((cache, kw["kv_positions"]) if use_kvpos else cache)

    def decode_fn(tok, carry, pos, kv_mask, qpos):
        b = tok.shape[0]
        kv_mask_full = torch.cat([torch.ones(b, t_prefix, dtype=torch.bool, device=dev), kv_mask], dim=1)
        kw = {}
        if use_kvpos:
            cache, kv_pos = carry
            kv_pos[:, t_prefix + int(pos)] = t_prefix + qpos[:, 0]
            kw["kv_positions"] = kv_pos
        else:
            cache = carry
        logits, cache = _lm_forward(model, tokens=tok, positions=t_prefix + qpos,
                                    compute_dtype=compute_dtype, cache=cache,
                                    cache_pos=t_prefix + pos, kv_mask=kv_mask_full, **kw)
        return logits, ((cache, kw["kv_positions"]) if use_kvpos else cache)

    if use_kvpos:
        def reorder_carry(carry, gather):
            cache, kv_pos = carry
            return {k: buf[:, gather] for k, buf in cache.items()}, kv_pos[gather]

        prefill_fn.reorder_carry = reorder_carry
    return prefill_fn, decode_fn
