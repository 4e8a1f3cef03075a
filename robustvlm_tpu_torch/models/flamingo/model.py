"""OpenFlamingo: CLIP ViT -> Perceiver resampler -> gated cross-attention
into a frozen MPT decoder, as PyTorch modules.

Counterpart of `robustvlm_tpu/models/flamingo/model.py`:
- `perceiver_resampler`: learned latents attend to [media; latents] in each
  media slot (all slots batched), LN-free residuals and a 4x GELU
  feed-forward a layer, a final LayerNorm;
- `masked_cross_attention`: text queries attend to the latents of their
  IMMEDIATELY preceding <image> only (the time of a text token is the count
  of media tokens up to it), and tokens before any media get a zero
  cross-attention;
- `gated_xattn_block`: the attention and the feed-forward scaled by
  tanh(attn_gate) and tanh(ff_gate), both initialised 0 as in the reference
  (the block is the identity at init, so a random Flamingo with those gates
  ignores its image);
- blocks go into every `cross_attn_every_n_layers`-th decoder layer through
  `mpt_forward`'s `layer_hook`.

The Perceiver and cross-attention are plain matmuls and a float32 softmax,
as in JAX (einsums outside any kernel there): the cross-attention mask is
neither causal nor ALiBi, so no attention kernel encodes it. Their
LayerNorms (`_ln`) are `block_ops.layer_norm`: one-pass kernels on a CUDA
tensor. The Perceiver runs in float32 whatever the compute dtype (its
input, the vision tower's tokens, is float32 and so are its weights, as in
JAX); a model held in bfloat16 (`half_state`) keeps it and every 1-D
parameter in float32.

Split over the mesh's `model` axis (`parallel/mesh.shard_params`): the
ViT-L/14 tower and the MPT blocks as their modules say; each Perceiver and
cross-attention module whose heads m divides holds this rank's heads (the q
columns, the fused [k|v] columns of its heads, the out rows) and each
feed-forward its ffn columns, and the out and w2 products are summed over
`model` before the residual and before the gates multiply
(`parallel/tensor_parallel.py`). The LayerNorms, the latents and the gates
stay whole. The decode cache holds the rank's heads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from robustvlm_tpu_torch.models.clip.model import CLIP_CONFIGS, CLIPConfig, VisionTower
from robustvlm_tpu_torch.models.mpt.model import (
    MPT,
    MPT_CONFIGS,
    MPTConfig,
    init_mpt_cache,
    local_heads,
    mpt_forward,
)
from robustvlm_tpu_torch.ops.image import normalize_clip, resize_bicubic
from robustvlm_tpu_torch.ops.kernels import block_ops
from robustvlm_tpu_torch.parallel.tensor_parallel import column_parallel, local, row_parallel


@dataclasses.dataclass(frozen=True)
class FlamingoConfig:
    name: str
    mpt: MPTConfig
    vision: CLIPConfig
    cross_attn_every_n_layers: int = 4
    resampler_depth: int = 6
    resampler_heads: int = 8
    resampler_dim_head: int = 64
    num_latents: int = 64
    media_token_id: int = -1   # set after the tokenizer's extension
    ff_mult: int = 4

    @property
    def n_xattn(self) -> int:
        return self.mpt.n_layers // self.cross_attn_every_n_layers

    @property
    def inner_dim(self) -> int:
        return self.resampler_heads * self.resampler_dim_head


FLAMINGO_CONFIGS: Dict[str, FlamingoConfig] = {
    # OpenFlamingo-9B: ViT-L/14 + MPT-7B, a gated cross-attention block every 4 layers
    "openflamingo-9b": FlamingoConfig("openflamingo-9b", MPT_CONFIGS["mpt-7b"], CLIP_CONFIGS["ViT-L-14"]),
    "test-tiny": FlamingoConfig(
        "test-tiny", MPT_CONFIGS["test-tiny"], CLIP_CONFIGS["test-tiny"],
        cross_attn_every_n_layers=1, resampler_depth=2, resampler_heads=2,
        resampler_dim_head=16, num_latents=4,
    ),
}


# -------------------------------------------------------------------- modules
def _attn_layout(heads: int, m: int):
    """The q columns, the fused [k|v] columns and the out rows of a
    Perceiver or cross-attention over a `model` axis of m, or None (whole)
    when m does not divide its heads."""
    if heads % m:
        return None
    return {"to_q": (1, 1), "to_kv": (1, 2), "to_out": (0, 1)}


class FeedForward(nn.Module):
    """LN, Linear (ff_mult x, no bias), exact GELU, Linear."""

    tp = None  # parallel.tensor_parallel.TensorParallel when split over `model`

    def __init__(self, dim: int, mult: int):
        super().__init__()
        self.ln_g = nn.Parameter(torch.ones(dim))
        self.ln_b = nn.Parameter(torch.zeros(dim))
        self.w1 = nn.Parameter(torch.zeros(dim, mult * dim))
        self.w2 = nn.Parameter(torch.zeros(mult * dim, dim))

    def tp_layout(self, m: int):
        return None if self.w1.shape[1] % m else {"w1": (1, 1), "w2": (0, 1)}

    def forward(self, x):
        return _ff(x, self)


class PerceiverAttention(nn.Module):
    tp = None

    def __init__(self, dim: int, inner: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_media_g = nn.Parameter(torch.ones(dim))
        self.ln_media_b = nn.Parameter(torch.zeros(dim))
        self.ln_lat_g = nn.Parameter(torch.ones(dim))
        self.ln_lat_b = nn.Parameter(torch.zeros(dim))
        self.to_q = nn.Parameter(torch.zeros(dim, inner))
        self.to_kv = nn.Parameter(torch.zeros(dim, 2 * inner))
        self.to_out = nn.Parameter(torch.zeros(inner, dim))

    def tp_layout(self, m: int):
        return _attn_layout(self.heads, m)

    def forward(self, x, latents, heads: int):
        return perceiver_attention(x, latents, self, heads)


class PerceiverLayer(nn.Module):
    def __init__(self, cfg: FlamingoConfig):
        super().__init__()
        dv = cfg.vision.vision.width
        self.attn = PerceiverAttention(dv, cfg.inner_dim, cfg.resampler_heads)
        self.ff = FeedForward(dv, cfg.ff_mult)


class PerceiverResampler(nn.Module):
    def __init__(self, cfg: FlamingoConfig):
        super().__init__()
        dv = cfg.vision.vision.width
        self.latents = nn.Parameter(torch.zeros(cfg.num_latents, dv))
        self.layers = nn.ModuleList(PerceiverLayer(cfg) for _ in range(cfg.resampler_depth))
        self.norm_g = nn.Parameter(torch.ones(dv))
        self.norm_b = nn.Parameter(torch.zeros(dv))


class MaskedCrossAttention(nn.Module):
    tp = None

    def __init__(self, cfg: FlamingoConfig):
        super().__init__()
        dl, dv, inner = cfg.mpt.d_model, cfg.vision.vision.width, cfg.inner_dim
        self.heads = cfg.resampler_heads
        self.ln_g = nn.Parameter(torch.ones(dl))
        self.ln_b = nn.Parameter(torch.zeros(dl))
        self.to_q = nn.Parameter(torch.zeros(dl, inner))
        self.to_kv = nn.Parameter(torch.zeros(dv, 2 * inner))
        self.to_out = nn.Parameter(torch.zeros(inner, dl))

    def tp_layout(self, m: int):
        return _attn_layout(self.heads, m)

    def forward(self, x, media, heads: int, media_locations, use_cached_media: bool = False):
        return masked_cross_attention(x, media, self, heads, media_locations, use_cached_media)


class GatedCrossAttentionBlock(nn.Module):
    def __init__(self, cfg: FlamingoConfig):
        super().__init__()
        self.attn = MaskedCrossAttention(cfg)
        self.ff = FeedForward(cfg.mpt.d_model, cfg.ff_mult)
        self.attn_gate = nn.Parameter(torch.zeros(()))
        self.ff_gate = nn.Parameter(torch.zeros(()))


class Flamingo(nn.Module):
    """Vision tower, resampler, the gated cross-attention blocks and the LM.
    Parameters are created frozen; load a state dict (`convert.py`) with
    `from_state`."""

    def __init__(self, cfg: FlamingoConfig):
        super().__init__()
        self.cfg = cfg
        self.vision = VisionTower(cfg.vision)
        self.perceiver = PerceiverResampler(cfg)
        self.xattn = nn.ModuleList(GatedCrossAttentionBlock(cfg) for _ in range(cfg.n_xattn))
        self.mpt = MPT(cfg.mpt)
        self.requires_grad_(False)

    @classmethod
    def from_state(cls, cfg: FlamingoConfig, state: Dict[str, torch.Tensor]) -> "Flamingo":
        """A model that holds `state`'s tensors themselves (no copy): built on
        the meta device, then assigned."""
        with torch.device("meta"):
            model = cls(cfg)
        model.load_state_dict(state, assign=True, strict=True)
        return model.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.mpt.norm_f.device

    @property
    def tensor_parallel_ok(self) -> bool:
        """`parallel/mesh.shard_params` splits this model over `model`."""
        return True


def _keeps_float32(name: str, t: torch.Tensor) -> bool:
    return t.dim() < 2 or name.startswith("perceiver.")


def half_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The bfloat16 model's state: matrices in bf16 (one copy, made once),
    the Perceiver and the 1-D and 0-D parameters shared with `state` in
    float32."""
    return {k: v if _keeps_float32(k, v) else v.to(torch.bfloat16) for k, v in state.items()}


# ------------------------------------------------------------------ functions
def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LayerNorm with float32 statistics, cast back to x's dtype."""
    return block_ops.layer_norm(x, g, b, 1e-5)


def _col(h: torch.Tensor, w: torch.Tensor, tp) -> torch.Tensor:
    """h @ w in h's dtype: on this rank's columns of w in a split module."""
    return column_parallel(h, local(w).to(h.dtype), tp) if tp else h @ w.to(h.dtype)


def _row(h: torch.Tensor, w: torch.Tensor, tp) -> torch.Tensor:
    """h @ w in h's dtype: summed over `model` in a split module."""
    return row_parallel(h, local(w).to(h.dtype), tp) if tp else h @ w.to(h.dtype)


def _ff(x: torch.Tensor, p: FeedForward) -> torch.Tensor:
    h = _ln(x, p.ln_g, p.ln_b)
    return _row(F.gelu(_col(h, p.w1, p.tp)), p.w2, p.tp)


def perceiver_attention(x: torch.Tensor, latents: torch.Tensor, p: PerceiverAttention,
                        heads: int) -> torch.Tensor:
    """x (B, T, n1, D) media, latents (B, T, n2, D) -> (B, T, n2, D)."""
    tp = p.tp
    heads = heads // tp.size if tp else heads
    x = _ln(x, p.ln_media_g, p.ln_media_b)
    latents = _ln(latents, p.ln_lat_g, p.ln_lat_b)
    q = _col(latents, p.to_q, tp)
    k, v = _col(torch.cat([x, latents], dim=-2), p.to_kv, tp).chunk(2, dim=-1)
    b, t, n2, inner = q.shape
    hd = inner // heads

    def hs(a):  # (B, T, n, H*hd) -> (B, T, H, n, hd)
        return a.reshape(*a.shape[:3], heads, hd).transpose(2, 3)

    q, k, v = hs(q), hs(k), hs(v)
    s = torch.einsum("bthid,bthjd->bthij", q, k).float() * hd ** -0.5
    a = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bthij,bthjd->bthid", a, v).transpose(2, 3).reshape(b, t, n2, inner)
    return _row(out, p.to_out, tp)


def perceiver_resampler(p: PerceiverResampler, x: torch.Tensor, cfg: FlamingoConfig) -> torch.Tensor:
    """Media features (B, T, F, v, D) -> latents (B, T, num_latents, D)."""
    b, t, f, v, d = x.shape
    x = x.reshape(b, t, f * v, d)
    lat = p.latents.to(x.dtype).expand(b, t, cfg.num_latents, d)
    for layer in p.layers:
        lat = layer.attn(x, lat, cfg.resampler_heads) + lat
        lat = layer.ff(lat) + lat
    return _ln(lat, p.norm_g, p.norm_b)


def masked_cross_attention(x: torch.Tensor, media: torch.Tensor, p: MaskedCrossAttention, heads: int,
                           media_locations: Optional[torch.Tensor],
                           use_cached_media: bool = False) -> torch.Tensor:
    """x (B, T_txt, D), media (B, T_img, n, Dv). With `media_locations`
    (B, T_txt) bool, text token i attends to the latents of media slot
    count(media up to i) only, and to none before the first media;
    `use_cached_media` (one-token decode) gives every token the count of
    the whole prompt."""
    b, t_txt, _ = x.shape
    t_img, n_lat = media.shape[1], media.shape[2]
    tp = p.tp
    heads = heads // tp.size if tp else heads
    h = _ln(x, p.ln_g, p.ln_b)
    q = _col(h, p.to_q, tp)
    m = media.reshape(b, t_img * n_lat, media.shape[-1])
    k, v = _col(m.to(x.dtype), p.to_kv, tp).chunk(2, dim=-1)
    inner = q.shape[-1]
    hd = inner // heads

    def hs(a):  # (B, n, H*hd) -> (B, H, n, hd)
        return a.reshape(b, -1, heads, hd).transpose(1, 2)

    q, k, v = hs(q), hs(k), hs(v)
    s = torch.einsum("bhid,bhjd->bhij", q, k).float() * hd ** -0.5
    if media_locations is not None:
        counts = media_locations.to(torch.int32)
        if use_cached_media:
            text_time = counts.sum(dim=1, keepdim=True).expand(b, t_txt)
        else:
            text_time = counts.cumsum(dim=1)
        media_time = torch.arange(1, t_img + 1, device=x.device).repeat_interleave(n_lat)
        mask = text_time[:, :, None] == media_time[None, None, :]   # immediate media only
        a = torch.softmax(torch.where(mask[:, None], s, -1e30), dim=-1)
        a = torch.where((text_time == 0)[:, None, :, None], 0.0, a).to(q.dtype)
    else:
        a = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhij,bhjd->bhid", a, v).transpose(1, 2).reshape(b, t_txt, inner)
    return _row(out, p.to_out, tp)


def gated_xattn_block(x: torch.Tensor, media: torch.Tensor, p: GatedCrossAttentionBlock, heads: int,
                      media_locations: Optional[torch.Tensor],
                      use_cached_media: bool = False) -> torch.Tensor:
    """The gates scale each sublayer's output after its sum over `model`."""
    att = p.attn(x, media, heads, media_locations, use_cached_media)
    x = x + torch.tanh(p.attn_gate.float()).to(x.dtype) * att
    return x + torch.tanh(p.ff_gate.float()).to(x.dtype) * p.ff(x)


def encode_vision(model: Flamingo, vision_x: torch.Tensor, *, compute_dtype=torch.bfloat16,
                  remat: bool = False) -> torch.Tensor:
    """[0,1] pixels (B, T_img, F, C, H, W) -> resampled latents
    (B, T_img, num_latents, D_vis). Resize and CLIP normalization inside
    (the threat-model contract); every patch token but CLS."""
    cfg = model.cfg
    b, t, f = vision_x.shape[:3]
    x = vision_x.reshape(b * t * f, *vision_x.shape[3:])
    size = cfg.vision.image_size
    if x.shape[-2] != size or x.shape[-1] != size:
        x = resize_bicubic(x, size)
    tokens = model.vision(normalize_clip(x), compute_dtype=compute_dtype, tokens=True, remat=remat)
    tokens = tokens[:, 1:]
    tokens = tokens.reshape(b, t, f, *tokens.shape[1:])
    return perceiver_resampler(model.perceiver, tokens, cfg)


def _check_media_token(cfg: FlamingoConfig) -> None:
    if cfg.media_token_id < 0:
        # the default -1 matches no token: every cross-attention would be
        # zeroed and the model would caption from the LM prior alone
        raise ValueError("cfg.media_token_id is unset (<0); dataclasses.replace the config with "
                         "the tokenizer's <image> id before the forward")


def _xattn_hook(model: Flamingo, media: torch.Tensor, media_locations, use_cached: bool = False):
    cfg = model.cfg
    every = cfg.cross_attn_every_n_layers

    def hook(i, h):
        if i % every:
            return h
        return gated_xattn_block(h, media, model.xattn[i // every], cfg.resampler_heads,
                                 media_locations, use_cached_media=use_cached)

    return hook


def flamingo_forward(model: Flamingo, vision_x: Optional[torch.Tensor], lang_x: torch.Tensor, *,
                     media_locations: Optional[torch.Tensor] = None, compute_dtype=torch.bfloat16,
                     remat: bool = False, media_latents: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole VLM forward -> float32 logits (B, T_txt, V).
    `media_locations` defaults to (lang_x == media_token_id)."""
    if media_latents is None:
        media_latents = encode_vision(model, vision_x, compute_dtype=compute_dtype, remat=remat)
    if media_locations is None:
        _check_media_token(model.cfg)
        media_locations = lang_x == model.cfg.media_token_id
    return mpt_forward(model.mpt, lang_x, compute_dtype=compute_dtype, remat=remat,
                       layer_hook=_xattn_hook(model, media_latents, media_locations))


def flamingo_per_sample_loss(model: Flamingo, vision_x: torch.Tensor, lang_x: torch.Tensor,
                             labels: torch.Tensor, label_mask: torch.Tensor, *,
                             compute_dtype=torch.bfloat16, remat: bool = False) -> torch.Tensor:
    """Per-sample SUMMED CE over the unmasked next-token targets (B,): the
    attack's target (shifted labels, summed over tokens)."""
    logits = flamingo_forward(model, vision_x, lang_x, compute_dtype=compute_dtype, remat=remat)
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    tok_lp = torch.gather(lp, -1, labels[:, 1:, None].long())[..., 0]
    return -(tok_lp * label_mask[:, 1:]).sum(dim=-1)


def make_flamingo_decode_fns(model: Flamingo, vision_x: torch.Tensor, *, max_total_len: int,
                             compute_dtype=torch.bfloat16):
    """(prefill_fn, decode_fn) for `models/generation.py`. The media latents
    are computed once; the carry is (cache, media_locations), whose batch
    axes differ (1 and 0), so `prefill_fn.reorder_carry` tells beam search
    how to reorder it. Beam-expanded batches repeat the media."""
    cfg = model.cfg
    _check_media_token(cfg)
    media = encode_vision(model, vision_x, compute_dtype=compute_dtype)

    def media_for(b):
        n_rep = b // media.shape[0]
        return media.repeat_interleave(n_rep, dim=0) if n_rep > 1 else media

    def prefill_fn(tokens, kv_valid, positions):
        b = tokens.shape[0]
        media_locations = (tokens == cfg.media_token_id) & kv_valid
        cache = init_mpt_cache(cfg.mpt, b, max_len=max_total_len, dtype=compute_dtype,
                               device=tokens.device, n_heads=local_heads(model.mpt))
        logits, cache = mpt_forward(
            model.mpt, tokens, compute_dtype=compute_dtype, cache=cache, cache_pos=0,
            kv_mask=kv_valid, positions=positions,
            layer_hook=_xattn_hook(model, media_for(b), media_locations))
        return logits[:, -1], (cache, media_locations)

    def decode_fn(tok, carry, pos, kv_mask, qpos):
        cache, media_locations = carry
        logits, cache = mpt_forward(
            model.mpt, tok, compute_dtype=compute_dtype, cache=cache, cache_pos=pos,
            kv_mask=kv_mask, positions=qpos,
            layer_hook=_xattn_hook(model, media_for(tok.shape[0]), media_locations,
                                   use_cached=True))
        return logits, (cache, media_locations)

    def reorder_carry(carry, gather):
        # cache buffers (L, B, H, N, hd): batch on axis 1; media_locations
        # (B, T): batch on axis 0
        cache, media_locations = carry
        return {k: buf[:, gather] for k, buf in cache.items()}, media_locations[gather]

    prefill_fn.reorder_carry = reorder_carry
    return prefill_fn, decode_fn
