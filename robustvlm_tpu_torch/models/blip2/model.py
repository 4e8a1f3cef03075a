"""BLIP-2: EVA ViT vision tower -> Q-Former -> OPT decoder, as PyTorch modules.

Counterpart of `robustvlm_tpu/models/blip2/model.py` (HF
`Blip2ForConditionalGeneration` semantics):

- Vision (`Blip2VisionModel`): patch embedding with a bias, [CLS | patches]
  plus learned positions, pre-LN blocks whose fused qkv carries the
  (q_bias, 0, v_bias) vector, exact GELU, eps 1e-6, a post-LayerNorm over
  every token (the Q-Former reads them all).
- Q-Former (the query-only path of `Blip2QFormerModel`): learned query
  tokens, post-LN BERT sublayers with eps 1e-12: self-attention, a
  cross-attention to the image tokens on the first layer of every
  `xattn_every` group (HF `cross_attention_frequency`), the query
  feed-forward. Its output is float32.
- Glue: the language projection runs in float32; its output, cast to the
  embedding's dtype, is PREFIXED to the prompt's token embeddings and OPT
  runs causally over the concatenation.

On a CUDA tensor the vision blocks' attention goes through the port's
`vit_attention_qkv` (its kernels at head dim 88 for ViT-g/14, reading the
heads out of the fused q|k|v projection), their
LayerNorms and bias + exact GELU through `ops/kernels/block_ops.py`, and
OPT's blocks through `flash_attention` and the same block kernels
(`models/opt/model.py`). The Q-Former's attention (32 queries) stays plain
PyTorch (`_mha`: float32 softmax, P cast to the compute dtype before P V),
as does every op on a CPU tensor, as in JAX, where BLIP-2 reaches no
Pallas kernel. The forwards name their stages `blip2.vision`,
`blip2.qformer` (`blip2_image_features`) and `blip2.lm` (`blip2_forward`)
for the profiler (`utils/profiling.span`). Threat-model contract:
`blip2_per_sample_loss` takes UNNORMALIZED [0,1] pixels at any size; the
bicubic resize (JAX's `_maybe_resize`) and
CLIP normalization happen inside.

Layers are `nn.ModuleList`s walked by Python loops (JAX scans stacked
blocks, the Q-Former by groups); `remat` recomputes each vision block and
each OPT block in the backward (`torch.utils.checkpoint`). A model held in
bfloat16 (`half_state`) keeps the 1-D parameters, the query tokens and the
language projection in float32, so it computes what the JAX package
computes with float32 weights cast at each use.

Split over the mesh's `model` axis (`parallel/mesh.shard_params`): each
module whose heads (and ffn width) m divides holds this rank's share and
computes on it (`parallel/tensor_parallel.py`): the EVA blocks (the fused
[q|k|v] columns of its heads with their bias, the fc columns and bias, the
out and proj rows), the Q-Former's attention sublayers (q, k and v columns,
their replicated biases sliced at use; the out rows) and feed-forwards, the
OPT blocks and LM head (`models/opt/model.py`), and the language projection
(its columns, gathered before the splice; the bias added after). Each
row-parallel bias is added once, after the sum over `model`. The decode
cache holds the rank's heads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from robustvlm_tpu_torch.models.opt.model import (
    OPT,
    OPT_CONFIGS,
    OPTConfig,
    _col,
    _col_act,
    _lin,
    _row,
    init_opt_cache,
    layer_norm,
    local_heads,
    opt_forward,
)
from robustvlm_tpu_torch.ops.image import normalize_clip, resize_bicubic
from robustvlm_tpu_torch.ops.kernels.vit_attention import vit_attention_qkv
from robustvlm_tpu_torch.parallel.tensor_parallel import column_parallel, gather_from_model, local
from robustvlm_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class Blip2VisionConfig:
    width: int
    layers: int
    heads: int
    image_size: int
    patch_size: int
    intermediate: int
    norm_eps: float = 1e-6

    @property
    def n_tokens(self) -> int:
        g = self.image_size // self.patch_size
        return g * g + 1


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    width: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    xattn_every: int = 2  # HF cross_attention_frequency
    norm_eps: float = 1e-12


@dataclasses.dataclass(frozen=True)
class Blip2Config:
    name: str
    vision: Blip2VisionConfig
    qformer: QFormerConfig
    opt: OPTConfig
    num_query_tokens: int = 32


BLIP2_CONFIGS: Dict[str, Blip2Config] = {
    # Salesforce/blip2-opt-2.7b: EVA ViT-g/14 (the 39 layers HF keeps), OPT-2.7b
    "blip2-opt-2.7b": Blip2Config("blip2-opt-2.7b", Blip2VisionConfig(1408, 39, 16, 224, 14, 6144),
                                  QFormerConfig(), OPT_CONFIGS["opt-2.7b"]),
    "blip2-opt-6.7b": Blip2Config("blip2-opt-6.7b", Blip2VisionConfig(1408, 39, 16, 224, 14, 6144),
                                  QFormerConfig(), OPT_CONFIGS["opt-6.7b"]),
    "test-tiny": Blip2Config("test-tiny", Blip2VisionConfig(32, 2, 2, 32, 8, 64),
                             QFormerConfig(width=32, layers=2, heads=2, intermediate=64),
                             OPT_CONFIGS["test-tiny"], num_query_tokens=4),
}


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Non-causal attention over projected (B, Tq|Tk, W) inputs: float32
    softmax, P cast to the compute dtype before P V."""
    b, tq, w = q.shape
    tk = k.shape[1]
    hd = w // heads
    q = q.reshape(b, tq, heads, hd).transpose(1, 2)
    k = k.reshape(b, tk, heads, hd).transpose(1, 2)
    v = v.reshape(b, tk, heads, hd).transpose(1, 2)
    s = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v).transpose(1, 2).reshape(b, tq, w)


def _self_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """`_mha` of a vision block over its fused (B, N, 3W) q|k|v projection:
    the `vit_attention` kernels for CUDA tensors, which read the heads out of
    it, the plain version for CPU ones."""
    if not qkv.is_cuda:
        return _mha(*qkv.chunk(3, dim=-1), heads)
    return vit_attention_qkv(qkv, heads)


class LayerNorm(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(width))
        self.b = nn.Parameter(torch.zeros(width))


# ----------------------------------------------------------------- vision
class VisionAttention(nn.Module):
    def __init__(self, w: int):
        super().__init__()
        self.qkv_w = nn.Parameter(torch.zeros(w, 3 * w))
        self.qkv_b = nn.Parameter(torch.zeros(3 * w))
        self.out_w = nn.Parameter(torch.zeros(w, w))
        self.out_b = nn.Parameter(torch.zeros(w))


class VisionMLP(nn.Module):
    def __init__(self, w: int, f: int):
        super().__init__()
        self.fc_w = nn.Parameter(torch.zeros(w, f))
        self.fc_b = nn.Parameter(torch.zeros(f))
        self.proj_w = nn.Parameter(torch.zeros(f, w))
        self.proj_b = nn.Parameter(torch.zeros(w))


class VisionBlock(nn.Module):
    tp = None  # parallel.tensor_parallel.TensorParallel when split over `model`

    def __init__(self, vc: Blip2VisionConfig):
        super().__init__()
        self.vc = vc
        self.ln_1 = LayerNorm(vc.width)
        self.attn = VisionAttention(vc.width)
        self.ln_2 = LayerNorm(vc.width)
        self.mlp = VisionMLP(vc.width, vc.intermediate)

    def tp_layout(self, m: int):
        """CLIP's split (`models/clip/model.Block.tp_layout`), or None when
        m does not divide the heads or the ffn width."""
        if self.vc.heads % m or self.vc.intermediate % m:
            return None
        return {"attn.qkv_w": (1, 3), "attn.qkv_b": (0, 3), "attn.out_w": (0, 1),
                "mlp.fc_w": (1, 1), "mlp.fc_b": (0, 1), "mlp.proj_w": (0, 1)}

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        vc, a, m, tp = self.vc, self.attn, self.mlp, self.tp
        heads = vc.heads // tp.size if tp else vc.heads
        x = layer_norm(h, self.ln_1.g, self.ln_1.b, vc.norm_eps)
        qkv = _col(x, a.qkv_w, a.qkv_b, tp, b_split=True)
        h = h + _row(_self_attention(qkv, heads), a.out_w, a.out_b, tp)
        x = layer_norm(h, self.ln_2.g, self.ln_2.b, vc.norm_eps)
        return h + _row(_col_act(x, m.fc_w, m.fc_b, tp, "gelu"), m.proj_w, m.proj_b, tp)


class VisionTower(nn.Module):
    def __init__(self, vc: Blip2VisionConfig):
        super().__init__()
        p, w = vc.patch_size, vc.width
        self.patch_embed = nn.Parameter(torch.zeros(3 * p * p, w))
        self.patch_bias = nn.Parameter(torch.zeros(w))
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(torch.zeros(vc.n_tokens, w))
        self.blocks = nn.ModuleList(VisionBlock(vc) for _ in range(vc.layers))
        self.ln_post = LayerNorm(w)


# ----------------------------------------------------------------- qformer
class QFormerAttention(nn.Module):
    """One post-LN attention sublayer: query/key/value, the output dense and
    its LayerNorm (HF `attention.output.LayerNorm`)."""

    tp = None

    def __init__(self, w: int, kv_in: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_w = nn.Parameter(torch.zeros(w, w))
        self.q_b = nn.Parameter(torch.zeros(w))
        self.k_w = nn.Parameter(torch.zeros(kv_in, w))
        self.k_b = nn.Parameter(torch.zeros(w))
        self.v_w = nn.Parameter(torch.zeros(kv_in, w))
        self.v_b = nn.Parameter(torch.zeros(w))
        self.out_w = nn.Parameter(torch.zeros(w, w))
        self.out_b = nn.Parameter(torch.zeros(w))
        self.ln_g = nn.Parameter(torch.ones(w))
        self.ln_b = nn.Parameter(torch.zeros(w))

    def tp_layout(self, m: int):
        """The q, k and v columns of this rank's heads and the out rows, or
        None (whole) when m does not divide the heads. The biases are
        replicated, as the JAX package gives them no rule."""
        if self.heads % m:
            return None
        return {"q_w": (1, 1), "k_w": (1, 1), "v_w": (1, 1), "out_w": (0, 1)}

    def forward(self, h: torch.Tensor, kv: torch.Tensor, heads: int, eps: float) -> torch.Tensor:
        tp = self.tp
        att = _mha(_col(h, self.q_w, self.q_b, tp), _col(kv, self.k_w, self.k_b, tp),
                   _col(kv, self.v_w, self.v_b, tp), heads // tp.size if tp else heads)
        return layer_norm(_row(att, self.out_w, self.out_b, tp) + h, self.ln_g, self.ln_b, eps)


class QFormerFFN(nn.Module):
    tp = None

    def __init__(self, w: int, f: int):
        super().__init__()
        self.fc_w = nn.Parameter(torch.zeros(w, f))
        self.fc_b = nn.Parameter(torch.zeros(f))
        self.proj_w = nn.Parameter(torch.zeros(f, w))
        self.proj_b = nn.Parameter(torch.zeros(w))
        self.ln_g = nn.Parameter(torch.ones(w))
        self.ln_b = nn.Parameter(torch.zeros(w))

    def tp_layout(self, m: int):
        return None if self.fc_w.shape[1] % m else {"fc_w": (1, 1), "proj_w": (0, 1)}

    def forward(self, h: torch.Tensor, eps: float) -> torch.Tensor:
        tp = self.tp
        m = F.gelu(_col(h, self.fc_w, self.fc_b, tp))
        return layer_norm(_row(m, self.proj_w, self.proj_b, tp) + h, self.ln_g, self.ln_b, eps)


class QFormerLayer(nn.Module):
    """Self-attention, the cross-attention when the layer leads its group of
    `xattn_every`, the feed-forward."""

    def __init__(self, cfg: Blip2Config, cross: bool):
        super().__init__()
        qc = cfg.qformer
        self.self_attn = QFormerAttention(qc.width, qc.width, qc.heads)
        self.cross = QFormerAttention(qc.width, cfg.vision.width, qc.heads) if cross else None
        self.ffn = QFormerFFN(qc.width, qc.intermediate)


class QFormer(nn.Module):
    def __init__(self, cfg: Blip2Config):
        super().__init__()
        qc = cfg.qformer
        if qc.layers % qc.xattn_every:
            raise ValueError(f"{cfg.name}: Q-Former layers ({qc.layers}) must be a multiple of "
                             f"xattn_every ({qc.xattn_every})")
        self.ln_embed = LayerNorm(qc.width)
        self.layers = nn.ModuleList(QFormerLayer(cfg, i % qc.xattn_every == 0) for i in range(qc.layers))


class LanguageProjection(nn.Module):
    """Float32 (B, Q, Wq) query outputs -> (B, Q, W_opt) float32."""

    tp = None

    def __init__(self, wq: int, d: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(wq, d))
        self.b = nn.Parameter(torch.zeros(d))

    def tp_layout(self, m: int):
        """w's columns over a `model` axis of m; the bias stays whole."""
        return None if self.w.shape[1] % m else {"w": (1, 1)}

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        tp = self.tp
        if tp is None:
            return q @ self.w.float() + self.b.float()
        return gather_from_model(column_parallel(q, local(self.w).float(), tp), tp) + self.b.float()


class Blip2(nn.Module):
    """Vision tower, query tokens, Q-Former, language projection and OPT.
    Parameters are created frozen; load a state dict (`convert.py`,
    `import_torch.py`) with `from_state`."""

    def __init__(self, cfg: Blip2Config):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTower(cfg.vision)
        self.query_tokens = nn.Parameter(torch.zeros(cfg.num_query_tokens, cfg.qformer.width))
        self.qformer = QFormer(cfg)
        self.language_projection = LanguageProjection(cfg.qformer.width, cfg.opt.dim)
        self.opt = OPT(cfg.opt)
        self.requires_grad_(False)

    @classmethod
    def from_state(cls, cfg: Blip2Config, state: Dict[str, torch.Tensor]) -> "Blip2":
        """A model that holds `state`'s tensors themselves (no copy)."""
        with torch.device("meta"):
            model = cls(cfg)
        model.load_state_dict(state, assign=True, strict=True)
        return model.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.opt.tok_embedding.device

    @property
    def tensor_parallel_ok(self) -> bool:
        """`parallel/mesh.shard_params` splits this model over `model`."""
        return True


def _keeps_float32(name: str, t: torch.Tensor) -> bool:
    return t.dim() < 2 or name == "query_tokens" or name.startswith("language_projection.")


def half_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The bfloat16 model's state: matrices in bf16 (one copy, made once);
    the 1-D parameters, the query tokens and the language projection shared
    with `state` in float32."""
    return {k: v if _keeps_float32(k, v) else v.to(torch.bfloat16) for k, v in state.items()}


# ----------------------------------------------------------------- forwards
def blip2_vision_forward(model: Blip2, x: torch.Tensor, *, compute_dtype=torch.float32,
                         remat: bool = False) -> torch.Tensor:
    """NCHW normalized pixels -> (B, N+1, W) float32 post-LayerNorm token
    features (HF `Blip2VisionModel.last_hidden_state`)."""
    vc, vp = model.cfg.vision, model.visual
    b, p = x.shape[0], vc.patch_size
    g = x.shape[-1] // p
    cd = compute_dtype
    x = x.to(cd).reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, 3 * p * p)
    x = _lin(x, vp.patch_embed, vp.patch_bias)
    cls = vp.class_embedding.to(cd).expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + vp.positional_embedding[: x.shape[1]].to(cd)
    for blk in vp.blocks:
        if remat and torch.is_grad_enabled():
            x = checkpoint(blk, x, use_reentrant=False)
        else:
            x = blk(x)
    return layer_norm(x, vp.ln_post.g, vp.ln_post.b, vc.norm_eps).float()


def qformer_forward(model: Blip2, image_embeds: torch.Tensor, *,
                    compute_dtype=torch.float32) -> torch.Tensor:
    """Learned query tokens cross-attend to the image tokens -> (B, Q, Wq)
    float32 (the query-only path of HF `Blip2QFormerModel`)."""
    cfg = model.cfg
    qc, qp = cfg.qformer, model.qformer
    img = image_embeds.to(compute_dtype)
    b = img.shape[0]
    h = model.query_tokens.to(compute_dtype).expand(b, cfg.num_query_tokens, qc.width)
    h = layer_norm(h, qp.ln_embed.g, qp.ln_embed.b, qc.norm_eps)
    for layer in qp.layers:
        h = layer.self_attn(h, h, qc.heads, qc.norm_eps)
        if layer.cross is not None:
            h = layer.cross(h, img, qc.heads, qc.norm_eps)
        h = layer.ffn(h, qc.norm_eps)
    return h.float()


def blip2_image_features(model: Blip2, pixels_norm: torch.Tensor, *, compute_dtype=torch.float32,
                         remat: bool = False) -> torch.Tensor:
    """Normalized pixels -> (B, Q, W_opt) float32 language-model input
    embeddings (HF `get_image_features`); the projection in float32."""
    with span("blip2.vision"):
        img = blip2_vision_forward(model, pixels_norm, compute_dtype=compute_dtype, remat=remat)
    with span("blip2.qformer"):
        return model.language_projection(qformer_forward(model, img, compute_dtype=compute_dtype))


def _splice(model: Blip2, lm_in: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """[image queries | token embeddings] in the embedding table's dtype."""
    tok_emb = model.opt.tok_embedding[tokens]
    return torch.cat([lm_in.to(tok_emb.dtype), tok_emb], dim=1)


def blip2_forward(model: Blip2, pixels01: torch.Tensor, tokens: torch.Tensor, *,
                  compute_dtype=torch.float32, remat: bool = False) -> torch.Tensor:
    """UNNORMALIZED [0,1] pixels + prompt tokens -> float32 logits
    (B, Q + T, V); the query embeddings come first."""
    cfg = model.cfg
    lm_in = blip2_image_features(model, normalize_clip(resize_bicubic(pixels01, cfg.vision.image_size)),
                                 compute_dtype=compute_dtype, remat=remat)
    with span("blip2.lm"):
        return opt_forward(model.opt, inputs_embeds=_splice(model, lm_in, tokens),
                           compute_dtype=compute_dtype, remat=remat)


def blip2_per_sample_loss(model: Blip2, pixels01: torch.Tensor, tokens: torch.Tensor,
                          labels: torch.Tensor, label_mask: torch.Tensor, *,
                          compute_dtype=torch.float32, remat: bool = False) -> torch.Tensor:
    """Teacher-forced per-sample CE (B,): the mean over the masked answer
    span. labels and label_mask cover the TEXT positions only; the logit at
    text position t - 1 (the last query's for t = 0) predicts token t."""
    logits = blip2_forward(model, pixels01, tokens, compute_dtype=compute_dtype, remat=remat)
    nq = model.cfg.num_query_tokens
    logp = torch.log_softmax(logits[:, nq - 1:-1], dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    m = label_mask.float()
    return -(ll * m).sum(dim=-1) / m.sum(dim=-1).clamp(min=1.0)


def make_blip2_decode_fns(model: Blip2, pixels01: torch.Tensor, *, max_total_len: int,
                          compute_dtype=torch.float32):
    """(prefill_fn, decode_fn) for models/generation.py: the prefill runs the
    vision tower and the Q-Former once and feeds [queries | prompt], at
    positions 0..nq-1 and nq + the prompt's, into a cache of nq +
    max_total_len slots; decode steps run OPT alone."""
    cfg = model.cfg
    lm_in = blip2_image_features(model, normalize_clip(resize_bicubic(pixels01, cfg.vision.image_size)),
                                 compute_dtype=compute_dtype)
    nq = cfg.num_query_tokens
    dev = lm_in.device

    def prefill_fn(tokens, kv_valid, positions):
        b = tokens.shape[0]
        n_rep = b // lm_in.shape[0]
        img = lm_in.repeat_interleave(n_rep, dim=0) if n_rep > 1 else lm_in
        kv_valid_full = torch.cat([torch.ones(b, nq, dtype=torch.bool, device=dev), kv_valid], dim=1)
        pos_full = torch.cat([torch.arange(nq, device=dev)[None].expand(b, nq), nq + positions], dim=1)
        cache = init_opt_cache(cfg.opt, b, max_len=nq + max_total_len, dtype=compute_dtype, device=dev,
                               n_heads=local_heads(model.opt))
        logits, cache = opt_forward(model.opt, inputs_embeds=_splice(model, img, tokens),
                                    positions=pos_full, compute_dtype=compute_dtype, cache=cache,
                                    cache_pos=0, kv_mask=kv_valid_full)
        return logits[:, -1], cache

    def decode_fn(tok, cache, pos, kv_mask, qpos):
        b = tok.shape[0]
        kv_mask_full = torch.cat([torch.ones(b, nq, dtype=torch.bool, device=dev), kv_mask], dim=1)
        return opt_forward(model.opt, tok, positions=nq + qpos, compute_dtype=compute_dtype,
                           cache=cache, cache_pos=nq + int(pos), kv_mask=kv_mask_full)

    return prefill_fn, decode_fn
