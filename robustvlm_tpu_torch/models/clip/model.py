"""CLIP (vision + text towers) as PyTorch modules.

Counterpart of `robustvlm_tpu/models/clip/model.py`: the openai-architecture
ViT vision towers (or, with `vision_arch="convnext"`, the ConvNeXt tower of
`convnext.py`) and the causal text tower with argmax-EOT pooling, with
the JAX package's parameter names and layouts (linear weights stored
(in, out) for `x @ w`), so a JAX tree carries across by name
(`convert.params_from_jax`).

- LayerNorm keeps float32 statistics whatever the activation dtype. It and
  the MLP's bias + activation are `ops/kernels/block_ops.py`'s: one CUDA
  kernel each way on the card, the plain arithmetic on the CPU.
- The patch embedding is a reshape plus one matmul, not a convolution (a
  convolution would go through cuDNN). A tower whose CLIP normalization
  was folded into it (`fold_normalization`) holds a `patch_bias`, added
  after that matmul, and takes raw [0,1] pixels.
- Non-causal vision attention goes through the port's `vit_attention`,
  causal text attention through its `flash_attention` (CUDA kernels on the
  card for both), as the JAX `flash=True` branch routes them; both in
  their packed forms, which read the heads out of the fused q|k|v
  projection and return them merged, with no copy either way in bf16.
- The weights are created frozen (`requires_grad_(False)`): the attacks
  differentiate with respect to pixels only, so autograd computes no
  weight gradients. The trainer (`train/trainer.py`) unfreezes the model
  it fine-tunes.
- `remat=True` recomputes each vision block's activations in the backward
  (`torch.utils.checkpoint`), the counterpart of the JAX `remat` flag.
- A block split over the mesh's `model` axis (`parallel/mesh.shard_params`
  sets its `tp`; ConvNeXt's blocks split as `convnext.py` says) holds this rank's heads of q, k and v (the fused columns
  [q_r|k_r|v_r]) and ffn columns, runs the attention kernels on its
  (B, heads/m, N, hd) and adds the out and proj biases once, after the
  row-parallel sum (`parallel/tensor_parallel.py`). A whole block (`tp`
  None) computes as before, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from robustvlm_tpu_torch.models.clip.convnext import ConvNeXtConfig, ConvNeXtTower
from robustvlm_tpu_torch.ops.kernels.block_ops import bias_act, layer_norm
from robustvlm_tpu_torch.ops.kernels.flash_attention import flash_attention_qkv
from robustvlm_tpu_torch.ops.kernels.vit_attention import vit_attention_qkv
from robustvlm_tpu_torch.parallel.tensor_parallel import column_parallel, local, row_parallel


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    width: int
    layers: int
    heads: int
    # hidden = int(width * mlp_ratio): 4.0 everywhere but ViT-g-14's vision
    # tower (4.3637 -> 6144)
    mlp_ratio: float = 4.0


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    embed_dim: int
    image_size: int
    patch_size: int
    vision: TransformerConfig
    text: TransformerConfig
    vocab_size: int = 49408
    context_length: int = 77
    quick_gelu: bool = True  # openai pretrained models use QuickGELU
    # vision tower: "vit", or "convnext" (open_clip convnext_base_w family)
    vision_arch: str = "vit"
    convnext: Optional[Any] = None  # a ConvNeXtConfig when vision_arch == "convnext"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def n_vision_tokens(self) -> int:
        return self.grid * self.grid + 1


# the JAX package's CLIP_CONFIGS, field for field
CLIP_CONFIGS: Dict[str, CLIPConfig] = {
    "ViT-B-32": CLIPConfig(
        "ViT-B-32", 512, 224, 32,
        TransformerConfig(768, 12, 12), TransformerConfig(512, 12, 8),
    ),
    "ViT-B-16": CLIPConfig(
        "ViT-B-16", 512, 224, 16,
        TransformerConfig(768, 12, 12), TransformerConfig(512, 12, 8),
    ),
    "ViT-L-14": CLIPConfig(
        "ViT-L-14", 768, 224, 14,
        TransformerConfig(1024, 24, 16), TransformerConfig(768, 12, 12),
    ),
    "ViT-L-14-336": CLIPConfig(
        "ViT-L-14-336", 768, 336, 14,
        TransformerConfig(1024, 24, 16), TransformerConfig(768, 12, 12),
    ),
    "ViT-B-32-laion": CLIPConfig(
        "ViT-B-32-laion", 512, 224, 32,
        TransformerConfig(768, 12, 12), TransformerConfig(512, 12, 8),
        quick_gelu=False,
    ),
    "ViT-B-16-laion": CLIPConfig(
        "ViT-B-16-laion", 512, 224, 16,
        TransformerConfig(768, 12, 12), TransformerConfig(512, 12, 8),
        quick_gelu=False,
    ),
    "ViT-B-16-plus-240": CLIPConfig(
        "ViT-B-16-plus-240", 640, 240, 16,
        TransformerConfig(896, 12, 14), TransformerConfig(640, 12, 10),
        quick_gelu=False,
    ),
    "ViT-H-14": CLIPConfig(
        "ViT-H-14", 1024, 224, 14,
        TransformerConfig(1280, 32, 16), TransformerConfig(1024, 24, 16),
        quick_gelu=False,
    ),
    # head dim 1408 / 16 = 88
    "ViT-g-14": CLIPConfig(
        "ViT-g-14", 1024, 224, 14,
        TransformerConfig(1408, 40, 16, mlp_ratio=4.3637),
        TransformerConfig(1024, 24, 16),
        quick_gelu=False,
    ),
    "test-tiny": CLIPConfig(
        "test-tiny", 64, 32, 8,
        TransformerConfig(64, 2, 4), TransformerConfig(64, 2, 4),
        vocab_size=512, context_length=16,
    ),
    # open_clip convnext_base_w (the zoo's ConvNeXt-B LAION-2B backbone):
    # 256 px, embed 640, GELU text tower; the vision TransformerConfig is
    # unused by the ConvNeXt tower
    "convnext_base_w": CLIPConfig(
        "convnext_base_w", 640, 256, 4,
        TransformerConfig(1024, 0, 16), TransformerConfig(640, 12, 10),
        quick_gelu=False, vision_arch="convnext", convnext=ConvNeXtConfig(),
    ),
    "test-tiny-convnext": CLIPConfig(
        "test-tiny-convnext", 64, 32, 4,
        TransformerConfig(64, 0, 4), TransformerConfig(64, 2, 4),
        vocab_size=512, context_length=16, quick_gelu=False, vision_arch="convnext",
        convnext=ConvNeXtConfig(depths=(1, 1, 2, 1), dims=(8, 16, 32, 64)),
    ),
}


# ----------------------------------------------------------------- primitives
class LayerNorm(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(width))
        self.b = nn.Parameter(torch.zeros(width))

    def forward(self, x):
        return layer_norm(x, self.g, self.b)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv_w = nn.Parameter(torch.zeros(width, 3 * width))
        self.qkv_b = nn.Parameter(torch.zeros(3 * width))
        self.out_w = nn.Parameter(torch.zeros(width, width))
        self.out_b = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor, causal: bool, tp=None) -> torch.Tensor:
        heads = self.heads // tp.size if tp else self.heads
        cd = x.dtype
        qkv = (column_parallel(x, local(self.qkv_w).to(cd), tp) if tp else x @ self.qkv_w.to(cd)) + \
            local(self.qkv_b).to(cd)
        # the CLIP text mask only ever encodes causality (JAX model.py:190-207)
        out = flash_attention_qkv(qkv, heads, causal=True) if causal else vit_attention_qkv(qkv, heads)
        out = row_parallel(out, local(self.out_w).to(cd), tp) if tp else out @ self.out_w.to(cd)
        return out + self.out_b.to(cd)


class MLP(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc_w = nn.Parameter(torch.zeros(width, hidden))
        self.fc_b = nn.Parameter(torch.zeros(hidden))
        self.proj_w = nn.Parameter(torch.zeros(hidden, width))
        self.proj_b = nn.Parameter(torch.zeros(width))


class Block(nn.Module):
    tp = None  # parallel.tensor_parallel.TensorParallel when split over `model`

    def __init__(self, tcfg: TransformerConfig, quick: bool):
        super().__init__()
        self.ln_1 = LayerNorm(tcfg.width)
        self.attn = Attention(tcfg.width, tcfg.heads)
        self.ln_2 = LayerNorm(tcfg.width)
        self.mlp = MLP(tcfg.width, int(tcfg.width * tcfg.mlp_ratio))
        self.quick = quick  # QuickGELU, else the exact (erf) GELU

    def tp_layout(self, m: int):
        """{parameter: (split dim, blocks)} over a `model` axis of m, or None
        when m does not divide the heads or the ffn width (the block stays
        whole)."""
        if self.attn.heads % m or self.mlp.fc_w.shape[1] % m:
            return None
        return {"attn.qkv_w": (1, 3), "attn.qkv_b": (0, 3), "attn.out_w": (0, 1),
                "mlp.fc_w": (1, 1), "mlp.fc_b": (0, 1), "mlp.proj_w": (0, 1)}

    def forward(self, x, causal: bool = False):
        tp = self.tp
        x = x + self.attn(self.ln_1(x), causal, tp)
        cd = x.dtype
        m = self.mlp
        h = self.ln_2(x)
        h = column_parallel(h, local(m.fc_w).to(cd), tp) if tp else h @ m.fc_w.to(cd)
        h = bias_act(h, local(m.fc_b), self.quick)
        y = row_parallel(h, local(m.proj_w).to(cd), tp) if tp else h @ m.proj_w.to(cd)
        return x + (y + m.proj_b.to(cd))


class VisionTower(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        w, p = cfg.vision.width, cfg.patch_size
        self.patch_size = p
        self.patch_embed = nn.Parameter(torch.zeros(3 * p * p, w))
        # set by fold_normalization (or by loading a folded state dict)
        self.register_parameter("patch_bias", None)
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.n_vision_tokens, w))
        self.ln_pre = LayerNorm(w)
        self.blocks = nn.ModuleList(
            Block(cfg.vision, cfg.quick_gelu) for _ in range(cfg.vision.layers)
        )
        self.ln_post = LayerNorm(w)
        self.proj = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def forward(self, x, *, compute_dtype=torch.float32, tokens=False, n_skip_last=0, remat=False):
        b = x.shape[0]
        p = self.patch_size
        g = x.shape[-1] // p
        cd = compute_dtype
        x = x.to(cd)
        # patch embed as matmul: (B,3,H,W) -> (B, g*g, 3*p*p) @ (3*p*p, W)
        x = x.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, 3 * p * p)
        x = x @ self.patch_embed.to(cd)
        if self.patch_bias is not None:
            x = x + self.patch_bias.to(cd)
        cls = self.class_embedding.to(cd).expand(b, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(cd)
        x = self.ln_pre(x)
        for blk in self.blocks[: len(self.blocks) - n_skip_last]:
            if remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
        if tokens:
            return x.float()
        x = self.ln_post(x[:, 0])
        return (x @ self.proj.to(cd)).float()

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a folded tower's state (JAX's `fold_normalization` tree through
        # `convert.params_from_jax`) loads into an unfolded module
        bias = state_dict.get(prefix + "patch_bias")
        if bias is not None and self.patch_bias is None:
            self.patch_bias = nn.Parameter(torch.zeros(bias.shape, dtype=self.patch_embed.dtype,
                                                       device=self.patch_embed.device),
                                           requires_grad=self.patch_embed.requires_grad)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


@torch.no_grad()
def fold_normalization(visual: VisionTower, mean=None, std=None) -> VisionTower:
    """Absorb CLIP's per-channel normalization into the patch embedding, in
    place: normalize is affine per channel, y_c = (x_c - m_c) / s_c, and the
    patch embedding is a bias-free matmul over rows ordered (channel, py,
    px), so rows W_r / s_c(r) and a bias -(m / s) @ W make `visual(raw_x)`
    compute `visual(normalize_clip(raw_x))` before the fold, exactly in
    real arithmetic (one elementwise pass over the pixels fewer an
    evaluation). ViT towers only. Counterpart of JAX's
    `fold_normalization`; the folded tower then takes [0,1] pixels."""
    from robustvlm_tpu_torch.ops.image import OPENAI_MEAN, OPENAI_STD

    if not isinstance(visual, VisionTower):
        raise ValueError("fold_normalization: a ViT vision tower is required")
    if visual.patch_bias is not None:
        raise ValueError("fold_normalization: the tower is already folded")
    w = visual.patch_embed
    pp = visual.patch_size * visual.patch_size
    m = torch.tensor(OPENAI_MEAN if mean is None else mean, dtype=w.dtype, device=w.device)
    s = torch.tensor(OPENAI_STD if std is None else std, dtype=w.dtype, device=w.device)
    m, s = m.repeat_interleave(pp), s.repeat_interleave(pp)
    bias = -(m / s) @ w
    w.copy_(w / s[:, None])
    visual.patch_bias = nn.Parameter(bias, requires_grad=w.requires_grad)
    return visual


class TextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        w = cfg.text.width
        self.token_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, w))
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, w))
        self.blocks = nn.ModuleList(Block(cfg.text, cfg.quick_gelu) for _ in range(cfg.text.layers))
        self.ln_final = LayerNorm(w)
        self.text_projection = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def forward(self, tokens, *, compute_dtype=torch.float32):
        cd = compute_dtype
        x = self.token_embedding[tokens].to(cd)
        t = x.shape[1]
        x = x + self.positional_embedding[:t].to(cd)
        for blk in self.blocks:
            x = blk(x, causal=True)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return (x @ self.text_projection.to(cd)).float()


@torch.no_grad()
def cast_matrices_(module: nn.Module, dtype) -> nn.Module:
    """Hold `module`'s parameters of two or more dimensions (the matrices,
    the patch embedding, the positional embeddings) in `dtype`, in place;
    1-D parameters (LayerNorm gains and biases, the biases, the class
    embedding) stay float32. The forward casts every weight at use, so the
    module gives, bit for bit, what the float32 module gives at
    `compute_dtype=dtype`: the matrices' casts are made once instead of at
    every call, and LayerNorm still reads float32 gains and biases."""
    for mod in module.modules():
        for name, prm in list(mod._parameters.items()):
            if prm is not None and prm.dim() >= 2 and prm.dtype != dtype:
                mod._parameters[name] = nn.Parameter(prm.to(dtype), requires_grad=prm.requires_grad)
    return module


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-12)


class CLIP(nn.Module):
    """Both towers and logit_scale. Parameters are created frozen and zero;
    load a state dict (convert.py) or call `init_random_`."""

    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.vision_arch == "convnext":
            self.visual = ConvNeXtTower(cfg.convnext, cfg.embed_dim)
        elif cfg.vision_arch == "vit":
            self.visual = VisionTower(cfg)
        else:
            raise ValueError(f"unknown vision_arch {cfg.vision_arch!r}")
        self.text = TextTower(cfg)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.requires_grad_(False)
        if device is not None:
            self.to(device)

    @property
    def tensor_parallel_ok(self) -> bool:
        """Whether `parallel/mesh.shard_params` splits this model over
        `model`: yes, with a ViT or a ConvNeXt vision tower."""
        return True

    def encode_image(self, x, *, normalize=False, compute_dtype=torch.float32,
                     tokens=False, n_skip_last=0, remat=False):
        """NCHW normalized pixels -> (B, embed_dim) float32 embedding;
        `tokens=True` returns every token's features after the (partial)
        transformer (ViT towers only); `remat` recomputes each block in the
        backward."""
        out = self.visual(x, compute_dtype=compute_dtype, tokens=tokens, n_skip_last=n_skip_last,
                          remat=remat)
        return _l2_normalize(out) if normalize and not tokens else out

    def encode_text(self, tokens, *, normalize=False, compute_dtype=torch.float32):
        """(B, context_length) int tokens -> (B, embed_dim) float32."""
        out = self.text(tokens, compute_dtype=compute_dtype)
        return _l2_normalize(out) if normalize else out

    @torch.no_grad()
    def init_random_(self, seed: int = 0) -> "CLIP":
        """Scaled-normal random weights from a seed (tests, benches): the
        scheme of the JAX `init_clip_params`, not its numbers."""
        dev = self.logit_scale.device
        gen = torch.Generator(device=dev).manual_seed(seed)

        def normal_(t, std):
            t.copy_(torch.randn(t.shape, generator=gen, device=dev) * std)

        if isinstance(self.visual, ConvNeXtTower):
            self.visual.init_random_(gen)
        for name, prm in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if isinstance(self.visual, ConvNeXtTower) and name.startswith("visual."):
                continue
            if leaf == "g":
                prm.fill_(1.0)
            elif leaf in ("b", "qkv_b", "out_b", "fc_b", "proj_b"):
                prm.zero_()
            elif name == "logit_scale":
                prm.fill_(math.log(1 / 0.07))
            elif name == "text.token_embedding":
                normal_(prm, 0.02)
            elif name == "text.positional_embedding":
                normal_(prm, 0.01)
            elif name.startswith("text."):
                normal_(prm, self.cfg.text.width ** -0.5)
            else:
                normal_(prm, self.cfg.vision.width ** -0.5)
        return self
