"""CLIP (vision + text towers) as PyTorch modules.

Counterpart of `robustvlm_tpu/models/clip/model.py`: the openai-architecture
ViT vision towers and the causal text tower with argmax-EOT pooling, with
the JAX package's parameter names and layouts (linear weights stored
(in, out) for `x @ w`), so a JAX tree carries across by name
(`convert.params_from_jax`).

- LayerNorm keeps float32 statistics whatever the activation dtype.
- The patch embedding is a reshape plus one matmul, not a convolution (a
  convolution would go through cuDNN).
- Non-causal vision attention goes through the port's `vit_attention`,
  causal text attention through its `flash_attention` (CUDA kernels on the
  card for both), as the JAX `flash=True` branch routes them.
- The weights are frozen (`requires_grad_(False)`): the attacks
  differentiate with respect to pixels only, so autograd computes no
  weight gradients.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from robustvlm_tpu_torch.ops.kernels.flash_attention import flash_attention
from robustvlm_tpu_torch.ops.kernels.vit_attention import vit_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    width: int
    layers: int
    heads: int
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

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def n_vision_tokens(self) -> int:
        return self.grid * self.grid + 1


# the ViT configurations of the JAX package's CLIP_CONFIGS (ConvNeXt towers
# are not ported)
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
    "test-tiny": CLIPConfig(
        "test-tiny", 64, 32, 8,
        TransformerConfig(64, 2, 4), TransformerConfig(64, 2, 4),
        vocab_size=512, context_length=16,
    ),
}


# ----------------------------------------------------------------- primitives
def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics regardless of activation dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


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

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        b, n, w = x.shape
        hd = w // self.heads
        cd = x.dtype
        qkv = x @ self.qkv_w.to(cd) + self.qkv_b.to(cd)

        def heads_split(t):
            return t.reshape(b, n, self.heads, hd).transpose(1, 2)

        q, k, v = (heads_split(t) for t in qkv.split(w, dim=-1))
        # the CLIP text mask only ever encodes causality (JAX model.py:190-207)
        out = flash_attention(q, k, v, causal=True) if causal else vit_attention(q, k, v)
        out = out.transpose(1, 2).reshape(b, n, w)
        return out @ self.out_w.to(cd) + self.out_b.to(cd)


class MLP(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc_w = nn.Parameter(torch.zeros(width, hidden))
        self.fc_b = nn.Parameter(torch.zeros(hidden))
        self.proj_w = nn.Parameter(torch.zeros(hidden, width))
        self.proj_b = nn.Parameter(torch.zeros(width))


class Block(nn.Module):
    def __init__(self, tcfg: TransformerConfig, quick: bool):
        super().__init__()
        self.ln_1 = LayerNorm(tcfg.width)
        self.attn = Attention(tcfg.width, tcfg.heads)
        self.ln_2 = LayerNorm(tcfg.width)
        self.mlp = MLP(tcfg.width, int(tcfg.width * tcfg.mlp_ratio))
        self.act = quick_gelu if quick else F.gelu  # F.gelu is the exact (erf) GELU

    def forward(self, x, causal: bool = False):
        x = x + self.attn(self.ln_1(x), causal)
        cd = x.dtype
        m = self.mlp
        h = self.act(self.ln_2(x) @ m.fc_w.to(cd) + m.fc_b.to(cd))
        return x + (h @ m.proj_w.to(cd) + m.proj_b.to(cd))


class VisionTower(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        w, p = cfg.vision.width, cfg.patch_size
        self.patch_size = p
        self.patch_embed = nn.Parameter(torch.zeros(3 * p * p, w))
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.n_vision_tokens, w))
        self.ln_pre = LayerNorm(w)
        self.blocks = nn.ModuleList(
            Block(cfg.vision, cfg.quick_gelu) for _ in range(cfg.vision.layers)
        )
        self.ln_post = LayerNorm(w)
        self.proj = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def forward(self, x, *, compute_dtype=torch.float32, tokens=False, n_skip_last=0):
        b = x.shape[0]
        p = self.patch_size
        g = x.shape[-1] // p
        cd = compute_dtype
        x = x.to(cd)
        # patch embed as matmul: (B,3,H,W) -> (B, g*g, 3*p*p) @ (3*p*p, W)
        x = x.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, 3 * p * p)
        x = x @ self.patch_embed.to(cd)
        cls = self.class_embedding.to(cd).expand(b, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(cd)
        x = self.ln_pre(x)
        for blk in self.blocks[: len(self.blocks) - n_skip_last]:
            x = blk(x)
        if tokens:
            return x.float()
        x = self.ln_post(x[:, 0])
        return (x @ self.proj.to(cd)).float()


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


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-12)


class CLIP(nn.Module):
    """Both towers and logit_scale. Parameters are created frozen and zero;
    load a state dict (convert.py) or call `init_random_`."""

    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTower(cfg)
        self.text = TextTower(cfg)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.requires_grad_(False)
        if device is not None:
            self.to(device)

    def encode_image(self, x, *, normalize=False, compute_dtype=torch.float32,
                     tokens=False, n_skip_last=0):
        """NCHW normalized pixels -> (B, embed_dim) float32 embedding;
        `tokens=True` returns every token's features after the (partial)
        transformer."""
        out = self.visual(x, compute_dtype=compute_dtype, tokens=tokens, n_skip_last=n_skip_last)
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

        for name, prm in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
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
