"""The CLIP ViT image tower as plain PyTorch, from the published
architecture (openai/CLIP `clip/model.py`: pre-LayerNorm blocks, QuickGELU,
a class token, a linear patch embedding), in float32 or the fp8 control.

Weights are read by name from a state dict the harness made (the names of
the port's modules, `prefix` + `blocks.<i>.attn.qkv_w`, ...; linear weights
stored (in, out)) and cast to float32 at use; nothing derived by the
program is read. A block's inputs are the residual stream; the attention
mixes all 257 tokens (no mask).
"""

from __future__ import annotations

import torch

from reference.common import layer_norm, mm, normalize_pixels, quick_gelu, softmax_attention


def tokens(w, prefix: str, cfg: dict, x01: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """[0,1] pixels (B, 3, S, S) -> every token's features after the last
    block (B, 1 + (S/p)^2, width), float32."""
    v = cfg["vision_cfg"]
    p, width = v["patch_size"], v["width"]
    heads = width // v.get("head_width", 64)  # open_clip's default head width
    x = normalize_pixels(x01)
    b, g = x.shape[0], x.shape[-1] // p
    x = x.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, 3 * p * p)
    x = mm(x, w[prefix + "patch_embed"], precision)
    cls = w[prefix + "class_embedding"].float().expand(b, 1, width)
    x = torch.cat([cls, x], dim=1) + w[prefix + "positional_embedding"].float()
    x = layer_norm(x, w[prefix + "ln_pre.g"], w[prefix + "ln_pre.b"])
    n = x.shape[1]
    for i in range(v["layers"]):
        blk = f"{prefix}blocks.{i}."
        h = layer_norm(x, w[blk + "ln_1.g"], w[blk + "ln_1.b"])
        qkv = mm(h, w[blk + "attn.qkv_w"], precision) + w[blk + "attn.qkv_b"].float()
        q, k, vv = (t.reshape(b, n, heads, width // heads).transpose(1, 2) for t in qkv.split(width, -1))
        o = softmax_attention(q, k, vv, precision).transpose(1, 2).reshape(b, n, width)
        x = x + mm(o, w[blk + "attn.out_w"], precision) + w[blk + "attn.out_b"].float()
        h = layer_norm(x, w[blk + "ln_2.g"], w[blk + "ln_2.b"])
        h = quick_gelu(mm(h, w[blk + "mlp.fc_w"], precision) + w[blk + "mlp.fc_b"].float())
        x = x + mm(h, w[blk + "mlp.proj_w"], precision) + w[blk + "mlp.proj_b"].float()
    return x


def embed(w, prefix: str, cfg: dict, x01, precision: str = "float32", normalize: bool = False):
    """The image embedding: LayerNorm of the class token, then the
    projection; l2-normalized on request."""
    x = tokens(w, prefix, cfg, x01, precision)
    e = mm(layer_norm(x[:, 0], w[prefix + "ln_post.g"], w[prefix + "ln_post.b"]),
           w[prefix + "proj"], precision)
    return e / (torch.linalg.norm(e, dim=-1, keepdim=True) + 1e-12) if normalize else e


def zero_shot_logits(w, cfg: dict, head: torch.Tensor, scale: float, x01, precision: str = "float32"):
    """scale * normalize(embedding) @ head, head (embed_dim, classes)."""
    return mm(embed(w, "visual.", cfg, x01, precision, normalize=True), head, precision) * scale


def ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-example cross-entropy."""
    return -torch.log_softmax(logits, dim=-1).gather(1, y[:, None].long())[:, 0]
