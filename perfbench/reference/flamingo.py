"""OpenFlamingo (CLIP ViT-L/14, Perceiver resampler, gated cross-attention,
MPT-7B) as plain PyTorch, from the published architecture
(mlfoundations/open_flamingo; mosaicml/mpt-7b), in float32 or the fp8
control, with the hash tokenizer of the port's eval at the same protocol.

- Vision: every patch token of the ViT's last block (no class token).
- Perceiver: 64 learned latents attend to [media; latents] (LayerNorm on
  each), a 4x exact-GELU feed-forward, residuals, a final LayerNorm.
- LM: MPT pre-LayerNorm blocks without biases, fused q|k|v, ALiBi
  (slope_h = 2^(-8 (h + 1) / H), bias -slope (i - j)), causal attention, a 4x
  GELU MLP, the head tied to the token embedding.
- Before every 4th block a gated cross-attention block: text token t attends
  to the latents of the last <image> at or before it (none before the
  first: its output is zero), x += tanh(attn_gate) attn; x += tanh(ff_gate)
  ff(x).
- Tokens: one id a whitespace word, 3 + crc32(word) % (vocab - 5), <image>
  vocab - 1, <|endofchunk|> the EOS id 2; a teacher-forced prompt is split at
  its last ':' and only the answer after it, <image> and <|endofchunk|>
  aside, carries loss; the loss is the per-example sum of the next-token
  cross-entropy.

Weights are read by name from the harness's state (the port's module
names) and cast to float32 at use.
"""

from __future__ import annotations

import math
import re
import zlib
from typing import List, Tuple

import torch

from reference import clip as C
from reference.common import gelu, layer_norm, mm, softmax_attention

VOCAB = 512
EOS = 2
MEDIA = VOCAB - 1


# ------------------------------------------------------------------ tokens
def encode_words(text: str) -> List[int]:
    return [MEDIA if w == "<image>" else 3 + zlib.crc32(w.encode()) % (VOCAB - 5)
            for w in text.strip().split()]


def encode(text: str) -> List[int]:
    out = []
    for seg in re.split(r"(<image>|<\|endofchunk\|>)", text):
        if seg == "<image>":
            out.append(MEDIA)
        elif seg == "<|endofchunk|>":
            out.append(EOS)
        elif seg:
            out.extend(encode_words(seg))
    return out


def teacher_forced(prompt: str) -> Tuple[List[int], List[float]]:
    """(ids, loss mask) of a teacher-forced prompt."""
    cut = prompt.rfind(":")
    ctx, ans = (encode(prompt[:cut + 1]), encode(prompt[cut + 1:])) if cut >= 0 else ([], encode(prompt))
    ids = ctx + ans
    mask = [0.0] * len(ctx) + [1.0] * len(ans)
    return ids, [0.0 if t in (MEDIA, EOS) else m for t, m in zip(ids, mask)]


def served_ids(caption: str) -> List[int]:
    """The served tokens of a caption in the hash tokenizer's decoding ("tok<id> ...")."""
    return [int(w[3:]) for w in caption.split()]


# ------------------------------------------------------------------ model
def _ln(x, w, pre):
    return layer_norm(x, w[pre + "_g"], w[pre + "_b"])


def perceiver(w, cfg, feats, precision):
    """(B, n, D) patch features -> (B, latents, D)."""
    per = cfg["perceiver"]
    heads, hd = per["heads"], per["dim_head"]
    b = feats.shape[0]
    lat = w["perceiver.latents"].float().expand(b, *w["perceiver.latents"].shape)
    for i in range(per["depth"]):
        p = f"perceiver.layers.{i}."
        xm = _ln(feats, w, p + "attn.ln_media")
        lt = _ln(lat, w, p + "attn.ln_lat")
        q = mm(lt, w[p + "attn.to_q"], precision)
        k, v = mm(torch.cat([xm, lt], dim=1), w[p + "attn.to_kv"], precision).chunk(2, dim=-1)

        def hs(a):
            return a.reshape(b, -1, heads, hd).transpose(1, 2)

        o = softmax_attention(hs(q), hs(k), hs(v), precision).transpose(1, 2).reshape(b, -1, heads * hd)
        lat = mm(o, w[p + "attn.to_out"], precision) + lat
        lat = _ff(w, p + "ff.", lat, precision) + lat
    return layer_norm(lat, w["perceiver.norm_g"], w["perceiver.norm_b"])


def _ff(w, p, x, precision):
    h = layer_norm(x, w[p + "ln_g"], w[p + "ln_b"])
    return mm(gelu(mm(h, w[p + "w1"], precision)), w[p + "w2"], precision)


def xattn(w, cfg, j, x, media, text_time, precision):
    """Gated cross-attention block j; media (B, latents, D) of the one image."""
    per = cfg["perceiver"]
    heads, hd = per["heads"], per["dim_head"]
    p = f"xattn.{j}."
    b, t, _ = x.shape
    h = layer_norm(x, w[p + "attn.ln_g"], w[p + "attn.ln_b"])
    q = mm(h, w[p + "attn.to_q"], precision)
    k, v = mm(media, w[p + "attn.to_kv"], precision).chunk(2, dim=-1)

    def hs(a):
        return a.reshape(b, -1, heads, hd).transpose(1, 2)

    s = mm(hs(q), hs(k).transpose(-1, -2), precision) / math.sqrt(hd)
    allowed = (text_time == 1)[:, None, :, None]
    a = torch.softmax(torch.where(allowed, s, torch.full_like(s, -1e30)), dim=-1)
    a = torch.where(allowed, a, torch.zeros_like(a))
    o = mm(a, hs(v), precision).transpose(1, 2).reshape(b, t, heads * hd)
    x = x + torch.tanh(w[p + "attn_gate"].float()) * mm(o, w[p + "attn.to_out"], precision)
    return x + torch.tanh(w[p + "ff_gate"].float()) * _ff(w, p + "ff.", x, precision)


def alibi_slopes(n_heads: int, bias_max: float) -> torch.Tensor:
    n2 = 2 ** math.ceil(math.log2(n_heads))
    m = torch.arange(1, n2 + 1, dtype=torch.float32) * (bias_max / n2)
    s = 1.0 / torch.pow(2.0, m)
    if n2 != n_heads:
        s = torch.cat([s[1::2], s[::2]])[:n_heads]
    return s


def forward(w, cfg, x01, ids, precision: str = "float32"):
    """[0,1] images (B, 3, S, S), one per example, and token ids (B, T) ->
    float32 logits (B, T, vocab)."""
    lang = cfg["lang"]
    d, heads = lang["d_model"], lang["n_heads"]
    hd = d // heads
    feats = C.tokens(w, "vision.", cfg["vision"], x01, precision)[:, 1:]
    media = perceiver(w, cfg, feats, precision)
    b, t = ids.shape
    text_time = torch.cumsum((ids == MEDIA).to(torch.int32), dim=1)
    x = w["mpt.tok_embedding"][ids].float()
    slopes = alibi_slopes(heads, float(lang["alibi_bias_max"])).to(x.device)
    pos = torch.arange(t, device=x.device)
    rel = (pos[:, None] - pos[None, :]).float()
    bias = torch.where(rel >= 0, -slopes[:, None, None] * rel, torch.full_like(rel, -1e30))
    every = cfg["cross_attn_every_n_layers"]
    for i in range(lang["n_layers"]):
        if i % every == 0:
            x = xattn(w, cfg, i // every, x, media, text_time, precision)
        p = f"mpt.blocks.{i}."
        h = layer_norm(x, w[p + "norm_1"], eps=lang["norm_eps"])
        q, k, v = (a.reshape(b, t, heads, hd).transpose(1, 2)
                   for a in mm(h, w[p + "attn.wqkv"], precision).split(d, dim=-1))
        o = softmax_attention(q, k, v, precision, bias=bias).transpose(1, 2).reshape(b, t, d)
        x = x + mm(o, w[p + "attn.out_w"], precision)
        h = layer_norm(x, w[p + "norm_2"], eps=lang["norm_eps"])
        x = x + mm(gelu(mm(h, w[p + "mlp.up_w"], precision)), w[p + "mlp.down_w"], precision)
    x = layer_norm(x, w["mpt.norm_f"], eps=lang["norm_eps"])
    return mm(x, w["mpt.tok_embedding"].t(), precision)


def per_example_loss(w, cfg, x01, ids, mask, precision: str = "float32"):
    """The summed next-token cross-entropy over the answer (B,)."""
    logits = forward(w, cfg, x01, ids, precision)
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    tok = lp.gather(-1, ids[:, 1:, None])[..., 0]
    return -(tok * mask[:, 1:]).sum(dim=-1)
