"""BLIP-2 OPT (EVA ViT-g/14, the Q-Former, OPT) as plain PyTorch, from the
published architecture (HF transformers `Blip2ForConditionalGeneration`,
`modeling_blip_2.py` and `modeling_opt.py`; Salesforce/blip2-opt-2.7b's
`config.json`), in float32 or the fp8 control, with the hash tokenizer of
the port's eval at the same protocol.

- Pixels: [0, 1] images resized to the tower's size (bicubic; the cell
  draws them at that size, so no resize runs there) and normalized with
  CLIP's mean and std.
- Vision (`Blip2VisionModel`): a strided patch convolution with a bias,
  [class; patches] plus learned positions, pre-LayerNorm blocks (eps 1e-6)
  whose fused qkv carries the (q_bias, 0, v_bias) vector, softmax attention
  over every token, an exact-GELU MLP; a post-LayerNorm over every token.
- Q-Former (`Blip2QFormerModel`, the query tokens alone): the learned
  queries through a LayerNorm (eps 1e-12), then per layer a post-LayerNorm
  self-attention, a cross-attention to the image tokens on layers 0, 2, ...
  (`cross_attention_frequency` 2) and the query feed-forward (exact GELU).
- The language projection in float32, its output PREFIXED to OPT's token
  embeddings.
- OPT (`OPTForCausalLM`, `do_layer_norm_before`): learned positions at
  row i + 2 (i counts the queries too), pre-LayerNorm blocks (eps 1e-5)
  with biases, q scaled by d^-1/2, causal softmax attention, a ReLU MLP, a
  final LayerNorm and the head tied to the token embedding.
- Tokens: one id a whitespace word, 3 + crc32(word) % (512 - 5) (the port's
  hash tokenizer); BOS 1, EOS 2, pad 0. A teacher-forced caption prompt is
  BOS, its context ("A photo of ") and the answer after it, EOS, padded on
  the right to 64 ids; the loss mask covers the answer and EOS. The logit
  at text position t - 1 (the last query's for t = 0) predicts token t;
  the loss is the per-example mean cross-entropy over the mask.

Departures from HF: the weights are the harness's (the port's names and
(in, out) layouts, read by name and cast to float32 at use); the resize is
PyTorch's antialiased bicubic, where the JAX package and the port resize
with their own matrices (not exercised at the cells' image sizes); no
dropout (eval); the tied head is read from the token embedding.
"""

from __future__ import annotations

import zlib
from typing import List, Tuple

import torch

from reference.common import fp8_round, gelu, layer_norm, mm, normalize_pixels, softmax_attention

VOCAB = 512
PAD, BOS, EOS = 0, 1, 2
MAX_LEN = 64  # the adapter's teacher-forced length
POS_OFFSET = 2
CAPTION_CONTEXT = "A photo of "


# ------------------------------------------------------------------ tokens
def encode(text: str) -> List[int]:
    return [3 + zlib.crc32(w.encode()) % (VOCAB - 5) for w in text.strip().split()]


def teacher_forced(prompt: str) -> Tuple[List[int], List[float]]:
    """(ids, loss mask) of a teacher-forced caption prompt, MAX_LEN long."""
    if prompt.startswith(CAPTION_CONTEXT):
        ctx, ans = CAPTION_CONTEXT, prompt[len(CAPTION_CONTEXT):]
    else:
        ctx, ans = "", prompt
    ctx_ids, ans_ids = [BOS] + encode(ctx), encode(ans) + [EOS]
    ids = (ctx_ids + ans_ids)[:MAX_LEN]
    mask = ([0.0] * len(ctx_ids) + [1.0] * len(ans_ids))[:MAX_LEN]
    pad = MAX_LEN - len(ids)
    return ids + [PAD] * pad, mask + [0.0] * pad


def query_ids(prompt: str) -> List[int]:
    """The ids a caption is generated after: BOS and the prompt."""
    return [BOS] + encode(prompt)


def served_ids(caption: str) -> List[int]:
    """The served tokens of a caption in the hash tokenizer's decoding ("tok<id> ...")."""
    return [int(w[3:]) for w in caption.split()]


# ------------------------------------------------------------------ model
def _resize(x: torch.Tensor, size: int) -> torch.Tensor:
    if x.shape[-1] == size and x.shape[-2] == size:
        return x
    return torch.nn.functional.interpolate(x, size=(size, size), mode="bicubic", align_corners=False,
                                           antialias=True)


def _heads(a: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, w = a.shape
    return a.reshape(b, n, heads, w // heads).transpose(1, 2)


def _merge(a: torch.Tensor) -> torch.Tensor:
    b, h, n, d = a.shape
    return a.transpose(1, 2).reshape(b, n, h * d)


def _lin(x, w, pre, precision):
    return mm(x, w[pre + "_w"], precision) + w[pre + "_b"].float()


def vision(w, cfg, x01, precision):
    """[0,1] pixels -> (B, 1 + (S/p)^2, width) post-LayerNorm features."""
    v = cfg["vision_config"]
    width, p, heads, eps = v["hidden_size"], v["patch_size"], v["num_attention_heads"], v["layer_norm_eps"]
    x = normalize_pixels(_resize(x01.float(), v["image_size"]))
    b = x.shape[0]
    kernel = w["visual.patch_embed"].float().t().reshape(width, 3, p, p)
    if precision == "fp8":  # the patch embedding is a product too
        x, kernel = fp8_round(x), fp8_round(kernel)
    x = torch.nn.functional.conv2d(x, kernel, w["visual.patch_bias"].float(), stride=p)
    x = x.flatten(2).transpose(1, 2)
    cls = w["visual.class_embedding"].float().expand(b, 1, width)
    x = torch.cat([cls, x], dim=1) + w["visual.positional_embedding"].float()
    for i in range(v["num_hidden_layers"]):
        blk = f"visual.blocks.{i}."
        h = layer_norm(x, w[blk + "ln_1.g"], w[blk + "ln_1.b"], eps)
        q, k, vv = (_heads(t, heads) for t in _lin(h, w, blk + "attn.qkv", precision).split(width, dim=-1))
        x = x + _lin(_merge(softmax_attention(q, k, vv, precision)), w, blk + "attn.out", precision)
        h = layer_norm(x, w[blk + "ln_2.g"], w[blk + "ln_2.b"], eps)
        x = x + _lin(gelu(_lin(h, w, blk + "mlp.fc", precision)), w, blk + "mlp.proj", precision)
    return layer_norm(x, w["visual.ln_post.g"], w["visual.ln_post.b"], eps)


def _qformer_attention(w, pre, h, kv, heads, eps, precision):
    q, k, v = (_heads(_lin(src, w, pre + n, precision), heads) for n, src in (("q", h), ("k", kv), ("v", kv)))
    o = _lin(_merge(softmax_attention(q, k, v, precision)), w, pre + "out", precision)
    return layer_norm(o + h, w[pre + "ln_g"], w[pre + "ln_b"], eps)


def qformer(w, cfg, image, precision):
    """(B, n, vision width) image features -> (B, queries, Q-Former width)."""
    qc = cfg["qformer_config"]
    heads, eps = qc["num_attention_heads"], qc["layer_norm_eps"]
    b = image.shape[0]
    h = w["query_tokens"].float().expand(b, *w["query_tokens"].shape)
    h = layer_norm(h, w["qformer.ln_embed.g"], w["qformer.ln_embed.b"], eps)
    for i in range(qc["num_hidden_layers"]):
        lay = f"qformer.layers.{i}."
        h = _qformer_attention(w, lay + "self_attn.", h, h, heads, eps, precision)
        if i % qc["cross_attention_frequency"] == 0:
            h = _qformer_attention(w, lay + "cross.", h, image, heads, eps, precision)
        f = _lin(gelu(_lin(h, w, lay + "ffn.fc", precision)), w, lay + "ffn.proj", precision)
        h = layer_norm(f + h, w[lay + "ffn.ln_g"], w[lay + "ffn.ln_b"], eps)
    return h


def forward(w, cfg, x01, ids, precision: str = "float32"):
    """[0,1] images (B, 3, S, S) and text ids (B, T) -> float32 logits
    (B, queries + T, vocab): the queries' positions first."""
    t = cfg["text_config"]
    heads, eps = t["num_attention_heads"], t.get("layer_norm_eps", 1e-5)
    queries = qformer(w, cfg, vision(w, cfg, x01, precision), precision)
    lm_in = mm(queries, w["language_projection.w"], precision) + w["language_projection.b"].float()
    x = torch.cat([lm_in, w["opt.tok_embedding"][ids].float()], dim=1)
    n = x.shape[1]
    x = x + w["opt.pos_embedding"][POS_OFFSET:POS_OFFSET + n].float()
    pos = torch.arange(n, device=x.device)
    causal = torch.where(pos[None, :] <= pos[:, None], 0.0, -1e30).to(x.device)
    for i in range(t["num_hidden_layers"]):
        blk = f"opt.blocks.{i}."
        h = layer_norm(x, w[blk + "ln1.g"], w[blk + "ln1.b"], eps)
        q, k, v = (_heads(mm(h, w[blk + f"attn.w{c}"], precision) + w[blk + f"attn.b{c}"].float(), heads)
                   for c in "qkv")
        o = _merge(softmax_attention(q, k, v, precision, bias=causal))
        x = x + mm(o, w[blk + "attn.wo"], precision) + w[blk + "attn.bo"].float()
        h = layer_norm(x, w[blk + "ln2.g"], w[blk + "ln2.b"], eps)
        h = torch.relu(mm(h, w[blk + "mlp.fc1"], precision) + w[blk + "mlp.b1"].float())
        x = x + mm(h, w[blk + "mlp.fc2"], precision) + w[blk + "mlp.b2"].float()
    x = layer_norm(x, w["opt.final_norm.g"], w["opt.final_norm.b"], eps)
    return mm(x, w["opt.tok_embedding"].t(), precision)


def per_example_loss(w, cfg, x01, ids, mask, precision: str = "float32"):
    """The mean next-token cross-entropy over each example's mask (B,)."""
    nq = cfg["num_query_tokens"]
    logits = forward(w, cfg, x01, ids, precision)
    lp = torch.log_softmax(logits[:, nq - 1:-1], dim=-1)
    tok = lp.gather(-1, ids[..., None])[..., 0]
    m = mask.float()
    return -(tok * m).sum(dim=-1) / m.sum(dim=-1).clamp(min=1.0)
