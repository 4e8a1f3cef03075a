"""FLOP and byte counts of BLIP-2 OPT-2.7B's work, from shapes alone.

The counts are of the work the algorithm needs, as in
`counts/openflamingo-9b.py`: products at 2 m k n, attention 4 n m d forward
and 8 n m d backward (OPT's causal attention over the kept pairs), no
recompute, no elementwise work. One example is one image (its 1 + (S/p)^2
tokens through EVA, all of them read by the Q-Former's cross-attention)
and a prompt of T text ids after the Q query tokens: OPT runs over Q + T
positions.

- `forward_flops`: EVA (the patch embedding and every block), the
  Q-Former (self-attention on every layer, cross-attention on every
  `cross_attention_frequency`-th, the feed-forward), the language
  projection, OPT's blocks and the tied head;
- `pixel_backward_flops`: the loss's gradient back to the pixels: the input
  gradient of every product on the path, attention's backward;
- `apgd_iteration_flops`: a forward and a pixel gradient of the batch;
- `vit_attention_launch_counts`: operations and bytes of one launch of the
  port's `vit_attention` over the batch's EVA heads (head dim 88);
- `flash_launch_counts`: the same of one launch of the causal
  `flash_attention` over the batch's OPT heads (head dim 80), by the count
  `chip_smoke.py`'s kernels line uses (each input read once and each
  output written once, the forward 4 and the backward 10 x pairs x d, lse
  float32).
"""

from __future__ import annotations


def _itemsize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def _vision(cfg: dict):
    """(product FLOPs, attention FLOPs) of EVA's forward on one image."""
    v = cfg["vision_config"]
    w, f, p = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    n_patch = (v["image_size"] // p) ** 2
    n = n_patch + 1
    prod = 2 * n_patch * 3 * p * p * w
    prod += v["num_hidden_layers"] * (2 * n * w * 3 * w + 2 * n * w * w + 2 * 2 * n * w * f)
    att = v["num_hidden_layers"] * 4 * n * n * w
    return prod, att


def _qformer(cfg: dict):
    """(product FLOPs, attention FLOPs) of the Q-Former and the language
    projection on one image."""
    q, v, t = cfg["qformer_config"], cfg["vision_config"], cfg["text_config"]
    w, f, nq = q["hidden_size"], q["intermediate_size"], cfg["num_query_tokens"]
    n = (v["image_size"] // v["patch_size"]) ** 2 + 1
    e = q["encoder_hidden_size"]
    prod = att = 0.0
    for i in range(q["num_hidden_layers"]):
        prod += 2 * nq * w * 3 * w + 2 * nq * w * w  # self-attention: q, k, v, out
        att += 4 * nq * nq * w
        if i % q["cross_attention_frequency"] == 0:  # q and out over the queries, k and v over the image
            prod += 2 * 2 * nq * w * w + 2 * 2 * n * e * w
            att += 4 * nq * n * w
        prod += 2 * 2 * nq * w * f
    prod += 2 * nq * w * t["hidden_size"]
    return prod, att


def _lm(cfg: dict, t_text: int):
    """(product FLOPs, attention FLOPs) of OPT and its head over Q + T positions."""
    t = cfg["text_config"]
    d, f, v = t["hidden_size"], t["ffn_dim"], t["vocab_size"]
    n = cfg["num_query_tokens"] + t_text
    pairs = n * (n + 1) / 2
    prod = t["num_hidden_layers"] * (2 * n * d * 4 * d + 2 * 2 * n * d * f) + 2 * n * d * v
    att = t["num_hidden_layers"] * 4 * pairs * d
    return prod, att


def _parts(cfg: dict, t_text: int):
    parts = (_vision(cfg), _qformer(cfg), _lm(cfg, t_text))
    return sum(p for p, _ in parts), sum(a for _, a in parts)


def forward_flops(cfg: dict, t_text: int) -> float:
    prod, att = _parts(cfg, t_text)
    return prod + att


def pixel_backward_flops(cfg: dict, t_text: int) -> float:
    prod, att = _parts(cfg, t_text)
    return prod + 2 * att


def apgd_iteration_flops(cfg: dict, batch: int, t_text: int) -> float:
    return batch * (forward_flops(cfg, t_text) + pixel_backward_flops(cfg, t_text))


def vit_attention_launch_counts(cfg: dict, batch: int, dtype: str) -> dict:
    v = cfg["vision_config"]
    heads = v["num_attention_heads"]
    d = v["hidden_size"] // heads
    n = (v["image_size"] // v["patch_size"]) ** 2 + 1
    bh, itm = batch * heads, _itemsize(dtype)
    return {"fwd": (4 * bh * n * n * d, 4 * bh * n * d * itm + 4 * bh * n),
            "bwd": (10 * bh * n * n * d, 8 * bh * n * d * itm + 4 * bh * n)}


def flash_launch_counts(cfg: dict, batch: int, n: int, dtype: str) -> dict:
    """One causal launch over `batch` x heads of n positions (Q + T)."""
    t = cfg["text_config"]
    heads = t["num_attention_heads"]
    d = t["hidden_size"] // heads
    bh, itm = batch * heads, _itemsize(dtype)
    pairs = bh * n * (n + 1) / 2
    return {"fwd": (4 * pairs * d, 4 * bh * n * d * itm + 4 * bh * n),
            "bwd": (10 * pairs * d, 8 * bh * n * d * itm + 4 * bh * n)}
