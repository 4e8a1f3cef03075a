"""FLOP and byte counts of OpenFlamingo-9B's work, from shapes alone.

The counts are of the work the algorithm needs, as in
`counts/clip-vit-l-14.py`: products at 2 m k n, attention 4 n m d forward
and 8 n m d backward (causal attention over the kept pairs), no recompute,
no elementwise work. One example is one image (its 256 patch tokens go to
the Perceiver) and a prompt of T tokens.

- `forward_flops`: the ViT tower to its last block, the Perceiver, the
  eight gated cross-attention blocks, the 32 MPT blocks and the tied head;
- `pixel_backward_flops`: the loss's gradient back to the pixels: the input
  gradient of every product on the path, attention's backward;
- `apgd_iteration_flops`: a forward and a pixel gradient of the batch;
- `flash_alibi_launch_counts`: operations and bytes of one launch of the
  port's causal ALiBi `flash_attention` over the batch's MPT heads, by the
  count `chip_smoke.py`'s kernels line uses (each input read once and each
  output written once, the forward 4 and the backward 10 x pairs x d, lse
  float32);
- `vit_attention_launch_counts`: the ViT tower's, from the CLIP counts.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path


def _clip():
    spec = importlib.util.spec_from_file_location("perfbench_counts_clip_vit_l_14",
                                                  Path(__file__).with_name("clip-vit-l-14.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CLIP = _clip()


def _tower(cfg: dict) -> dict:
    """The vision config without its head: the Perceiver takes every token."""
    v = dict(cfg["vision"])
    return dict(v, embed_dim=0)


def _parts(cfg: dict, t: int):
    """(product FLOPs, attention FLOPs) of one example's forward, without the ViT."""
    lang, per = cfg["lang"], cfg["perceiver"]
    d, v, f = lang["d_model"], lang["vocab_size"], lang["expansion_ratio"]
    dv = cfg["vision"]["vision_cfg"]["width"]
    n_img = (cfg["vision"]["vision_cfg"]["image_size"] // cfg["vision"]["vision_cfg"]["patch_size"]) ** 2
    lat, inner = per["num_latents"], per["heads"] * per["dim_head"]
    mult = per["ff_mult"]
    prod = att = 0.0
    # Perceiver: q from the latents, k|v from [media; latents], out, feed-forward
    for _ in range(per["depth"]):
        prod += 2 * lat * dv * inner + 2 * (n_img + lat) * dv * 2 * inner + 2 * lat * inner * dv
        prod += 2 * 2 * lat * dv * mult * dv
        att += 4 * lat * (n_img + lat) * inner
    # gated cross-attention blocks: text queries over the image's latents
    for _ in range(lang["n_layers"] // cfg["cross_attn_every_n_layers"]):
        prod += 2 * t * d * inner + 2 * lat * dv * 2 * inner + 2 * t * inner * d
        prod += 2 * 2 * t * d * mult * d
        att += 4 * t * lat * inner
    # MPT blocks, causal attention over t (t + 1) / 2 pairs, the tied head
    pairs = t * (t + 1) / 2
    prod += lang["n_layers"] * (2 * t * d * 3 * d + 2 * t * d * d + 2 * 2 * t * d * f * d)
    att += lang["n_layers"] * 4 * pairs * d
    prod += 2 * t * d * v
    return prod, att


def forward_flops(cfg: dict, t: int) -> float:
    prod, att = _parts(cfg, t)
    return CLIP.forward_flops(_tower(cfg)) + prod + att


def pixel_backward_flops(cfg: dict, t: int) -> float:
    prod, att = _parts(cfg, t)
    return CLIP.pixel_backward_flops(_tower(cfg)) + prod + 2 * att


def apgd_iteration_flops(cfg: dict, batch: int, t: int) -> float:
    return batch * (forward_flops(cfg, t) + pixel_backward_flops(cfg, t))


def flash_alibi_launch_counts(cfg: dict, batch: int, t: int, dtype: str) -> dict:
    lang = cfg["lang"]
    d = lang["d_model"] // lang["n_heads"]
    bh = batch * lang["n_heads"]
    itm = 2 if dtype == "bfloat16" else 4
    elems = bh * t * d
    pairs = bh * t * (t + 1) / 2
    return {"fwd": (4 * pairs * d, 4 * elems * itm + bh * t * 4),
            "bwd": (10 * pairs * d, 8 * elems * itm + bh * t * 4)}


def vit_attention_launch_counts(cfg: dict, batch: int, dtype: str) -> dict:
    return CLIP.vit_attention_launch_counts(cfg["vision"], batch, dtype)
