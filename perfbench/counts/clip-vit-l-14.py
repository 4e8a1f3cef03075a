"""FLOP and byte counts of CLIP ViT-L/14's work, from shapes alone.

The counts are of the work the algorithm needs, whatever implements it:
every matrix product at 2 m k n, attention at 4 n^2 d a head forward
(Q K^T and P V) and 8 n^2 d backward (dV, dP, dQ, dK); no recompute (a
kernel's or `remat`'s replay is not counted), and no elementwise work.

- `forward_flops`: one image through the tower to its embedding;
- `pixel_backward_flops`: the gradient of an image's embedding back to its
  pixels (the input gradient of every product; no weight gradients);
- `weight_backward_flops`: the weight gradients of the tower's products;
- `apgd_iteration_flops`: an APGD iteration on a zero-shot head: a forward
  and a pixel gradient of the batch, the head's product included;
- `fare_step_flops`: a FARE step: the frozen forward, the inner APGD
  (n + 1 forwards, n pixel gradients), the clean and adversarial outer
  forwards and the adversarial forward's full backward;
- `vit_attention_launch_counts`: the operations and bytes of one launch of
  the port's `vit_attention` kernels, by the count `chip_smoke.py`'s
  kernels line uses: each input read once and each output written once,
  the forward 4 n^2 d a (batch, head) row, the backward 10 n^2 d (its kernel
  recomputes S), lse float32.
"""

from __future__ import annotations


def _shape(cfg: dict):
    v = cfg["vision_cfg"]
    w, p, s = v["width"], v["patch_size"], v["image_size"]
    n = (s // p) ** 2 + 1
    return w, v["layers"], p, n, int(w * v.get("mlp_ratio", 4.0))


def _product_flops(cfg: dict) -> float:
    """The tower's matrix products for one image, forward."""
    w, layers, p, n, hidden = _shape(cfg)
    block = 2 * n * w * 3 * w + 2 * n * w * w + 2 * 2 * n * w * hidden
    return 2 * (n - 1) * 3 * p * p * w + layers * block + 2 * w * cfg["embed_dim"]


def _attention_flops(cfg: dict) -> float:
    """Attention's products for one image, forward (all heads: n^2 x width)."""
    w, layers, _, n, _ = _shape(cfg)
    return layers * 4 * n * n * w


def forward_flops(cfg: dict) -> float:
    return _product_flops(cfg) + _attention_flops(cfg)


def pixel_backward_flops(cfg: dict) -> float:
    return _product_flops(cfg) + 2 * _attention_flops(cfg)


def weight_backward_flops(cfg: dict) -> float:
    return _product_flops(cfg)


def apgd_iteration_flops(cfg: dict, batch: int, classes: int) -> float:
    head = 2 * cfg["embed_dim"] * classes
    return batch * (forward_flops(cfg) + pixel_backward_flops(cfg) + 2 * head)


def fare_step_flops(cfg: dict, batch: int, inner_iters: int) -> float:
    f, b = forward_flops(cfg), pixel_backward_flops(cfg)
    inner = (inner_iters + 1) * f + inner_iters * b
    outer = 2 * f + b + weight_backward_flops(cfg)
    return batch * (f + inner + outer)


def vit_attention_launch_counts(cfg: dict, batch: int, dtype: str) -> dict:
    """{"fwd": (operations, bytes), "bwd": (operations, bytes)} of one
    launch over the batch's heads."""
    w, _, _, n, _ = _shape(cfg)
    d = cfg["vision_cfg"].get("head_width", 64)
    bh = batch * (w // d)
    itm = 2 if dtype == "bfloat16" else 4
    elems = bh * n * d
    return {"fwd": (4 * bh * n * n * d, 4 * elems * itm + bh * n * 4),
            "bwd": (10 * bh * n * n * d, 8 * elems * itm + bh * n * 4)}
