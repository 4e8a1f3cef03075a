#!/usr/bin/env python3
"""Sweep of the APGD hot path's knobs at CLIP ViT-L/14 (forward and pixel
gradient), on one card.

    python3 scripts/perf_sweep_torch.py [--device cuda] [--calib] [name ...]

Each config runs SWEEP_K (20) evaluations of ViT-L/14 in bf16 (the CLI's
layout: matrices bf16, 1-D parameters float32), random weights from seed 0,
a CE loss against a random 1000-class head at logit scale 100: a forward,
the gradient with respect to the pixels and an l-inf sign step of 1/255
clamped to [0,1], the next evaluation on the stepped pixels (forward-only
configs add 1e-6 x the loss instead). The K evaluations are timed with CUDA
events after a first call; one JSON line a config: ms an evaluation and
example steps/s; a config that fails prints its error, the others still
run and the script exits 1. `--calib` first times 100 bf16 products at the
qkv shape (8224 x 1024 x 3072, `calibrate_matmul`). Names default to every
config.

The configs that mean something in PyTorch: the batch sweep, `remat` on and
off (the port's `remat` is whole-block recompute), forward only, the CLIP
normalization folded into the patch embedding (`fold_normalization`), and
the attention taken out (`noattn`: q, k, v products kept, the attention
returns v; a measurement of attention's share, not a model).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import bench_common_torch as common  # noqa: E402

K = int(os.environ.get("SWEEP_K", 20))

CONFIGS = {
    # name: (batch, knobs)
    "b1": (1, {}),
    "b2": (2, {}),
    "b4": (4, {}),
    "b6": (6, {}),
    "b8": (8, {}),
    "b12": (12, {}),
    "b16": (16, {}),
    "b24": (24, {}),
    "b32": (32, {}),
    "b48": (48, {}),
    "b64": (64, {}),
    "b8_remat": (8, {"remat": True}),
    "b32_remat": (32, {"remat": True}),
    "b64_remat": (64, {"remat": True}),
    "b8_fwdonly": (8, {"fwd_only": True}),
    "b32_fwdonly": (32, {"fwd_only": True}),
    "b8_foldnorm": (8, {"fold_norm": True}),
    "b8_foldnorm_fwdonly": (8, {"fold_norm": True, "fwd_only": True}),
    "b8_noattn": (8, {"ablate": "noattn"}),
    "b8_fwdonly_noattn": (8, {"fwd_only": True, "ablate": "noattn"}),
    "b32_noattn": (32, {"ablate": "noattn"}),
}


def calibrate_matmul(device="cuda", iters: int = 100) -> float:
    """TFLOP/s of `iters` back-to-back bf16 products at the qkv projection's
    shape (32 x 257 tokens, 1024 -> 3072), each written into one output and
    nothing else in the timed loop, timed with CUDA events after a warm
    pass."""
    import torch

    m, kd, n = 32 * 257, 1024, 3072
    a = torch.ones(m, kd, dtype=torch.bfloat16, device=device)
    w = torch.full((kd, n), 1.0 / kd, dtype=torch.bfloat16, device=device)
    c = torch.empty(m, n, dtype=torch.bfloat16, device=device)

    def products():
        for _ in range(iters):
            torch.mm(a, w, out=c)

    products()
    ms = common.events_ms(products, device)
    return iters * 2 * m * kd * n / (ms / 1e3) / 1e12


def run_one(name: str, batch: int, knobs: dict, device="cuda", k: int = K, model_name: str = "ViT-L-14") -> dict:
    """K evaluations of one config; prints and returns its JSON line."""
    import numpy as np
    import torch

    import robustvlm_tpu_torch.models.clip.model as M
    from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS
    from robustvlm_tpu_torch.ops.image import normalize_clip
    from robustvlm_tpu_torch.ops.losses import ce_loss

    cfg = CLIP_CONFIGS[model_name]
    fwd_only, remat = knobs.get("fwd_only", False), knobs.get("remat", False)
    fold = knobs.get("fold_norm", False)
    model = CLIP(cfg, device=device).init_random_(0)
    if fold:
        M.fold_normalization(model.visual)
    M.cast_matrices_(model, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(1)
    temb = torch.randn(cfg.embed_dim, 1000, generator=gen, device=device)
    temb = temb / temb.norm(dim=0, keepdim=True)
    npr = np.random.RandomState(0)
    s = cfg.image_size
    x0 = torch.from_numpy(npr.rand(batch, 3, s, s).astype(np.float32)).to(device)
    y = torch.from_numpy(npr.randint(0, 1000, batch)).to(device)

    def loss(xa):
        e = model.encode_image(xa if fold else normalize_clip(xa), normalize=True,
                               compute_dtype=torch.bfloat16, remat=remat)
        return ce_loss(e @ (100.0 * temb), y, reduction="none").sum()

    def many():
        xc = x0
        for _ in range(k):
            if fwd_only:
                with torch.no_grad():
                    xc = xc + 1e-6 * loss(xc)
            else:
                xa = xc.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(loss(xa), xa)
                xc = torch.clamp(xc + (1.0 / 255.0) * torch.sign(g), 0.0, 1.0)
        return xc

    orig = M.vit_attention_qkv
    if knobs.get("ablate") == "noattn":  # v's block of the fused projection, heads merged
        M.vit_attention_qkv = lambda qkv, heads: qkv[..., 2 * qkv.shape[-1] // 3:]
    try:
        t_first = common.timed_s(many, device)
        ms = common.events_ms(many, device)
    finally:
        M.vit_attention_qkv = orig
    return common.emit({"script": "scripts/perf_sweep_torch.py", "config": name, "batch": batch,
                        "knobs": knobs, "k": k, "ms_per_eval": ms / k,
                        "example_steps_per_sec": batch * k / (ms / 1e3), "first_call_s": t_first})


def main(argv=None) -> int:
    from robustvlm_tpu_torch.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("names", nargs="*", help=f"configs (default: all): {', '.join(CONFIGS)}")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--calib", action="store_true", help="time the bf16 qkv-shape products first")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if args.calib or os.environ.get("SWEEP_CALIB"):
        common.emit({"script": "scripts/perf_sweep_torch.py", "matmul_calibration_tf_s": calibrate_matmul(dev),
                     "shape": [32 * 257, 1024, 3072], "card": common.card()})
    failed = []
    for name in args.names or list(CONFIGS):
        batch, knobs = CONFIGS[name]
        t0 = time.perf_counter()
        try:
            run_one(name, batch, dict(knobs), dev)
        except Exception as e:  # noqa: BLE001 - reported; the sweep goes on and exits 1
            failed.append(name)
            common.emit({"config": name, "error": f"{type(e).__name__}: {e!s:.300}",
                         "s": time.perf_counter() - t0})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
