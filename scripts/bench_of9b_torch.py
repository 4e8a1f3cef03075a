#!/usr/bin/env python3
"""OpenFlamingo-9B at scale: memory plan, FLOP count and shard plan.

    python3 scripts/bench_of9b_torch.py [--device cuda] [--memory_gib G] [--rate_tf_s R]

OpenFlamingo-9B (ViT-L/14, the Perceiver resampler, MPT-7B with a gated
cross-attention block every 4 layers) is the reference's other flagship
VLM. Three sections, one JSON line each, all arithmetic over shapes (the
model is built on the meta device; no weights are drawn):

1. `plan`: parameters by component (vision, perceiver, xattn, mpt) and
   their GiB at rest in bf16, the APGD state (8 image-sized float32
   buffers) and the remat checkpoints (the block boundaries of both
   towers), set against the card's memory as
   `torch.cuda.get_device_properties` reports it (`--memory_gib` gives it
   on the CPU).
2. `flops_projection`: the matmul FLOPs of one APGD step
   (`attack_step_matmul_flops`, the LLaVA count's rules over OpenFlamingo)
   for 0-shot captioning and 4-shot few-shot, and, when a rate is given
   (`--rate_tf_s`, e.g. the LLaVA stage's measured `model_tf_s`), the
   steps/s it projects: a projection, not a measurement.
3. `shard_plan`: the port's `param_sharding_rules` on a (data, fsdp, model)
   = (1, 8, 1) mesh shape: each device's parameter bytes, and every
   parameter whose rule named an axis that `_fit_spec` dropped because the
   axis does not divide that dim (ViT-L/14's 588-row patch embedding on 8).
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import bench_common_torch as common  # noqa: E402

CONFIG = "openflamingo-9b"


def _meta_model(config: str = CONFIG):
    import torch

    from robustvlm_tpu_torch.models.flamingo.model import FLAMINGO_CONFIGS, Flamingo

    with torch.device("meta"):
        return Flamingo(FLAMINGO_CONFIGS[config])


def param_counts(config: str = CONFIG) -> dict:
    """{component: parameter count} of the model's top-level modules."""
    model = _meta_model(config)
    return {name: sum(p.numel() for p in mod.parameters()) for name, mod in model.named_children()}


def plan(batch: int = 8, memory_gib: float = None, device=None, config: str = CONFIG) -> dict:
    """The memory plan of the APGD attack step against one card's memory."""
    import torch

    from robustvlm_tpu_torch.models.flamingo.model import FLAMINGO_CONFIGS

    cfg = FLAMINGO_CONFIGS[config]
    comp = param_counts(config)
    n_params = sum(comp.values())
    params_gib = n_params * 2 / 2**30  # bf16 at rest
    s = cfg.vision.image_size
    # APGD's l-inf state: x_adv, x_best, x_best_adv, the gradient, momentum
    # and the rest: about 8 image-sized float32 buffers
    state_gib = 8 * batch * 3 * s * s * 4 / 2**30
    # remat: the bf16 (B, T, D) block boundaries of the LM (blocks and gated
    # blocks) and of the tower, at the eval's text length
    t_txt = 44
    act_gib = ((cfg.mpt.n_layers + cfg.n_xattn) * batch * t_txt * cfg.mpt.d_model * 2
               + cfg.vision.vision.layers * batch * cfg.vision.n_vision_tokens * cfg.vision.vision.width * 2
               ) / 2**30
    total = params_gib + state_gib + act_gib
    if memory_gib is None and device is not None and torch.device(device).type == "cuda":
        memory_gib = torch.cuda.get_device_properties(torch.device(device)).total_memory / 2**30
        source = "torch.cuda.get_device_properties"
    else:
        source = "argument" if memory_gib is not None else None
    out = {
        "metric": "of9b_memory_plan",
        "params_by_component_b": {k: v / 1e9 for k, v in comp.items()},
        "n_params_b": n_params / 1e9,
        "params_gib_bf16": params_gib,
        "attack_state_gib": state_gib,
        "remat_checkpoint_gib": act_gib,
        "single_card_estimate_gib": total,
        "batch": batch,
        "card_memory_gib": memory_gib,
        "card_memory_source": source,
        "card": common.card(),
    }
    if memory_gib is not None:
        fits = total < memory_gib
        out["fits_one_card"] = fits
        out["min_cards_fsdp"] = max(1, math.ceil(total / memory_gib))
        out["verdict"] = (f"params {params_gib:.2f} GiB + state and checkpoints {state_gib + act_gib:.2f} GiB "
                          f"{'fit' if fits else 'do not fit'} in {memory_gib:.2f} GiB; the gathered weights' "
                          f"working set and the activations inside a block come on top")
    return common.emit(out)


def attack_step_matmul_flops(cfg, batch, t_img, frames, t_txt):
    """Matmul FLOPs of one OpenFlamingo APGD step (forward and gradient with
    respect to the PIXELS), 2*M*N*K a product: the JAX package's count
    (`scripts/bench_of9b.py`) over the port's `FlamingoConfig`. Blocks
    under remat: parameter products 3x (forward, dx, replay), the down and
    out projections 2x (their replay is never read), q @ k^T 4x, probs @ v
    3x; the Perceiver and the gated cross-attention blocks run outside
    remat (forward and dx)."""
    in_mult, dn_mult, sc_mult, pv_mult = 3, 2, 4, 3

    v = cfg.vision.vision
    n_tok = cfg.vision.n_vision_tokens          # 257 with CLS
    n_img = n_tok - 1
    w, h = v.width, int(v.width * v.mlp_ratio)
    p = cfg.vision.patch_size
    n_frames = t_img * frames
    vis = 2 * (2 * n_img * (3 * p * p) * w)      # patch embed forward + dx
    vis += in_mult * 2 * n_tok * (4 * w * w + w * h) * v.layers
    vis += dn_mult * 2 * n_tok * (w * h) * v.layers
    vis += (sc_mult + pv_mult) * (2 * n_tok * n_tok * w) * v.layers
    vis *= n_frames

    # Perceiver resampler (outside remat)
    d_vis = w
    inner = cfg.resampler_heads * cfg.resampler_dim_head
    n_lat, n_media = cfg.num_latents, frames * n_img
    n_kv = n_media + n_lat
    per_layer = (
        2 * (2 * n_lat * d_vis * inner)          # to_q
        + 2 * (2 * n_kv * d_vis * (2 * inner))   # to_kv
        + 3 * (2 * n_lat * n_kv * inner) * 2     # scores + probs@v
        + 2 * (2 * n_lat * inner * d_vis)        # to_out
        + 2 * (2 * n_lat * d_vis * (cfg.ff_mult * d_vis)) * 2  # ff w1 + w2
    )
    perceiver = t_img * cfg.resampler_depth * per_layer

    # gated cross-attention blocks (outside remat)
    d = cfg.mpt.d_model
    kv_tok = t_img * n_lat
    per_x = (
        2 * (2 * t_txt * d * inner)              # to_q
        + 2 * (2 * kv_tok * d_vis * (2 * inner))  # to_kv
        + 3 * (2 * t_txt * kv_tok * inner) * 2   # scores + probs@v
        + 2 * (2 * t_txt * inner * d)            # to_out
        + 2 * (2 * t_txt * d * (cfg.ff_mult * d)) * 2  # ff
    )
    xattn = cfg.n_xattn * per_x

    # MPT decoder (remat'd blocks): fused wqkv (d -> 3d), out d -> d, mlp 4x
    lm = in_mult * 2 * t_txt * (3 * d * d + 4 * d * d) * cfg.mpt.n_layers
    lm += dn_mult * 2 * t_txt * (d * d + 4 * d * d) * cfg.mpt.n_layers
    lm += (sc_mult + pv_mult) * (2 * t_txt * t_txt * d) * cfg.mpt.n_layers
    lm += 2 * (2 * t_txt * d * cfg.mpt.vocab_size)  # weight-tied head

    return float(batch) * (vis + perceiver + xattn + lm)


def flops_projection(batch: int = 8, rate_tf_s: float = None, config: str = CONFIG) -> dict:
    """The step's FLOPs for 0-shot captioning and 4-shot few-shot, priced at
    `rate_tf_s` when one is given."""
    from robustvlm_tpu_torch.models.flamingo.model import FLAMINGO_CONFIGS

    cfg = FLAMINGO_CONFIGS[config]
    points = []
    for name, t_img, frames, t_txt in (("caption_0shot", 1, 1, 44), ("fewshot_4shot", 5, 1, 220)):
        f = attack_step_matmul_flops(cfg, batch, t_img, frames, t_txt)
        pt = {"workload": name, "batch": batch, "t_img": t_img, "t_txt": t_txt, "tflop_per_step": f / 1e12}
        if rate_tf_s:
            pt["projected_steps_per_sec"] = rate_tf_s * 1e12 / f
        points.append(pt)
    return common.emit({
        "metric": "of9b_attack_step_projection",
        "label": "PROJECTION: FLOPs priced at a given rate, not a measurement",
        "rate_tf_s": rate_tf_s,
        "points": points,
    })


def shard_plan(mesh=(1, 8, 1), config: str = CONFIG) -> dict:
    """Per-device parameter bytes (bf16) under the port's sharding rules on
    a (data, fsdp, model) mesh shape, and the parameters whose rule named an
    axis that does not divide its dim (replicated on that dim instead)."""
    from robustvlm_tpu_torch.parallel.mesh import _spec_for, param_sharding_rules

    shape = dict(zip(("data", "fsdp", "model"), mesh))
    model = _meta_model(config)
    specs = param_sharding_rules(model, shape)
    per_device = 0.0
    dropped = []
    for name, prm in model.named_parameters():
        spec = specs[name]
        ways = math.prod(shape[a] for a in spec if a is not None)
        per_device += prm.numel() * 2 / ways
        wanted = _spec_for(name, prm.dim())
        if any(a is not None and b is None and shape[a] > 1 for a, b in zip(wanted, spec)):
            dropped.append({"name": name, "shape": list(prm.shape), "rule": list(wanted)})
    total = sum(p.numel() for p in model.parameters()) * 2
    return common.emit({
        "metric": "of9b_shard_plan",
        "mesh": shape,
        "per_device_param_gib": per_device / 2**30,
        "whole_param_gib": total / 2**30,
        "n_dropped": len(dropped),
        "dropped": dropped,
    })


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default; the card's memory) or cpu")
    p.add_argument("--memory_gib", type=float, default=None, help="the card's memory, on the CPU")
    p.add_argument("--rate_tf_s", type=float, default=None, help="price the FLOPs at this rate")
    args = p.parse_args(argv)
    from robustvlm_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    plan(memory_gib=args.memory_gib, device=dev)
    flops_projection(rate_tf_s=args.rate_tf_s)
    shard_plan()
    return 0


if __name__ == "__main__":
    sys.exit(main())
