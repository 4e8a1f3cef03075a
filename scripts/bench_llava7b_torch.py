#!/usr/bin/env python3
"""LLaVA-1.5-7B APGD attack steps per second, batch 1, on one card.

    python3 scripts/bench_llava7b_torch.py [--device cuda]

The reference's one published speed datum is the targeted caption attack
on this workload: "APGD 10,000 iterations on LLaVA-7B fp32 takes about 2
hours per image on an A100" (about 1.4 attack steps/s, the `vs_baseline`
anchor). This script measures the port on it: the per-sample
teacher-forced CE of a 24-token target after a 35-token prompt through the
full LLaVA-1.5-7B (the 336 px ViT-L/14 tower, 576 spliced patch tokens,
LLaMA-7B), weights drawn from seed 0 in bf16 straight on the card
(`models/llava/convert.init_random_state`), `remat=True` on both towers,
driven by `apgd_attack` (l-inf, eps 2/255, 100 iterations,
`skip_last_grad=False`), the gradient taken with respect to the pixels.
The attack maximizes -CE (a targeted attack). It runs the port's
`vit_attention`, `flash_attention` and `fused_linf_apgd_step` kernels.

Knobs (environment): BENCH_BATCH (1), BENCH_ITERS (100). Best of 3 timed
attacks after a warm-up, each ended by a synchronize. Prints one JSON line:
attack steps/s, example steps/s, ms an iteration, peak memory, the card's
name and power limit, the model FLOPs of a step
(`attack_step_matmul_flops(remat=False)`: the forward and the pixel
gradient, without the replay that `remat` adds) and their rate, the rate of
a serially dependent bf16 matmul chain at the LM MLP's shape (CUDA events),
and the port kernels launched in the last timed attack.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import bench_common_torch as common  # noqa: E402

# the reference's published number for this workload
A100_LLAVA7B_STEPS_PER_SEC = 1.4

# vicuna v1.5 prompt lengths: about 35 tokens before the image (system +
# "USER: <image>"), a 24-token teacher-forced target caption after it
T_PRE, T_POST = 35, 24


def attack_step_matmul_flops(cfg, batch, t_pre, t_post, remat=True):
    """Matmul FLOPs of one APGD step on LLaVA (a forward and a gradient with
    respect to the PIXELS of the teacher-forced CE), 2*M*N*K a product;
    the JAX package's count (`scripts/bench_llava7b.py`) over the port's
    `LlavaConfig`, the tower's last block always dropped:

      - weights are not differentiated, so a parameter matmul's backward is
        dx = dy @ W^T alone (1x its forward);
      - attention's two products differentiate both operands (2x);
      - `remat` replays a block's interior in the backward, except the
        products whose outputs no backward op reads (probs @ v and the
        MLP's down projection): +1x for the others and for q @ k^T;
      - the loss reads only the last t_post logit rows, so the LM head
        counts a t_post-row product, forward and dx;
      - outside the blocks (patch embed, projector, LM head): forward + dx.

    Elementwise work, gathers and the attack's bookkeeping are left out."""
    in_mult = 3 if remat else 2   # interior param matmuls whose outputs the backward reads
    dn_mult = 2                   # down-proj / c_proj: a replay is never read
    sc_mult = 4 if remat else 3   # q @ k^T
    pv_mult = 3                   # probs @ v: a replay is never read

    v = cfg.vision.vision
    n_tok = cfg.vision.n_vision_tokens  # CLS included
    n_img = cfg.n_image_tokens  # CLS dropped before the projector
    l_eff = v.layers - 1  # the last block is skipped (penultimate features)
    w, h = v.width, int(v.width * v.mlp_ratio)
    p = cfg.vision.patch_size
    vis = 2 * (2 * n_img * (3 * p * p) * w)  # patch embed, forward + dx
    vis += in_mult * 2 * n_tok * (4 * w * w + w * h) * l_eff  # qkv, out, fc
    vis += dn_mult * 2 * n_tok * (w * h) * l_eff  # c_proj
    vis += (sc_mult + pv_mult) * (2 * n_tok * n_tok * w) * l_eff

    d = cfg.lm_dim
    if cfg.projector_type == "linear":
        proj = 2 * (2 * n_img * w * d)
    else:  # mlp2x_gelu
        proj = 2 * (2 * n_img * w * d + 2 * n_img * d * d)

    lc = cfg.llama
    t = n_img + t_pre + t_post
    kv_dim = lc.n_kv_heads * lc.head_dim  # == d unless GQA
    lm = in_mult * 2 * t * (2 * d * d + 2 * d * kv_dim + 2 * d * lc.ffn_dim) * lc.n_layers
    lm += dn_mult * 2 * t * (d * lc.ffn_dim) * lc.n_layers  # down-proj
    lm += (sc_mult + pv_mult) * (2 * t * t * d) * lc.n_layers
    lm += 2 * (2 * t_post * d * lc.vocab_size)  # lm_head, the target rows

    return float(batch) * (vis + proj + lm)


def _measure_serial_matmul_chain(m, k, n, iters=100, device="cuda"):
    """TFLOP/s of a serially dependent bf16 up/down matmul pair at the
    caller's shapes, (m, k) x (k, n) then (m, n) x (n, k), `iters` times,
    timed with CUDA events after a warm pass. A lower bound of the matmul
    rate: one dependent chain, no independent products beside it."""
    import torch

    a = torch.full((m, k), 1.0, dtype=torch.bfloat16, device=device)
    w1 = torch.full((k, n), 1.0 / k, dtype=torch.bfloat16, device=device)
    w2 = torch.full((n, k), 1.0 / n, dtype=torch.bfloat16, device=device)

    def chain():
        c = a
        for _ in range(iters):
            c = (c @ w1) @ w2
        return c

    chain()
    ms = common.events_ms(chain, device)
    return iters * 2 * (2 * m * k * n) / (ms / 1e3) / 1e12


def _crit_targeted(o, y):
    # o is the per-sample CE of the target; APGD maximizes the criterion,
    # so the targeted attack maximizes -CE
    return -o


def build_model(device, config: str = "llava-1.5-7b", seed: int = 0, dtype=None):
    """The port's LLaVA with random weights drawn on `device` in `dtype`
    (bf16 by default; the projector and 1-D parameters in float32, as
    `half_state` holds them)."""
    import torch

    from robustvlm_tpu_torch.models.llava.convert import init_random_state
    from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS, Llava

    cfg = LLAVA_CONFIGS[config]
    state = init_random_state(cfg, seed=seed, device=device, dtype=dtype or torch.bfloat16)
    return Llava.from_state(cfg, state)


def main(batch=None, n_iter=None, device=None, config: str = "llava-1.5-7b", compute_dtype=None) -> dict:
    """Run the bench and print its JSON line; knobs default from the
    environment (BENCH_BATCH, BENCH_ITERS). `bench_torch.py` passes them."""
    import numpy as np
    import torch

    from robustvlm_tpu_torch.attacks.apgd import apgd_attack
    from robustvlm_tpu_torch.device import resolve_device
    from robustvlm_tpu_torch.models.llava.model import llava_per_sample_loss

    dev = resolve_device(device)
    batch = int(os.environ.get("BENCH_BATCH", 1)) if batch is None else batch
    n_iter = int(os.environ.get("BENCH_ITERS", 100)) if n_iter is None else n_iter
    cd = torch.bfloat16 if compute_dtype is None else compute_dtype

    common.reset_peak(dev)
    model = build_model(dev, config, dtype=cd)
    cfg = model.cfg
    n_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    print(f"params resident: {n_bytes / 2**30:.2f} GiB", file=sys.stderr)

    vocab = cfg.llama.vocab_size
    npr = np.random.RandomState(0)
    s = cfg.vision.image_size
    x = torch.from_numpy(npr.rand(batch, 3, s, s).astype(np.float32)).to(dev)
    pre = torch.from_numpy(npr.randint(3, vocab, (batch, T_PRE))).to(dev)
    post = torch.from_numpy(npr.randint(3, vocab, (batch, T_POST))).to(dev)
    mask = torch.ones(batch, T_POST, device=dev)

    def model_fn(xa):
        return llava_per_sample_loss(model, xa, pre, post, post, mask, compute_dtype=cd, remat=True)

    def attack():
        return apgd_attack(model_fn, x, None, criterion=_crit_targeted, eps=2.0 / 255.0,
                           n_iter=n_iter, norm="linf", skip_last_grad=False)

    t0 = time.perf_counter()
    common.timed_s(attack, dev)
    print(f"first run (kernel build, warm-up): {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    runs = []
    for _ in range(3):
        common.reset_launches()
        res = None

        def run():
            nonlocal res
            res = attack()

        runs.append(common.timed_s(run, dev))
        launched = common.launches()
    best = min(runs)
    linf = float((res.x_best_adv - x).abs().max())
    if not linf <= 2.0 / 255.0 + 1e-6:
        raise AssertionError(f"x_best_adv left the eps-ball: {linf}")

    steps_per_sec = (n_iter + 1) / best
    example_steps = steps_per_sec * batch
    # the untargeted ensemble: about 8 APGD stages x 100 iterations over 500
    # images (the reference's run_evaluation.py stage schedule)
    prod_hours = 500 * 8 * 100 / example_steps / 3600
    model_flops = attack_step_matmul_flops(cfg, batch, T_PRE, T_POST, remat=False)
    out = {
        "metric": f"apgd_attack_steps_per_sec_llava7b_b{batch}",
        "value": steps_per_sec,
        "unit": "attack-steps/s/chip",
        "vs_baseline": example_steps / A100_LLAVA7B_STEPS_PER_SEC,
        "batch": batch,
        "example_steps_per_sec": example_steps,
        "n_iter": n_iter,
        "run_s": runs,
        "ms_per_iter": best / (n_iter + 1) * 1e3,
        "remat": True,
        "peak_mem_gib": common.peak_gib(dev),
        "production_500img_8stage_100iter_hours": prod_hours,
        "a100_anchor_steps_per_sec": A100_LLAVA7B_STEPS_PER_SEC,
        "model_tflop_per_step": model_flops / 1e12,
        "model_tf_s": model_flops * steps_per_sec / 1e12,
        "executed_matmul_tflop_per_step": attack_step_matmul_flops(cfg, batch, T_PRE, T_POST,
                                                                   remat=True) / 1e12,
        "linf_max": linf,
        "card": common.card(),
        "launches": launched,
    }
    t_seq = cfg.n_image_tokens + T_PRE + T_POST
    out["serial_chain_at_lm_mlp_shape_tf_s"] = _measure_serial_matmul_chain(
        batch * t_seq, cfg.lm_dim, cfg.llama.ffn_dim, device=dev)
    return common.emit(out)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=p.parse_args().device)
