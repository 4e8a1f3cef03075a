#!/usr/bin/env python3
"""The port's bench: APGD example steps per second at CLIP ViT-L/14 on one
card, after the auxiliary stages.

    python3 scripts/bench_torch.py [--device cuda]

The headline (`main`) is the hot path of the robust-accuracy eval: the
port's `apgd_attack` (l-inf, eps 2/255, 100 iterations) over the ViT-L/14
tower at batch 8 in bf16, a CE loss against a random 1000-class zero-shot
head at logit scale 100, random weights from seed 0. The tower is held as
the robustbench CLI holds it (`cast_matrices_`: matrices bf16, 1-D
parameters float32), not cast whole. Each timed attack ends in a
synchronize; the best of 3 gives `batch * (n_iter + 1) / s` (the attack
evaluates the model n_iter + 1 times an example). `vs_baseline` divides by
80 example steps/s, the A100 anchor derived from the reference's published
LLaVA-7B attack time scaled by the FLOP ratio of LLaVA-7B to the bare
ViT-L/14. The line carries the card's name and power limit, the rate of
back-to-back bf16 products at the qkv shape 8224 x 1024 x 3072
(`perf_sweep_torch.calibrate_matmul`, CUDA events) and the port kernels the
last timed attack launched. BENCH_FOLD_NORM=1 folds the CLIP normalization
into the patch embedding (`fold_normalization`).

The default run prints the auxiliary lines first and the headline last:
  - `apgd_attack_steps_per_sec_llava7b_b1` (`bench_llava7b_torch.py`;
    BENCH_LLAVA=0 skips it, BENCH_LLAVA_BATCH, BENCH_LLAVA_ITERS);
  - `fare_train_imgs_per_sec_per_chip_vitl14` (`main_train`: FARE, l2 outer
    and inner loss, PGD-10 at eps 4/255, AdamW, bf16, `remat`, batch
    BENCH_TRAIN_BATCH (128) in BENCH_TRAIN_ACCUM (16) chunks, BENCH_TRAIN_STEPS
    (8) timed steps after one; `vs_baseline` against 6.7 imgs/s, derived from
    the same A100 anchor);
  - `llava7b_greedy_decode_tokens_per_sec` three times
    (`bench_decode_torch.py`): int8 weights at batch 1 and 4, int4 at 1 and
    4, int8 weights with the int8 KV cache at 8 (BENCH_DECODE=0 skips them,
    BENCH_DECODE_NEW new tokens, 128).
BENCH_TRAIN=1 or BENCH_ATTACK_ONLY=1 runs that stage alone.

No failure hides: a stage that raises prints its line with `"value":
null` and the error, the later stages still run, the device memory is
released between stages (`_release_device_memory`), and the script exits
1. BENCH_WATCHDOG_S (3000) bounds the whole run: past it the watchdog
prints the headline's error line and exits 3.
"""

from __future__ import annotations

import argparse
import copy
import gc
import os
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import bench_common_torch as common  # noqa: E402

HEADLINE = "apgd_attack_steps_per_sec_per_chip_vitl14"
A100_ANCHOR_STEPS_PER_SEC = 80.0
# FARE: about 11.9 attack-evaluation equivalents an image a step (10 inner
# forward + pixel-backward passes, the frozen and two outer forwards, one
# weight backward) at the A100 anchor's 80 evaluations/s
A100_ANCHOR_FARE_IMGS_PER_SEC = 6.7

BATCH = int(os.environ.get("BENCH_BATCH", 8))
# the production eval's 100 iterations (AutoAttack APGD-CE / APGD-T)
N_ITER = int(os.environ.get("BENCH_ITERS", 100))
EPS = 2.0 / 255.0

# stages that raised, by metric name; non-empty -> exit 1
FAILED: list = []


def _device(device):
    from robustvlm_tpu_torch.device import resolve_device

    return resolve_device(device)


def main(device=None, batch: int = None, n_iter: int = None, model_name: str = "ViT-L-14",
         fold_norm: bool = None, runs: int = 3, calib: bool = None) -> dict:
    """The headline stage; prints and returns its JSON line (with
    `linf_max`, the l-inf distance of x_best_adv from x, checked against
    eps before the line is printed)."""
    import numpy as np
    import torch

    from robustvlm_tpu_torch.attacks.apgd import apgd_attack
    from robustvlm_tpu_torch.eval.classifier import make_zero_shot_classifier
    from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS
    from robustvlm_tpu_torch.models.clip.model import cast_matrices_, fold_normalization
    from robustvlm_tpu_torch.ops.losses import ce_loss

    dev = _device(device)
    batch = BATCH if batch is None else batch
    n_iter = N_ITER if n_iter is None else n_iter
    fold_norm = bool(os.environ.get("BENCH_FOLD_NORM")) if fold_norm is None else fold_norm
    skip = os.environ.get("BENCH_SKIP_LAST_GRAD")
    skip_last_grad = None if skip is None else skip == "1"

    cfg = CLIP_CONFIGS[model_name]
    model = CLIP(cfg, device=dev).init_random_(0)
    if fold_norm:
        fold_normalization(model.visual)
    # the CLI's bf16 layout: matrices in bf16, 1-D parameters in float32
    cast_matrices_(model, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)
    temb = torch.randn(cfg.embed_dim, 1000, generator=gen, device=dev)
    temb = temb / temb.norm(dim=0, keepdim=True)
    if fold_norm:
        def logits_fn(xa):  # the folded tower takes raw [0,1] pixels
            return model.encode_image(xa, normalize=True, compute_dtype=torch.bfloat16) @ (100.0 * temb)
    else:
        logits_fn = make_zero_shot_classifier(model, temb, compute_dtype=torch.bfloat16)
    npr = np.random.RandomState(0)
    s = cfg.image_size
    x = torch.from_numpy(npr.rand(batch, 3, s, s).astype(np.float32)).to(dev)
    y = torch.from_numpy(npr.randint(0, 1000, batch)).to(dev)

    def criterion(o, t):
        return ce_loss(o, t, reduction="none")

    result = {}

    def attack(iters):
        result["res"] = apgd_attack(logits_fn, x, y, criterion=criterion, eps=EPS, n_iter=iters,
                                    norm="linf", skip_last_grad=skip_last_grad)

    common.timed_s(lambda: attack(3), dev)  # warm-up: kernel build, allocator, cuBLAS heuristics
    common.reset_peak(dev)
    run_s = []
    for _ in range(runs):
        common.reset_launches()
        run_s.append(common.timed_s(lambda: attack(n_iter), dev))
        launched = common.launches()
    linf = float((result["res"].x_best_adv - x).abs().max())
    if not linf <= EPS + 1e-6:
        raise AssertionError(f"x_best_adv left the eps-ball: {linf} > {EPS}")
    best = min(run_s)
    value = batch * (n_iter + 1) / best
    line = {
        "metric": HEADLINE,
        "value": value,
        "unit": "example-steps/s/chip",
        "vs_baseline": value / A100_ANCHOR_STEPS_PER_SEC,
        "model": model_name,
        "batch": batch,
        "n_iter": n_iter,
        "fold_norm": fold_norm,
        "layout": "cast_matrices_ (bf16 matrices, float32 1-D parameters)",
        "run_s": run_s,
        "ms_per_iter": best / n_iter * 1e3,
        "peak_mem_gib": common.peak_gib(dev),
        "linf_max": linf,
        "card": common.card(),
        "launches": launched,
    }
    if dev.type == "cuda" if calib is None else calib:
        from perf_sweep_torch import calibrate_matmul

        line["matmul_calibration_tf_s"] = calibrate_matmul(dev)
        line["matmul_calibration_shape"] = [32 * 257, 1024, 3072]
    return common.emit(line)


def main_train(device=None, batch: int = None, accum: int = None, n_steps: int = None,
               model_name: str = "ViT-L-14") -> dict:
    """FARE fine-tuning images/s: `TrainStep` with the l2 outer and inner
    losses, PGD-10 at eps 4/255 (step 1/255), AdamW, bf16 compute over
    float32 weights, `remat`, `grad_accum` chunks; one step to warm up, then
    n_steps timed together, ended by a synchronize."""
    import numpy as np
    import torch

    from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS
    from robustvlm_tpu_torch.train.trainer import TrainConfig, TrainStep

    dev = _device(device)
    batch = int(os.environ.get("BENCH_TRAIN_BATCH", 128)) if batch is None else batch
    accum = int(os.environ.get("BENCH_TRAIN_ACCUM", 16)) if accum is None else accum
    n_steps = int(os.environ.get("BENCH_TRAIN_STEPS", 8)) if n_steps is None else n_steps
    tcfg = TrainConfig(loss="l2", inner_loss="l2", attack="pgd", eps=4.0 / 255.0, iterations_adv=10,
                       stepsize_adv=1.0 / 255.0, opt="adamw", compute_dtype="bfloat16", remat=True,
                       grad_accum=accum)
    cfg = CLIP_CONFIGS[model_name]
    model = CLIP(cfg, device=dev).init_random_(0)
    step = TrainStep(tcfg, model, copy.deepcopy(model))
    npr = np.random.RandomState(0)
    s = cfg.image_size
    x = torch.from_numpy(npr.rand(batch, 3, s, s).astype(np.float32)).to(dev)

    metrics = {}

    def run(first, n):
        for i in range(first, first + n):
            metrics.update(step(x, None, i))

    common.timed_s(lambda: run(0, 1), dev)  # warm-up step
    common.reset_peak(dev)
    common.reset_launches()
    dt = common.timed_s(lambda: run(1, n_steps), dev)
    launched = common.launches()
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"FARE loss is not finite: {loss}")
    value = batch * n_steps / dt
    return common.emit({
        "metric": "fare_train_imgs_per_sec_per_chip_vitl14",
        "value": value,
        "unit": "imgs/s/chip",
        "vs_baseline": value / A100_ANCHOR_FARE_IMGS_PER_SEC,
        "model": model_name,
        "batch": batch,
        "grad_accum": accum,
        "steps": n_steps,
        "s_per_step": dt / n_steps,
        "loss": loss,
        "peak_mem_gib": common.peak_gib(dev),
        "card": common.card(),
        "launches": launched,
    })


def main_llava(device=None) -> dict:
    """The LLaVA-1.5-7B attack stage (`bench_llava7b_torch.main`) at
    BENCH_LLAVA_BATCH (1) and BENCH_LLAVA_ITERS (100)."""
    import bench_llava7b_torch

    return bench_llava7b_torch.main(batch=int(os.environ.get("BENCH_LLAVA_BATCH", 1)),
                                    n_iter=int(os.environ.get("BENCH_LLAVA_ITERS", 100)),
                                    device=device)


def main_decode(bits: int, batches, kv_bits: int = 0, device=None) -> dict:
    """One serving decode stage (`bench_decode_torch.main`): a fresh 7B
    build at this weight width, BENCH_DECODE_NEW (128) new tokens."""
    import bench_decode_torch

    return bench_decode_torch.main(batches=batches, max_new=int(os.environ.get("BENCH_DECODE_NEW", 128)),
                                   bits=bits, kv_bits=kv_bits, device=device)


def _release_device_memory() -> None:
    """Free what a finished stage left: the port's attacks keep no cache of
    their own (eager PyTorch), so a collection drops the stage's last
    references (reference cycles included) and the caching allocator gives
    its blocks back."""
    import torch

    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _stage(name: str, fn) -> None:
    """Run one stage. If it raises, print its line with `"value": null` and
    the error and remember it (the script then exits 1); the next stages
    run either way, after the device memory is released."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - reported as the stage's line, never swallowed
        FAILED.append(name)
        common.emit({"metric": name, "value": None, "unit": None,
                     "error": f"stage failed: {type(e).__name__}: {e!s:.500}"})
    finally:
        _release_device_memory()


def _watchdog(seconds: float) -> threading.Timer:
    """After `seconds`, print the headline's error line and exit 3 (a plain
    timeout: a hung run is reported, not waited for)."""
    def fire():
        common.emit({"metric": HEADLINE, "value": None, "unit": "example-steps/s/chip",
                     "error": f"no measurement within {seconds:.0f}s (BENCH_WATCHDOG_S)"})
        os._exit(3)

    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()
    return t


def run_all(device=None) -> int:
    """Every stage in order, the headline last; returns the exit code."""
    FAILED.clear()
    if os.environ.get("BENCH_TRAIN"):
        _stage("fare_train_imgs_per_sec_per_chip_vitl14", lambda: main_train(device))
    elif os.environ.get("BENCH_ATTACK_ONLY"):
        _stage(HEADLINE, lambda: main(device))
    else:
        if os.environ.get("BENCH_LLAVA", "1") != "0":
            _stage("apgd_attack_steps_per_sec_llava7b_b1", lambda: main_llava(device))
        _stage("fare_train_imgs_per_sec_per_chip_vitl14", lambda: main_train(device))
        if os.environ.get("BENCH_DECODE", "1") != "0":
            # int8 and int4 at batch 1 and 4, then int8 weights with the int8
            # KV cache at batch 8 (the JAX bench's serving stages)
            _stage("llava7b_greedy_decode_tokens_per_sec", lambda: main_decode(8, [1, 4], device=device))
            _stage("llava7b_greedy_decode_tokens_per_sec", lambda: main_decode(4, [1, 4], device=device))
            _stage("llava7b_greedy_decode_tokens_per_sec",
                   lambda: main_decode(8, [8], kv_bits=8, device=device))
        _stage(HEADLINE, lambda: main(device))
    return 1 if FAILED else 0


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    _device(args.device)  # no GPU and no --device cpu: raise before any stage
    wd_s = float(os.environ.get("BENCH_WATCHDOG_S", 3000))
    wd = _watchdog(wd_s) if wd_s > 0 else None
    t0 = time.perf_counter()
    rc = run_all(args.device)
    if wd is not None:
        wd.cancel()
    print(f"bench_torch: {time.perf_counter() - t0:.1f}s, failed stages: {FAILED}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(cli())
