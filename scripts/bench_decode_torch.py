#!/usr/bin/env python3
"""LLaVA-1.5-7B greedy decode tokens per second on one card, by batch.

    python3 scripts/bench_decode_torch.py [--device cuda]

Times the port's generation path, `models/generation.greedy_generate` over
`models/llava/model.make_llava_decode_fns` (the tower and the splice once,
then one cached LM step a token), through a full-size LLaVA-1.5-7B with
random bf16 weights drawn on the card (decode speed does not depend on the
weights' values). The prompt is 35 system tokens + 576 image tokens + 12
question tokens; each run generates BENCH_DECODE_NEW (128) new tokens and
never stops early (EOS id -1). Weight widths go through
`LlavaEvalModel.quantize_for_serving` (in place, leaf by leaf): bf16, int8
(per-channel) or packed int4 with group-128 scales, whose products run the
port's `q4_matmul` kernel; BENCH_DECODE_KVQ=1 adds the int8 KV cache.

A decode step at batch 1 reads every LM weight once, so the floor is the
step's bytes (`_decode_step_bytes`) over the card's memory rate; the rate
is measured here as a device-to-device copy timed with CUDA events
(`_measure_copy_bandwidth_gb_s`), a conservative floor of the read rate.

Knobs (environment): BENCH_DECODE_BATCHES (1,2,4), BENCH_DECODE_NEW (128),
BENCH_DECODE_Q8=1 / BENCH_DECODE_Q4=1 (weight width), BENCH_DECODE_KVQ=1.
Prints one JSON line a batch point (best of 3 full generations and of 3
prefills, each ended by a synchronize) and a summary line last, with the
port kernels launched. A batch point that fails prints its error, the
others still run, and the summary then raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import bench_common_torch as common  # noqa: E402

# vicuna v1.5 serving prompt: about 35 system tokens before <image>, a
# short question after it
T_PRE = 35
T_QUESTION = 12


def _measure_copy_bandwidth_gb_s(gib: float = 2.0, iters: int = 20, device="cuda") -> float:
    """GB/s of a device-to-device copy of a `gib`-sized bf16 buffer, which
    moves twice its bytes (read + write), `iters` copies timed with CUDA
    events after a warm one."""
    import torch

    n = int(gib * 2**30 / 2)
    src = torch.zeros(n, dtype=torch.bfloat16, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    ms = common.events_ms(lambda: dst.copy_(src), device, iters=iters)
    return 2 * (n * 2) * iters / (ms / 1e3) / 1e9


def _decode_step_bytes(cfg, t_avg: int, *, weight_bytes: float = 2.0, kv_bytes: float = 2.0) -> float:
    """Bytes one decode step must move: every LM weight (read each token;
    `weight_bytes` an element: 2.0 bf16, 1.0 int8) and the KV cache at an
    average occupancy of t_avg (`kv_bytes` an element: 2.0 bf16, 1 + 4 /
    head_dim int8 with its scales). The weight term does not depend on the
    batch."""
    lcfg = cfg.llama
    per_layer = (
        4 * lcfg.dim * lcfg.dim          # wq wk wv wo
        + 3 * lcfg.dim * lcfg.ffn_dim    # gate up down
    )
    weights = lcfg.n_layers * per_layer + lcfg.dim * lcfg.vocab_size
    kv = lcfg.n_layers * 2 * lcfg.n_kv_heads * lcfg.head_dim * t_avg
    return weight_bytes * weights + kv_bytes * kv


def decode_inputs(cfg, batch: int, device, seed: int = 0):
    """(pixels (B, 3, S, S), pre (B, T_PRE), question (B, T_QUESTION),
    n_pad (B,)) from a seed, token ids in [3, vocab)."""
    import numpy as np
    import torch

    npr = np.random.RandomState(seed)
    s = cfg.vision.image_size
    vocab = cfg.llama.vocab_size
    pixels = torch.from_numpy(npr.rand(batch, 3, s, s).astype(np.float32)).to(device)
    pre = torch.from_numpy(npr.randint(3, vocab, (batch, T_PRE))).to(device)
    question = torch.from_numpy(npr.randint(3, vocab, (batch, T_QUESTION))).to(device)
    return pixels, pre, question, torch.zeros(batch, dtype=torch.long, device=device)


def generate(model, inputs, max_new: int, *, kv_bits: int = 0, compute_dtype=None):
    """The timed path: decode functions (the tower runs here) and
    `greedy_generate` of max_new tokens -> (B, max_new) token ids."""
    import torch

    from robustvlm_tpu_torch.models.generation import greedy_generate
    from robustvlm_tpu_torch.models.llava.model import make_llava_decode_fns

    pixels, pre, question, n_pad = inputs
    with torch.no_grad():
        pf, df = make_llava_decode_fns(model, pixels, pre, max_total_len=T_QUESTION + max_new,
                                       compute_dtype=compute_dtype or torch.bfloat16, kv_bits=kv_bits)
        # EOS id -1 is never the argmax: every row decodes all max_new tokens
        return greedy_generate(pf, df, question, n_pad, max_new_tokens=max_new, eos_id=-1).tokens


def prefill_only(model, inputs, max_new: int, *, kv_bits: int = 0, compute_dtype=None):
    """The tower, the splice and the prompt's prefill of `generate`."""
    import torch

    from robustvlm_tpu_torch.models.llava.model import make_llava_decode_fns

    pixels, pre, question, _ = inputs
    b = question.shape[0]
    with torch.no_grad():
        pf, _ = make_llava_decode_fns(model, pixels, pre, max_total_len=T_QUESTION + max_new,
                                      compute_dtype=compute_dtype or torch.bfloat16, kv_bits=kv_bits)
        kv_valid = torch.ones(b, T_QUESTION, dtype=torch.bool, device=question.device)
        positions = torch.arange(T_QUESTION, device=question.device)[None].expand(b, T_QUESTION)
        logits, _ = pf(question, kv_valid, positions)
    return logits


def run_one(model, batch: int, max_new: int, *, kv_bits: int = 0, device=None, compute_dtype=None) -> dict:
    """One batch point: a warm-up generation, then best of 3 generations
    and best of 3 prefills; prints and returns its JSON line."""
    dev = device if device is not None else model.device
    inputs = decode_inputs(model.cfg, batch, dev)
    kw = {"kv_bits": kv_bits, "compute_dtype": compute_dtype}
    common.reset_peak(dev)
    t0 = time.perf_counter()
    common.timed_s(lambda: generate(model, inputs, max_new, **kw), dev)
    print(f"b{batch} first run: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    t_full = []
    for _ in range(3):
        common.reset_launches()
        t_full.append(common.timed_s(lambda: generate(model, inputs, max_new, **kw), dev))
        launched = common.launches()
    t_prefill = min(common.timed_s(lambda: prefill_only(model, inputs, max_new, **kw), dev)
                    for _ in range(3))
    best = min(t_full)
    out = {
        "metric": "llava7b_greedy_decode",
        "value": batch * max_new / best,
        "unit": "tokens/s/chip",
        "batch": batch,
        "max_new_tokens": max_new,
        "tokens_per_sec": batch * max_new / best,
        "tokens_per_sec_decode_only": batch * max_new / max(best - t_prefill, 1e-9),
        "generate_s": t_full,
        "prefill_s": t_prefill,
        "decode_step_ms": (best - t_prefill) / max_new * 1e3,
        "peak_mem_gib": common.peak_gib(dev),
        "launches": launched,
    }
    return common.emit(out)


def build_serving_model(bits: int, device, config: str = "llava-1.5-7b", compute_dtype=None):
    """The eval adapter over the port's LLaVA (random weights drawn on the
    card in bf16), quantized in place for serving when bits is 8 or 4."""
    import torch

    from bench_llava7b_torch import build_model
    from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel, WordTokenizer

    cd = compute_dtype or torch.bfloat16
    model = build_model(device, config, dtype=cd)
    adapter = LlavaEvalModel(model, WordTokenizer(model.cfg.llama.vocab_size), compute_dtype=cd)
    if bits:
        adapter.quantize_for_serving(bits)
    return adapter


def main(batches=None, max_new=None, bits=None, kv_bits=None, device=None, config: str = "llava-1.5-7b",
         compute_dtype=None) -> dict:
    """Arguments override the BENCH_DECODE_* environment (`bench_torch.py`
    calls this with an explicit sweep)."""
    from robustvlm_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if batches is None:
        batches = [int(b) for b in os.environ.get("BENCH_DECODE_BATCHES", "1,2,4").split(",")]
    if max_new is None:
        max_new = int(os.environ.get("BENCH_DECODE_NEW", 128))
    if bits is None:
        bits = 4 if os.environ.get("BENCH_DECODE_Q4") == "1" else 8 if os.environ.get("BENCH_DECODE_Q8") == "1" else 0
    if kv_bits is None:
        kv_bits = 8 if os.environ.get("BENCH_DECODE_KVQ") == "1" else 0

    adapter = build_serving_model(bits, dev, config, compute_dtype)
    model, cfg = adapter.model, adapter.cfg
    n_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    print(f"params resident: {n_bytes / 2**30:.2f} GiB" + (f" (int{bits} LM)" if bits else " bf16"),
          file=sys.stderr)

    points, failed = [], []
    for b in batches:
        try:
            points.append(run_one(model, b, max_new, kv_bits=kv_bits, device=dev,
                                  compute_dtype=adapter.compute_dtype))
        except Exception as e:  # noqa: BLE001 - reported, then raised after the sweep
            failed.append(b)
            points.append(common.emit({"metric": "llava7b_greedy_decode", "value": None, "batch": b,
                                       "error": f"{type(e).__name__}: {e!s:.400}"}))
    fits = [p for p in points if "error" not in p]
    best = max(fits, key=lambda p: p["tokens_per_sec"]) if fits else None
    bw = _measure_copy_bandwidth_gb_s(device=dev) if dev.type == "cuda" else None
    t_avg = T_PRE + cfg.n_image_tokens + T_QUESTION + max_new // 2
    # bytes an element of the weight stream: int8 1, int4 0.5 packed + a
    # float32 scale a 128-row group
    wb = {0: 2.0, 8: 1.0, 4: 0.5 + 4.0 / 128}[bits]
    kb = (1.0 + 4.0 / cfg.llama.head_dim) if kv_bits else 2.0
    step_gb = _decode_step_bytes(cfg, t_avg, weight_bytes=wb, kv_bytes=kb) / 1e9
    b1 = next((p for p in fits if p["batch"] == 1), None)
    launched = {}
    for p in fits:
        for k, v in p["launches"].items():
            launched[k] = launched.get(k, 0) + v
    summary = common.emit({
        "metric": "llava7b_greedy_decode_tokens_per_sec",
        "value": best["tokens_per_sec"] if best and not failed else None,
        "unit": "tokens/s/chip",
        "weights": f"int{bits}" if bits else "bf16",
        "kv_cache": "int8" if kv_bits else "bf16",
        "best_batch": best["batch"] if best else None,
        "sweep": points,
        "roofline": {
            "weights_plus_kv_gb_per_step": step_gb,
            "measured_copy_bandwidth_gb_s": bw,
            "copy_floor_steps_per_sec": bw / step_gb if bw else None,
            "effective_read_gb_s_at_b1": step_gb / (b1["decode_step_ms"] / 1e3) if b1 else None,
        },
        "card": common.card(),
        "launches": launched,
    })
    if failed:
        raise RuntimeError(f"decode batch points failed: {failed}")
    return summary


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=p.parse_args().device)
