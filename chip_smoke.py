#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (robustvlm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:
  1. build    - nvcc builds every kernel of csrc/, one process per source;
  2. kernels  - each kernel against its plain PyTorch version on the card,
                at the main paths' shapes, with times and bounds; planted
                faults show that the attention checks can fail;
  3. reference - ViT-B/32 logits and pixel gradient through the kernels
                on the card against the plain path on the CPU;
  4. main     - `robustbench.main` (the CLI entry point) at CLIP ViT-L/14
                full width: zero-shot classifier and AutoAttack at 100
                iterations, in float32 (APGD-CE + APGD-T) and in bfloat16
                (APGD-T), with each kernel's launch count read around each run;
  5. timed    - `apgd_attack` at ViT-L/14 in bfloat16, batch 8, 100
                iterations: APGD example-steps/s;
  6. llava_reference - LLaVA-1.5-7B widths cut to 2 LM and 2 vision layers,
                float32: the per-sample loss and pixel gradient through the
                kernels on the card against the plain path on the CPU;
  7. llava    - `run_evaluation.main` (the VLM eval CLI) at LLaVA-1.5-7B full
                width, bf16, 100 APGD iterations on 2 COCO-format images
                written under chiprun_out/, captions and CIDEr, with each
                kernel's launches, ms per APGD iteration and peak memory;
  8. llava_ensemble - the CLI's ensemble schedule at LLaVA-1.5-7B full width
                with both precisions' models held together, every stage
                run (its last in float32), with peak memory, the float32
                stage's launches and the ms of one float32 loss and gradient.
Then the `kernels` JSON line, the card's name and power limit as nvidia-smi
reports them, and last the device line. Without CUDA, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# Published peaks (NVIDIA data sheets, dense): memory bytes/s, float32 on the
# CUDA cores and bf16 on the tensor cores, FLOP/s. The SXM part unless the
# card's name says PCIe.
PEAKS = {
    "sxm": {"bytes": 3.35e12, "float32": 67e12, "bfloat16": 989e12},
    "pcie": {"bytes": 2.0e12, "float32": 51e12, "bfloat16": 756e12},
}

LINF_SHAPE = (8, 3 * 224 * 224)       # APGD batch 8 at 224 px
ATTN_BH = 8 * 16                      # batch 8 x 16 heads (ViT-L/14)
ATTN_NS = (50, 257, 577)              # ViT-B/32, ViT-L/14, ViT-L/14-336
ATTN_D = 64
# Attention against its plain version, per output tensor: float32 within
# 1e-5 abs; bf16 within 2e-2 of the reference's largest magnitude; lse is
# float32 in both dtypes and held to 1e-5 abs + 1e-6 of its value.
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LSE_TOL = (1e-5, 1e-6)  # (atol, rtol)
ATTN_OUTPUTS = ("o", "lse", "dq", "dk", "dv")


def emit(obj) -> None:
    """Print one JSON line, and keep it in chiprun_out/chip_smoke.jsonl."""
    line = json.dumps(obj)
    print(line, flush=True)
    OUT.mkdir(exist_ok=True)
    with open(OUT / "chip_smoke.jsonl", "a") as f:
        f.write(line + "\n")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def peaks_for(name: str) -> dict:
    return PEAKS["pcie" if "PCIe" in name else "sxm"]


def bound_ms(n_bytes: float, n_ops: float, dtype: str, peaks: dict):
    t_bytes = n_bytes / peaks["bytes"] * 1e3
    t_ops = n_ops / peaks[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 1
def phase_build() -> None:
    from robustvlm_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    secs = _build.build_all()
    logs = "\n".join(f"== {k}\n{v}" for k, v in _build.BUILD_LOGS.items())
    (OUT / "kernel_build.log").write_text(logs)
    spills = [ln.strip() for ln in logs.splitlines() if "spill" in ln and not " 0 bytes spill stores" in ln]
    emit({"phase": "build", "ok": True, "seconds": round(time.perf_counter() - t0, 3),
          "per_source_s": {k: round(v, 3) for k, v in secs.items()},
          "nonzero_spill_lines": spills[:8]})


# ------------------------------------------------------------------ phase 2
def _bits_equal(a, b) -> bool:
    """Bitwise equality of float32 tensors; NaNs must sit at the same
    positions (their payload bits are not compared)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    return torch.equal(a.view(torch.int32)[~na], b.view(torch.int32)[~nb])


def check_linf_step(peaks: dict) -> dict:
    import torch

    from robustvlm_tpu_torch.ops.kernels import attack_step as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, f = LINF_SHAPE
    eps = 2.0 / 255.0
    x = torch.rand(b, f, generator=gen, device=dev)
    x_adv = (x + (torch.rand(b, f, generator=gen, device=dev) * 2 - 1) * eps).clamp(0, 1)
    x_old = (x + (torch.rand(b, f, generator=gen, device=dev) * 2 - 1) * eps).clamp(0, 1)
    grad = torch.randn(b, f, generator=gen, device=dev)
    step = torch.full((b,), 2 * eps, device=dev)
    step[1::2] = eps  # halved steps on some rows, as after a checkpoint
    ok, err = True, 0.0
    # edge cases: zero, -0.0 and NaN gradients, x at 0 and 1, odd F (scalar path)
    xe, xae, xoe, ge = (t[:, :1001].clone() for t in (x, x_adv, x_old, grad))
    xe[:, :50], xe[:, 50:100] = 0.0, 1.0
    ge[:, 100:150], ge[:, 150:200], ge[:, 200:250] = 0.0, -0.0, float("nan")
    for args in ((x_adv, x_old, grad, x), (xae, xoe, ge, xe)):
        for a in (1.0, 0.75):
            got = K.linf_step_cuda(*args, step, eps, a)
            ref = K.linf_step_plain(*args, step, eps, a)
            ok &= _bits_equal(got, ref)
            both = ~(torch.isnan(got) | torch.isnan(ref))
            err = max(err, float((got - ref)[both].abs().max()))
    torch.cuda.synchronize()
    if not ok:
        raise AssertionError("linf_step kernel is not bitwise equal to its plain version")
    ms = time_ms(lambda: K.linf_step_cuda(x_adv, x_old, grad, x, step, eps, 0.75), iters=200)
    plain_ms = time_ms(lambda: K.linf_step_plain(x_adv, x_old, grad, x, step, eps, 0.75), iters=50)
    n_bytes = 5 * b * f * 4 + b * 4
    bnd, by = bound_ms(n_bytes, 12 * b * f, "float32", peaks)
    return {"name": "linf_step", "route": "cuda",
            "source": "robustvlm_tpu_torch/csrc/attack_step.cu",
            "replaces": "robustvlm_tpu/ops/pallas/attack_step.py:71",
            "dtype": "float32", "shape": [b, f], "bitwise_equal": True,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": None}


def _qkv(n: int, dtype, seed: int, extreme: bool = False):
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (ATTN_BH, n, ATTN_D)
    if extreme:  # every scaled score is -800: far below exp's underflow point
        q = torch.full(shape, 10.0, device=dev)
        k = torch.full(shape, -10.0, device=dev)
    else:
        q = torch.randn(shape, generator=gen, device=dev) * 0.5
        k = torch.randn(shape, generator=gen, device=dev) * 0.5
    v = torch.randn(shape, generator=gen, device=dev) * 0.5
    do = torch.randn(shape, generator=gen, device=dev)
    return [t.to(dtype).contiguous() for t in (q, k, v, do)]


def _attn_check(dname: str, got, ref, extreme: bool) -> dict:
    """(o, lse, dq, dk, dv) of the kernels against the plain version's:
    {output: (max abs error, within its limit)}."""
    import torch

    res = {}
    for name, g, r in zip(ATTN_OUTPUTS, got, ref):
        g, r = g.float(), r.float()
        if not bool(torch.isfinite(g).all()):
            res[name] = (math.inf, False)
            continue
        diff = (g - r).abs()
        err = float(diff.max())
        if name == "lse":
            ok = bool((diff <= LSE_TOL[0] + LSE_TOL[1] * r.abs()).all())
        elif dname == "float32":
            ok = err <= ATTN_TOL[dname]
        else:
            # In the extreme case K is constant, so the exact dQ is 0 (each row
            # of dS sums to 0) and both dQs are bf16 rounding noise; dQ takes
            # the limit of dK, the same dS against Q, an operand of K's size.
            scale = ref[3] if (extreme and name == "dq") else r
            ok = err <= ATTN_TOL[dname] * float(scale.float().abs().max())
        res[name] = (err, ok)
    return res


def _attn_controls(dname: str, q, k, v, do, got, ref) -> dict:
    """Planted faults that the check must catch, on the kernels' outputs:
    lse shifted by 0.05, dQ off by 20%, and a backward without the delta =
    rowsum(dO * O) term (the plain backward given O = 0)."""
    import torch

    from robustvlm_tpu_torch.ops.kernels import vit_attention as A

    o, lse, dq, dk, dv = got
    no_delta = A.attention_bwd_plain(q, k, v, torch.zeros_like(ref[0]), ref[1], do)
    faults = {
        "lse_plus_0.05": (o, lse + 0.05, dq, dk, dv),
        "dq_times_1.2": (o, lse, dq * 1.2, dk, dv),
        "bwd_without_delta": (o, lse, *no_delta),
    }
    return {name: not all(ok for _, ok in _attn_check(dname, f, ref, False).values())
            for name, f in faults.items()}


def check_attention(peaks: dict) -> list:
    import torch
    import torch.nn.functional as F

    from robustvlm_tpu_torch.ops.kernels import vit_attention as A

    results = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        worst = {"fwd": 0.0, "bwd": 0.0}
        cases = [(n, False) for n in ATTN_NS] + [(257, True)]
        for n, extreme in cases:
            q, k, v, do = _qkv(n, dtype, seed=n, extreme=extreme)
            o, lse = A.attention_fwd_cuda(q, k, v)
            got = (o, lse, *A.attention_bwd_cuda(q, k, v, o, lse, do))
            # the plain backward takes the plain forward's residuals, so a
            # wrong O or lse from the kernel shows in the gradients too
            o_ref, lse_ref = A.attention_fwd_plain(q, k, v)
            ref = (o_ref, lse_ref, *A.attention_bwd_plain(q, k, v, o_ref, lse_ref, do))
            res = _attn_check(dname, got, ref, extreme)
            ok = all(r[1] for r in res.values())
            line = {"phase": "kernels", "kernel": "vit_attention", "dtype": dname,
                    "n": n, "extreme": extreme,
                    "max_abs_err": {name: e for name, (e, _) in res.items()},
                    "within": {name: w for name, (_, w) in res.items()},
                    "tol": {"outputs": ATTN_TOL[dname], "relative_to_max_ref": dname != "float32",
                            "lse": LSE_TOL}, "ok": ok}
            if n == 257 and not extreme:
                line["controls_caught"] = _attn_controls(dname, q, k, v, do, got, ref)
                ok = ok and all(line["controls_caught"].values())
            emit(line)
            if not ok:
                raise AssertionError(f"vit_attention {dname} n={n} extreme={extreme}: "
                                     "disagrees, or a planted fault passed the check")
            worst["fwd"] = max(worst["fwd"], res["o"][0])
            worst["bwd"] = max(worst["bwd"], res["dq"][0], res["dk"][0], res["dv"][0])

        # times at the main path's shape: ViT-L/14, batch 8
        n = 257
        q, k, v, do = _qkv(n, dtype, seed=1)
        o, lse = A.attention_fwd_cuda(q, k, v)
        fwd_ms = time_ms(lambda: A.attention_fwd_cuda(q, k, v))
        fwd_plain = time_ms(lambda: A.attention_fwd_plain(q, k, v))
        bwd_ms = time_ms(lambda: A.attention_bwd_cuda(q, k, v, o, lse, do))
        bwd_plain = time_ms(lambda: A.attention_bwd_plain(q, k, v, o, lse, do))
        q4, k4, v4 = (t.view(8, 16, n, ATTN_D) for t in (q, k, v))
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
        out = F.scaled_dot_product_attention(ql, kl, vl)
        do4 = do.view(8, 16, n, ATTN_D)
        lib_bwd = time_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), do4, retain_graph=True))
        itm = q.element_size()
        elems = ATTN_BH * n * ATTN_D
        fb, fby = bound_ms(4 * elems * itm + ATTN_BH * n * 4, 4 * ATTN_BH * n * n * ATTN_D, dname, peaks)
        bb, bby = bound_ms(8 * elems * itm + ATTN_BH * n * 4, 10 * ATTN_BH * n * n * ATTN_D, dname, peaks)
        common = {"route": "cuda", "source": "robustvlm_tpu_torch/csrc/vit_attention.cu",
                  "dtype": dname, "shape": [ATTN_BH, n, ATTN_D]}
        results.append({"name": f"vit_attention_fwd[{dname}]", **common,
                        "replaces": "robustvlm_tpu/ops/pallas/vit_attention.py:157",
                        "max_abs_err": worst["fwd"], "ms": fwd_ms, "plain_ms": fwd_plain,
                        "bound_ms": fb, "bound_by": fby, "library_ms": lib_fwd})
        results.append({"name": f"vit_attention_bwd[{dname}]", **common,
                        "replaces": "robustvlm_tpu/ops/pallas/vit_attention.py:181",
                        "max_abs_err": worst["bwd"], "ms": bwd_ms, "plain_ms": bwd_plain,
                        "bound_ms": bb, "bound_by": bby, "library_ms": lib_bwd})
    return results


# Flash attention at the main paths' shapes: the LLaVA-1.5-7B LM layer
# (32 heads, the `llava` phase's teacher-forced sequence at batch 1, head
# dim 128) and the CLIP text tower (96 = 8 prompts x 12 heads, 77 tokens,
# 64), plus ALiBi, key padding, causal with Nq < Nk and the extreme-score
# case. Limits as ATTN_TOL/LSE_TOL.
def _flash_llava_shape() -> tuple:
    from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS

    n = adapter_seq_len(LLAVA_CONFIGS["llava-1.5-7b"], LLAVA_POST_LEN)
    return (32, n, n, 128)


def _flash_cases() -> list:  # (label, bh, nq, nk, d, causal, alibi, extreme)
    bh, n, _, d = _flash_llava_shape()
    return [
        ("llava_lm", bh, n, n, d, True, False, False),
        ("clip_text", 96, 77, 77, 64, True, False, False),
        ("alibi_causal", 32, 300, 300, 128, True, True, False),
        ("keypad_noncausal", 96, 50, 50, 64, False, False, False),
        ("causal_nq_lt_nk", 32, 100, n, 128, True, False, False),
        ("extreme", bh, n, n, d, True, False, True),
    ]


def _flash_inputs(bh, nq, nk, d, dtype, seed, extreme=False, alibi=False):
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    if extreme:
        # Every scaled score is -8192 / sqrt(d), far below exp's underflow
        # point, and one product: exact in float32 whatever the summation
        # order (a dense sum of d equal products at 1/sqrt(128) rounds by
        # about 1e-3 in any order, beyond every float32 limit here). dK is
        # q (128) times sums of dS that carry float32 rounding of dP and
        # delta, and dQ, exactly 0, is k (64) times such sums: dO / 16
        # keeps that noise under the 1e-5 float32 limit.
        q = torch.zeros((bh, nq, d), device=dev)
        k = torch.zeros((bh, nk, d), device=dev)
        q[..., 0], k[..., 0] = 128.0, -64.0
    else:
        q = torch.randn(bh, nq, d, generator=gen, device=dev) * 0.5
        k = torch.randn(bh, nk, d, generator=gen, device=dev) * 0.5
    v = torch.randn(bh, nk, d, generator=gen, device=dev) * 0.5
    do = torch.randn(bh, nq, d, generator=gen, device=dev) / (16.0 if extreme else 1.0)
    slopes = (2.0 ** -torch.arange(1, bh + 1, device=dev).remainder(8).add(1).float()) if alibi else None
    return [t.to(dtype).contiguous() for t in (q, k, v, do)], slopes


def _flash_plain_all(q, k, v, do, kw):
    from robustvlm_tpu_torch.ops.kernels import flash_attention as F

    o, lse = F.flash_fwd_plain(q, k, v, **kw)
    return (o, lse, *F.flash_bwd_plain(q, k, v, o, lse, do, **kw))


def _flash_controls(dname, q, k, v, do, kw, got, ref) -> dict:
    """Planted faults the check must catch: lse + 0.05, dQ x 1.2, a backward
    without delta (the plain backward given O = 0), and a causal mask
    shifted by one column (the plain path with key j visible up to i + 1)."""
    import torch

    from robustvlm_tpu_torch.ops.kernels import flash_attention as F

    o, lse, dq, dk, dv = got
    no_delta = F.flash_bwd_plain(q, k, v, torch.zeros_like(ref[0]), ref[1], do, **kw)
    true_visible = F._visible
    F._visible = lambda nq, nk, causal, device: (
        None if not causal else true_visible(nq, nk + 1, causal, device)[:, :nk])
    try:
        shifted = _flash_plain_all(q, k, v, do, kw)
    finally:
        F._visible = true_visible
    faults = {
        "lse_plus_0.05": (o, lse + 0.05, dq, dk, dv),
        "dq_times_1.2": (o, lse, dq * 1.2, dk, dv),
        "bwd_without_delta": (o, lse, *no_delta),
        "causal_mask_shifted_one_column": shifted,
    }
    return {name: not all(ok for _, ok in _attn_check(dname, f, ref, False).values())
            for name, f in faults.items()}


def check_flash(peaks: dict) -> list:
    import torch
    import torch.nn.functional as Fn

    from robustvlm_tpu_torch.ops.kernels import flash_attention as F

    results = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        worst = {"fwd": 0.0, "bwd": 0.0}
        for label, bh, nq, nk, d, causal, alibi, extreme in _flash_cases():
            (q, k, v, do), slopes = _flash_inputs(bh, nq, nk, d, dtype, nq + nk, extreme, alibi)
            kw = dict(causal=causal, slopes=slopes)
            o, lse = F.flash_fwd_cuda(q, k, v, **kw)
            grads = F.flash_bwd_cuda(q, k, v, o, lse, do, **kw)
            again = F.flash_bwd_cuda(q, k, v, o, lse, do, **kw)
            got = (o, lse, *grads)
            ref = _flash_plain_all(q, k, v, do, kw)
            res = _attn_check(dname, got, ref, extreme)
            repeatable = all(torch.equal(a, b) for a, b in zip(grads, again))
            ok = all(r[1] for r in res.values()) and repeatable
            line = {"phase": "kernels", "kernel": "flash_attention", "case": label, "dtype": dname,
                    "shape": [bh, nq, nk, d], "causal": causal, "alibi": alibi,
                    "max_abs_err": {n: e for n, (e, _) in res.items()},
                    "within": {n: w for n, (_, w) in res.items()},
                    "bwd_bitwise_repeatable": repeatable,
                    "tol": {"outputs": ATTN_TOL[dname], "relative_to_max_ref": dname != "float32",
                            "lse": LSE_TOL}, "ok": ok}
            if label == "llava_lm":
                line["controls_caught"] = _flash_controls(dname, q, k, v, do, kw, got, ref)
                ok = ok and all(line["controls_caught"].values())
            emit(line)
            if not ok:
                raise AssertionError(f"flash_attention {dname} {label}: disagrees, is not "
                                     "repeatable, or a planted fault passed the check")
            worst["fwd"] = max(worst["fwd"], res["o"][0])
            worst["bwd"] = max(worst["bwd"], res["dq"][0], res["dk"][0], res["dv"][0])

        # times at the LLaVA LM shape, causal
        bh, n, _, d = _flash_llava_shape()
        (q, k, v, do), _ = _flash_inputs(bh, n, n, d, dtype, seed=1)
        o, lse = F.flash_fwd_cuda(q, k, v, causal=True)
        fwd_ms = time_ms(lambda: F.flash_fwd_cuda(q, k, v, causal=True))
        fwd_plain = time_ms(lambda: F.flash_fwd_plain(q, k, v, causal=True), iters=5)
        bwd_ms = time_ms(lambda: F.flash_bwd_cuda(q, k, v, o, lse, do, causal=True))
        bwd_plain = time_ms(lambda: F.flash_bwd_plain(q, k, v, o, lse, do, causal=True), iters=5)
        q4, k4, v4, do4 = (t.view(1, bh, n, d) for t in (q, k, v, do))
        lib_fwd = time_ms(lambda: Fn.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
        out = Fn.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        lib_bwd = time_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), do4, retain_graph=True))
        itm = q.element_size()
        elems = bh * n * d
        causal_pairs = bh * n * (n + 1) / 2  # (query, key) pairs the causal mask keeps
        fb, fby = bound_ms(4 * elems * itm + bh * n * 4, 4 * causal_pairs * d, dname, peaks)
        bb, bby = bound_ms(8 * elems * itm + bh * n * 4, 10 * causal_pairs * d, dname, peaks)
        common = {"route": "cuda", "source": "robustvlm_tpu_torch/csrc/flash_attention.cu",
                  "dtype": dname, "shape": [bh, n, d], "causal": True}
        results.append({"name": f"flash_attention_fwd[{dname}]", **common,
                        "replaces": "robustvlm_tpu/ops/pallas/flash_attention.py:154",
                        "max_abs_err": worst["fwd"], "ms": fwd_ms, "plain_ms": fwd_plain,
                        "bound_ms": fb, "bound_by": fby, "library_ms": lib_fwd})
        results.append({"name": f"flash_attention_bwd[{dname}]", **common,
                        "replaces": "robustvlm_tpu/ops/pallas/flash_attention.py:273 (dQ), :295 (dK/dV)",
                        "max_abs_err": worst["bwd"], "ms": bwd_ms, "plain_ms": bwd_plain,
                        "bound_ms": bb, "bound_by": bby, "library_ms": lib_bwd})
    return results


def q4_matmul_bound(peaks: dict) -> dict:
    """The bound of the still-to-port `q4_matmul` (ops/pallas/q4_matmul.py:168)
    at a LLaVA-7B decode step's MLP up-projection: x (8, 4096) bf16 times a
    half-split packed int4 weight, uint8 (2048, 11008), float32 group-128
    scales (32, 1, 11008); output (8, 11008) bf16; bf16 tensor-core peak."""
    b, k, n, group = 8, 4096, 11008, 128
    n_bytes = b * k * 2 + (k // 2) * n + (k // group) * n * 4 + b * n * 2
    bnd, by = bound_ms(n_bytes, 2 * b * k * n, "bfloat16", peaks)
    return {"phase": "bounds", "kernel": "q4_matmul", "status": "to port",
            "replaces": "robustvlm_tpu/ops/pallas/q4_matmul.py:168",
            "shape": {"x": [b, k], "packed": [k // 2, n], "scales": [k // group, 1, n]},
            "bytes": n_bytes, "flops": 2 * b * k * n, "bound_ms": bnd, "bound_by": by}


def phase_kernels(peaks: dict) -> list:
    emit(q4_matmul_bound(peaks))
    rows = [check_linf_step(peaks)]
    emit({"phase": "kernels", "kernel": "linf_step", "ok": True,
          "bitwise_equal": True, "shape": list(LINF_SHAPE)})
    rows += check_attention(peaks)
    rows += check_flash(peaks)
    return rows


def _counters() -> list:
    from robustvlm_tpu_torch.ops.kernels import attack_step, flash_attention, vit_attention

    return [attack_step.LAUNCHES, vit_attention.LAUNCHES, flash_attention.LAUNCHES]


def _reset_launches() -> None:
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def _launches() -> dict:
    return {k: v for counts in _counters() for k, v in counts.items()}


# the kernels each path must have launched
CLIP_KERNELS = ("linf_step", "vit_attention_fwd", "vit_attention_bwd")
LLAVA_KERNELS = CLIP_KERNELS + ("flash_attention_fwd", "flash_attention_bwd")


def _launched(launches: dict, names) -> bool:
    return all(launches[n] > 0 for n in names)


# ------------------------------------------------------------------ phase 3
def phase_reference() -> None:
    """The kernels' path on the card against the plain path on the CPU, on a
    small input: ViT-B/32 zero-shot logits and their pixel gradient, fp32."""
    import numpy as np
    import torch

    from robustvlm_tpu_torch.eval.classifier import make_zero_shot_classifier
    from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS

    cfg = CLIP_CONFIGS["ViT-B-32"]
    npr = np.random.RandomState(0)
    x = torch.from_numpy(npr.rand(2, 3, 224, 224).astype(np.float32))
    temb = torch.from_numpy(npr.randn(cfg.embed_dim, 10).astype(np.float32))
    temb = temb / temb.norm(dim=0, keepdim=True)
    cpu = CLIP(cfg, device="cpu").init_random_(0)
    gpu = CLIP(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    out = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        fn = make_zero_shot_classifier(model, temb.to(dev))
        xa = x.to(dev).requires_grad_(True)
        logits = fn(xa)
        (grad,) = torch.autograd.grad(logits[:, 0].sum(), xa)
        out[name] = (logits.detach().cpu(), grad.cpu())
    lg_err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    g_rel = float((out["cuda"][1] - out["cpu"][1]).norm() / out["cpu"][1].norm())
    ok = lg_err <= 1e-3 and g_rel <= 1e-3 and bool(torch.isfinite(out["cuda"][1]).all())
    emit({"phase": "reference", "model": "ViT-B-32", "batch": 2,
          "logits_max_abs_err": lg_err, "grad_rel_err": g_rel,
          "tol": {"logits_abs": 1e-3, "grad_rel": 1e-3}, "ok": ok})
    if not ok:
        raise AssertionError("the card's kernel path disagrees with the CPU plain path")


MAIN_EPS = 2.0  # /255


def phase_main(attacks: str, n_iter: int, compute_dtype: str) -> dict:
    """The CLI entry point at ViT-L/14 full width, random weights; returns
    each kernel's launches in this run alone."""
    import numpy as np
    import torch

    from robustvlm_tpu_torch.data.loaders import SyntheticClassificationDataset
    from robustvlm_tpu_torch.eval import robustbench

    n_ex = 8
    out_dir = OUT / f"robustbench-{attacks.replace(',', '+')}-{compute_dtype}"
    argv = [
        "--device", "cuda", "--clip_model_name", "ViT-L-14", "--template", "std",
        "--dataset", "synthetic", "--n_ex", str(n_ex), "--attack_batch", "8",
        "--batch_size", "8", "--eps", str(MAIN_EPS), "--attacks", attacks,
        "--n_iter", str(n_iter), "--compute_dtype", compute_dtype, "--labels", "predicted",
        "--output_dir", str(out_dir), "--save_adv",
    ]
    _reset_launches()
    t0 = time.perf_counter()
    result = robustbench.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()

    x, _ = SyntheticClassificationDataset(n=n_ex, size=224).arrays()
    x_adv = np.load(out_dir / "x_adv.npy")
    linf = float(np.abs(x_adv.astype(np.float64) - x).max())
    checks = {
        "shape": x_adv.shape == x.shape,
        "finite": bool(np.isfinite(x_adv).all()),
        "in_box": bool(x_adv.min() >= 0.0 and x_adv.max() <= 1.0),
        "in_ball": linf <= MAIN_EPS / 255.0 + 1e-6,
        "accuracies": 0.0 <= result["robust_acc"] <= result["clean_acc"] <= 1.0,
        # the text tower's causal attention is the flash kernel's, forward only
        "launched": _launched(launches, CLIP_KERNELS + ("flash_attention_fwd",)),
        "attacked": attacks.split(",")[0] in result["cascade"],
    }
    emit({"phase": "main", "entry": "robustvlm_tpu_torch.eval.robustbench.main",
          "argv": argv, "wall_s": wall, "clean_acc": result["clean_acc"],
          "robust_acc": result["robust_acc"], "cascade": result["cascade"],
          "linf_max": linf, "eps": MAIN_EPS / 255.0, "launches": launches,
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"main path checks failed: {checks}")
    return launches


TIMED_BATCH = 8
TIMED_ITERS = 100


def phase_timed() -> None:
    """`apgd_attack` at ViT-L/14 in bfloat16 as the JAX bench.py drives it:
    batch 8, 100 iterations, random weights, example-steps/s."""
    import numpy as np
    import torch

    from robustvlm_tpu_torch.attacks.apgd import apgd_attack
    from robustvlm_tpu_torch.eval.classifier import make_zero_shot_classifier
    from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS
    from robustvlm_tpu_torch.ops.losses import ce_loss

    cfg = CLIP_CONFIGS["ViT-L-14"]
    model = CLIP(cfg, device="cuda").init_random_(0).to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(1)
    temb = torch.randn(cfg.embed_dim, 1000, generator=gen, device="cuda")
    temb = temb / temb.norm(dim=0, keepdim=True)
    logits_fn = make_zero_shot_classifier(model, temb, compute_dtype=torch.bfloat16)
    npr = np.random.RandomState(0)
    x = torch.from_numpy(npr.rand(TIMED_BATCH, 3, 224, 224).astype(np.float32)).cuda()
    y = torch.from_numpy(npr.randint(0, 1000, TIMED_BATCH)).cuda()

    def criterion(o, t):
        return ce_loss(o, t, reduction="none")

    def attack(n_iter):
        res = apgd_attack(logits_fn, x, y, criterion=criterion, eps=2.0 / 255.0,
                          n_iter=n_iter, norm="linf")
        torch.cuda.synchronize()
        return res

    attack(3)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    runs, launches = [], None
    for _ in range(2):
        _reset_launches()
        t0 = time.perf_counter()
        res = attack(TIMED_ITERS)
        runs.append(time.perf_counter() - t0)
        launches = _launches()
    linf = float((res.x_best_adv - x).abs().max())
    best = min(runs)
    # the attack evaluates the model n_iter + 1 times per example (bench.py)
    value = TIMED_BATCH * (TIMED_ITERS + 1) / best
    ok = linf <= 2.0 / 255.0 + 1e-6 and _launched(launches, CLIP_KERNELS)
    emit({"phase": "timed", "metric": "apgd_example_steps_per_sec_vitl14_bf16",
          "value": value, "unit": "example-steps/s", "batch": TIMED_BATCH,
          "n_iter": TIMED_ITERS, "run_s": runs, "ms_per_iter": best / TIMED_ITERS * 1e3,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "launches": launches, "linf_max": linf, "card": card_line(), "ok": ok})
    if not ok:
        raise AssertionError("timed attack left the eps-ball or launched no kernel")


# ------------------------------------------------------------------ phase 6
def _llava_cut(n_layers: int):
    """llava-1.5-7b at full width with the LM and the vision tower cut to
    `n_layers` transformer layers each."""
    import dataclasses

    from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS

    cfg = LLAVA_CONFIGS["llava-1.5-7b"]
    vision = dataclasses.replace(cfg.vision, vision=dataclasses.replace(cfg.vision.vision, layers=n_layers))
    return dataclasses.replace(cfg, name=f"llava-1.5-7b-{n_layers}l",
                               llama=dataclasses.replace(cfg.llama, n_layers=n_layers), vision=vision)


def phase_llava_reference() -> dict:
    """The LLaVA loss path through the kernels on the card against the plain
    path on the CPU: full widths, 2 LM and 2 vision layers, float32, batch
    1, max_post_len 16; the per-sample CE (1e-4 rel) and its pixel gradient
    (1e-3 rel). Returns the kernels' launches of the card's run."""
    import numpy as np
    import torch

    from robustvlm_tpu_torch.models.llava.convert import init_random_state
    from robustvlm_tpu_torch.models.llava.model import Llava
    from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel, WordTokenizer

    t0 = time.perf_counter()
    cfg = _llava_cut(2)
    state = init_random_state(cfg, 0, "cpu")
    size = cfg.vision.image_size
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 3, size, size).astype(np.float32))
    out, launches = {}, None
    torch.cuda.reset_peak_memory_stats()
    for dev in ("cpu", "cuda"):
        model = Llava.from_state(cfg, {k: v.to(dev) for k, v in state.items()})
        adapter = LlavaEvalModel(model, WordTokenizer(), compute_dtype=torch.float32, max_post_len=16)
        adapter.set_inputs([adapter.get_caption_prompt("two dogs play with a red ball on the grass")])
        xa = x.to(dev).requires_grad_(True)
        _reset_launches()
        loss = adapter(xa)
        (grad,) = torch.autograd.grad(loss.sum(), xa)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = _launches()
        out[dev] = (loss.detach().cpu().double(), grad.cpu().double())
        del model, adapter
    loss_rel = float(((out["cuda"][0] - out["cpu"][0]).abs() / out["cpu"][0].abs()).max())
    g_rel = float((out["cuda"][1] - out["cpu"][1]).norm() / out["cpu"][1].norm())
    checks = {"loss_rel": loss_rel <= 1e-4, "grad_rel": g_rel <= 1e-3,
              "finite": bool(torch.isfinite(out["cuda"][1]).all()),
              "launched": _launched(launches, ("vit_attention_fwd", "vit_attention_bwd",
                                               "flash_attention_fwd", "flash_attention_bwd"))}
    emit({"phase": "llava_reference", "model": cfg.name, "dtype": "float32", "batch": 1,
          "seq_len": int(adapter_seq_len(cfg)), "loss": float(out["cpu"][0][0]),
          "loss_rel_err": loss_rel, "grad_rel_err": g_rel, "tol": {"loss_rel": 1e-4, "grad_rel": 1e-3},
          "launches": launches, "wall_s": time.perf_counter() - t0,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "checks": checks,
          "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"llava_reference checks failed: {checks}")
    return launches


LLAVA_POST_LEN = 64  # LlavaEvalModel's default max_post_len, as the CLI runs it


def adapter_seq_len(cfg, max_post_len: int = 16) -> int:
    """Tokens of the teacher-forced sequence: BOS + system prompt (25 with
    the word tokenizer) + image tokens + max_post_len."""
    from robustvlm_tpu_torch.models.llava.conversation import VICUNA_SYSTEM

    pre = 1 + len((VICUNA_SYSTEM + " USER: ").split())
    return pre + cfg.n_image_tokens + max_post_len


# ------------------------------------------------------------------ phase 7
LLAVA_EPS = 2.0  # /255
LLAVA_IMAGES = [  # COCO-style references, two images
    ["a man riding a wave on top of a surfboard", "a surfer rides a large wave in the ocean",
     "a person on a surfboard in the water", "a surfer catching a wave", "a man surfing a big wave"],
    ["a plate of food with broccoli and rice", "a white plate topped with rice and vegetables",
     "broccoli and chicken on a plate", "a meal of rice and broccoli", "a dinner plate with food"],
]


def _coco_fixture(root: Path) -> tuple:
    """Two seeded 400x360 RGB images and a COCO-format annotations json."""
    import numpy as np
    from PIL import Image

    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i, caps in enumerate(LLAVA_IMAGES):
        name = f"COCO_val2014_{i:012d}.png"
        Image.fromarray(rng.randint(0, 255, (360, 400, 3), np.uint8)).save(img_dir / name)
        images.append({"id": i, "file_name": name})
        anns += [{"image_id": i, "caption": c} for c in caps]
    ann = root / "captions.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns}))
    return img_dir, ann


def phase_llava() -> dict:
    """`run_evaluation.main` at LLaVA-1.5-7B full width (32 LM layers, the
    336 px tower), random weights from seed 0, bf16 APGD (--attack apgd, the
    half-precision untargeted run), eps 2/255, 100 iterations, 2 images.
    PIL imports on the card, so the CLI reads a COCO-format fixture written
    here. Then the loss at x_adv is recomputed against the clean loss."""
    import gc

    import numpy as np
    import torch

    from robustvlm_tpu_torch.models.llava.convert import init_random_state
    from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS, Llava
    from robustvlm_tpu_torch.vlm_eval import run_evaluation
    from robustvlm_tpu_torch.vlm_eval.datasets import CaptionDataset
    from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel, WordTokenizer

    root = OUT / "llava-coco"
    img_dir, ann = _coco_fixture(root)
    out_dir = root / "out"
    argv = ["--device", "cuda", "--model", "llava", "--model_size", "7b", "--eval_coco",
            "--coco_image_dir", str(img_dir), "--coco_annotations", str(ann),
            "--attack", "apgd", "--eps", str(LLAVA_EPS), "--n_iter", "100", "--num_samples", "2",
            "--max_new_tokens", "32", "--out_base_path", str(out_dir), "--verbose"]
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    result = run_evaluation.main(argv)["coco"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    peak_run = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()

    # recompute: the same weights (seed 0, bf16), the loss at x_adv and at x
    cfg = LLAVA_CONFIGS["llava-1.5-7b"]
    model = Llava.from_state(cfg, init_random_state(cfg, 0, "cuda", torch.bfloat16))
    adapter = LlavaEvalModel(model, WordTokenizer(), compute_dtype=torch.bfloat16)
    ds = CaptionDataset(str(img_dir), str(ann), size=cfg.vision.image_size, split="val")
    state = json.loads((out_dir / "coco" / "ensemble_state.json").read_text())
    per_image = []
    with torch.no_grad():
        for i in range(len(ds)):
            item = ds[i]
            x = np.asarray(item["image"], np.float32)
            x_adv = np.load(out_dir / "coco" / "adv" / f"{item['image_id']}.npy")
            adapter.set_inputs([adapter.get_caption_prompt(item["all_captions"][0])])
            losses = [float(adapter(torch.from_numpy(a[None]).cuda())[0]) for a in (x, x_adv)]
            per_image.append({
                "image_id": item["image_id"], "loss_clean": losses[0], "loss_adv": losses[1],
                "linf": float(np.abs(x_adv.astype(np.float64) - x).max()),
                "in_box": bool(x_adv.min() >= 0.0 and x_adv.max() <= 1.0),
                "caption": state["best_outputs"][str(item["image_id"])],
            })
    del model, adapter
    gc.collect()
    torch.cuda.empty_cache()
    ms_per_iter = result["attack_s"] / result["attack_iters"] * 1e3
    checks = {
        "in_box": all(r["in_box"] for r in per_image),
        "in_ball": all(r["linf"] <= LLAVA_EPS / 255.0 + 1e-6 for r in per_image),
        "loss_raised": all(r["loss_adv"] > r["loss_clean"] for r in per_image),
        "captions": all(isinstance(r["caption"], str) for r in per_image),
        "cider": isinstance(result["cider"], float) and math.isfinite(result["cider"]),
        "launched": _launched(launches, LLAVA_KERNELS),
        "iterations": result["attack_iters"] == 100 * len(per_image),
    }
    emit({"phase": "llava", "entry": "robustvlm_tpu_torch.vlm_eval.run_evaluation.main",
          "argv": argv, "model": cfg.name, "dtype": "bfloat16", "seq_len": adapter_seq_len(cfg, LLAVA_POST_LEN),
          "wall_s": wall, "attack_s": result["attack_s"], "attack_iters": result["attack_iters"],
          "ms_per_apgd_iter": ms_per_iter, "peak_mem_gib": peak_run, "cider": result["cider"],
          "per_image": per_image, "eps": LLAVA_EPS / 255.0, "launches": launches,
          "card": card_line(), "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"llava checks failed: {checks}")
    return launches


# ------------------------------------------------------------------ phase 8
LLAVA_ENSEMBLE_ITERS = 5


class _FullStageLaunches(dict):
    """`build_llava_models`' result; notes the launch counts when the float32
    model is first taken, at the start of the ensemble's last stage, the
    only one that runs it."""

    at_full = None

    def __getitem__(self, key):
        if key == "full" and self.at_full is None:
            self.at_full = _launches()
        return super().__getitem__(key)


def phase_llava_ensemble() -> dict:
    """`--attack ensemble` at LLaVA-1.5-7B full width on one image: one set
    of random weights (seed 0) held as one float32 and one bf16 copy, the
    clean pass, five bf16 APGD stages and the float32 prev-best stage, each
    at LLAVA_ENSEMBLE_ITERS iterations. Driven through `evaluate_captioning`
    with the early-stop threshold at -inf: with random weights CIDEr is 0,
    under COCO's 10, and the ensemble would stop after the clean pass. Then
    the float32 adapter's loss and pixel gradient are timed alone. Returns
    the float32 stage's launches."""
    import numpy as np
    import torch

    from robustvlm_tpu_torch.vlm_eval import run_evaluation
    from robustvlm_tpu_torch.vlm_eval.datasets import CaptionDataset

    img_dir, ann = _coco_fixture(OUT / "llava-coco")
    out_dir = OUT / "llava-ensemble"
    argv = ["--device", "cuda", "--model", "llava", "--model_size", "7b", "--eval_coco",
            "--coco_image_dir", str(img_dir), "--coco_annotations", str(ann),
            "--attack", "ensemble", "--eps", str(LLAVA_EPS), "--n_iter", str(LLAVA_ENSEMBLE_ITERS),
            "--num_samples", "1", "--max_new_tokens", "32", "--out_base_path", str(out_dir),
            "--verbose"]
    args = run_evaluation.build_parser().parse_args(argv)
    schedule = run_evaluation.captioning_schedule(args)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _reset_launches()
    t0 = time.perf_counter()
    built = run_evaluation.build_llava_models(args, {s.precision for s in schedule},
                                              torch.device("cuda"))
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - before
    # the distinct tensors the two models hold: one float32 copy of every
    # parameter and one bf16 copy of the matrices, nothing else
    held = {t.data_ptr(): t.numel() * t.element_size()
            for m in built.values() for t in m.state_dict().values()}
    n_params = sum(t.numel() for t in built["full"].state_dict().values())
    n_matrix = sum(t.numel() for t in built["half"].state_dict().values()
                   if t.dtype == torch.bfloat16)
    models = _FullStageLaunches(built)
    result = run_evaluation.evaluate_captioning(args, "coco", str(img_dir), str(ann),
                                                models=models, threshold=-math.inf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = _launches()
    full = {k: total[k] - models.at_full[k] for k in total}
    peak = torch.cuda.max_memory_allocated() / 2**30

    ds = CaptionDataset(str(img_dir), str(ann), size=336, split="val")
    item = ds[int(run_evaluation._eval_indices(len(ds), 1, args.seed)[0])]
    x = torch.from_numpy(np.asarray(item["image"], np.float32)[None]).cuda()
    adapter = run_evaluation.build_eval_model(args, "full", built)
    adapter.set_inputs([adapter.get_caption_prompt(item["all_captions"][0])])

    def fp32_iteration():
        xa = x.clone().requires_grad_(True)
        torch.autograd.grad(adapter(xa).sum(), xa)

    fp32_ms = time_ms(fp32_iteration, iters=3, warmup=1)
    del adapter, models, built
    state = json.loads((out_dir / "coco" / "ensemble_state.json").read_text())
    x_adv = np.load(out_dir / "coco" / "adv" / f"{item['image_id']}.npy")
    linf = float(np.abs(x_adv.astype(np.float64) - x.cpu().numpy()[0]).max())
    checks = {
        "every_stage_ran": (state["stages_done"] == len(schedule)
                            and result["attack_iters"] == (len(schedule) - 1) * LLAVA_ENSEMBLE_ITERS),
        "one_copy_per_precision": sum(held.values()) == 4 * n_params + 2 * n_matrix,
        "nothing_else_allocated": allocated <= sum(held.values()) + 2**26,
        "in_box": bool(x_adv.min() >= 0.0 and x_adv.max() <= 1.0),
        "in_ball": linf <= LLAVA_EPS / 255.0 + 1e-6,
        "caption": isinstance(state["best_outputs"][str(item["image_id"])], str),
        "cider": isinstance(result["cider"], float) and math.isfinite(result["cider"]),
        "launched": _launched(total, LLAVA_KERNELS),
        "float32_stage_launched_flash": _launched(full, ("flash_attention_fwd", "flash_attention_bwd")),
    }
    emit({"phase": "llava_ensemble", "entry": "robustvlm_tpu_torch.vlm_eval.run_evaluation."
          "evaluate_captioning", "argv": argv, "threshold": "-inf", "model": "llava-1.5-7b",
          "stages": len(schedule), "iters_per_stage": LLAVA_ENSEMBLE_ITERS, "wall_s": wall,
          "attack_s": result["attack_s"], "attack_iters": result["attack_iters"],
          "float32_ms_per_loss_and_grad": fp32_ms, "weights_allocated_gib": allocated / 2**30,
          "held_tensor_gib": sum(held.values()) / 2**30, "peak_mem_gib": peak,
          "launches": total, "launches_float32_stage": full, "linf": linf,
          "cider": result["cider"], "card": card_line(), "checks": checks,
          "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"llava_ensemble checks failed: {checks}")
    return full


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "robustvlm_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: robustvlm_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from robustvlm_tpu_torch.device import use_full_fp32

    use_full_fp32()  # float32 matmuls at full precision: no TF32
    (OUT / "chip_smoke.jsonl").unlink(missing_ok=True)
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)
    emit({"phase": "start", "device": name, "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks": peaks})

    phase_build()
    rows = phase_kernels(peaks)
    phase_reference()
    # The main path twice through the CLI, at its default 100 iterations: in
    # float32 (its default) the AutoAttack cascade; in bfloat16 APGD-T alone
    # (with random weights APGD-CE fools every example at eps = 2/255, so the
    # cascade never reaches APGD-T). Each dtype's kernel rows take the
    # launches of its run.
    runs = {"main[float32]": phase_main("apgd-ce,apgd-t", 100, "float32"),
            "main[bfloat16]": phase_main("apgd-t", 100, "bfloat16")}
    phase_timed()
    runs["llava_reference"] = phase_llava_reference()
    runs["llava"] = phase_llava()
    runs["llava_ensemble[float32 stage]"] = phase_llava_ensemble()
    # Each row takes the launches of the run of its path and dtype: the CLIP
    # kernels from the CLI's CLIP runs; flash in bf16 from the LLaVA eval,
    # in float32 from the ensemble's float32 stage.
    for r in rows:
        kernel = r["name"].split("[")[0]
        if kernel.startswith("flash"):
            src = "llava" if r["dtype"] == "bfloat16" else "llava_ensemble[float32 stage]"
        else:
            src = f"main[{r['dtype']}]"
        r["launches"] = runs[src][kernel]
        r["launches_from"] = src
    emit({"kernels": rows})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
