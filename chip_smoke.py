#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (robustvlm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:
  1. build    - nvcc builds every kernel of csrc/, one process per source;
  2. kernels  - each kernel against its plain PyTorch version on the card,
                at the main path's shapes, with times and bounds; planted
                faults show that the attention check can fail;
  3. reference - ViT-B/32 logits and pixel gradient through the kernels
                on the card against the plain path on the CPU;
  4. main     - `robustbench.main` (the CLI entry point) at CLIP ViT-L/14
                full width: zero-shot classifier and AutoAttack at 100
                iterations, in float32 (APGD-CE + APGD-T) and in bfloat16
                (APGD-T), with each kernel's launch count read around each run;
  5. timed    - `apgd_attack` at ViT-L/14 in bfloat16, batch 8, 100
                iterations: APGD example-steps/s.
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


def phase_kernels(peaks: dict) -> list:
    rows = [check_linf_step(peaks)]
    emit({"phase": "kernels", "kernel": "linf_step", "ok": True,
          "bitwise_equal": True, "shape": list(LINF_SHAPE)})
    rows += check_attention(peaks)
    return rows


def _reset_launches() -> None:
    from robustvlm_tpu_torch.ops.kernels import attack_step, vit_attention

    for counts in (attack_step.LAUNCHES, vit_attention.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _launches() -> dict:
    from robustvlm_tpu_torch.ops.kernels import attack_step, vit_attention

    return {**attack_step.LAUNCHES, **vit_attention.LAUNCHES}


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
        "launched": all(v > 0 for v in launches.values()),
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
    ok = linf <= 2.0 / 255.0 + 1e-6 and all(v > 0 for v in launches.values())
    emit({"phase": "timed", "metric": "apgd_example_steps_per_sec_vitl14_bf16",
          "value": value, "unit": "example-steps/s", "batch": TIMED_BATCH,
          "n_iter": TIMED_ITERS, "run_s": runs, "ms_per_iter": best / TIMED_ITERS * 1e3,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "launches": launches, "linf_max": linf, "card": card_line(), "ok": ok})
    if not ok:
        raise AssertionError("timed attack left the eps-ball or launched no kernel")


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
    launches = {"float32": phase_main("apgd-ce,apgd-t", 100, "float32"),
                "bfloat16": phase_main("apgd-t", 100, "bfloat16")}
    phase_timed()
    for r in rows:
        r["launches"] = launches[r["dtype"]][r["name"].split("[")[0]]
        r["launches_from"] = f"main[{r['dtype']}]"
    emit({"kernels": rows})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
