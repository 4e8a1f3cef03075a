#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (robustvlm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:
  1. build    - nvcc builds every kernel of csrc/, one process per source;
  2. kernels  - each kernel against its plain PyTorch version on the card,
                at the main paths' shapes, with times (kernels by CUDA-graph
                replay), bounds and the library call of the same function
                (SDPA; PyTorch's int4 weight-only matmul for q4_matmul);
                the flash kernels also with ALiBi at MPT-7B's shape (32
                heads of 128, causal) at OpenFlamingo's prompt length (the
                flamingo phase's) and at LLaVA-MPT's sequence length
                (`llava_mpt_reference`'s), against SDPA with the bias as a
                float mask; the bf16 ViT forward at one 336 px image (16,
                577, 64), the serving towers' shape; q4_matmul at 1, 4, 8, 9
                and 32 rows (8: a row bit-equal inside another batch of 8),
                with decode-step rows at 1, 4 and 8 rows; planted faults
                show that the attention and q4_matmul checks can fail;
  3. reference - ViT-B/32 logits and pixel gradient through the kernels
                on the card against the plain path on the CPU;
  4. main     - `robustbench.main` (the CLI entry point) at CLIP ViT-L/14
                full width: zero-shot classifier and AutoAttack at 100
                iterations, in float32 (APGD-CE + APGD-T) and in bfloat16
                (APGD-T), with each kernel's launch count read around each run;
  5. timed    - `apgd_attack` at ViT-L/14 in bfloat16, batch 8, 100
                iterations: APGD example-steps/s;
  6. robustbench_breadth - at ViT-L/14 full width, bf16, 8 synthetic images:
                the card's l1-ball and hyperplane-box projections against the
                CPU's; `robustbench.main` with FAB-T (10 iterations), l2 and
                l1 APGD-CE (10 iterations; l1 through the decr-eps schedule)
                and `--full_benchmark`; Square (500 queries) through
                `AutoAttack` on the CLI's classifier: x_adv in [0,1] and the
                ball, every example counted as fooled fooled when run again,
                the kernels' launches (no l-inf step outside l-inf APGD, no
                ViT backward in Square), ms per FAB-T iteration and per
                Square query, peak memory;
  7. train_reference - one TeCoA and one FARE outer loss and its weight
                gradients at ViT-L/14 widths cut to 2 layers, float32
                (and FARE in bf16), through the kernels on the card against
                the plain path on the CPU in float32;
  8. train    - `driver.main` (the training CLI) at ViT-L/14 full width, 3
                steps of batch 32 in 4 chunks: FARE (eps 4, APGD-10, float32)
                and TeCoA (eps 2, PGD-10, bf16, the text embedding and the
                APGD-50 eval), with s per step, imgs/s, peak memory, losses,
                exact linf_step launches, the inner attack's x_adv and the
                exported visual tower checked;
  9. llava_reference - LLaVA-1.5-7B widths cut to 2 LM and 2 vision layers,
                float32: the per-sample loss and pixel gradient through the
                kernels on the card against the plain path on the CPU, and
                on the card with `remat=True` bit-equal to without;
 10. llava    - `run_evaluation.main` (the VLM eval CLI) at LLaVA-1.5-7B full
                width, bf16, 25 APGD iterations on 2 COCO-format images
                written under chiprun_out/, captions and CIDEr, with each
                kernel's launches, ms per APGD iteration and peak memory;
                then one iteration's loss and pixel gradient with
                `LlavaEvalModel(remat=True)` against without: both peaks,
                the flash forward's launches doubled;
 11. llava_vqa - `run_evaluation.main --eval_vqav2` at LLaVA-1.5-7B full
                width, bf16, a targeted APGD run ('maybe', 10 iterations) on
                3 questions of a VQAv2-layout fixture (2 on one image): the
                target's loss at x_adv below clean, per-question keys,
                accuracy and success rate, ms per iteration, peak memory;
 12. llava_ensemble - the CLI's ensemble schedule at LLaVA-1.5-7B full width
                with both precisions' models held together, every stage
                run (its last in float32), with peak memory, the float32
                stage's launches and the ms of one float32 loss and gradient;
                then the 9-stage VQA schedule (targeted 'maybe' and 'Word'
                stages) on one question over the same models;
 13. llava_rob - the loaders at full width: an HF-layout LLaVA-1.5-7B
                directory of fp16 shards and a robust ViT-L/14 tower file
                written under chiprun_out/ (deleted after), loaded by
                `run_evaluation.main --llava_ckpt --vision_encoder_pretrained
                --eval_textvqa --attack apgd`: logits bit-equal to a model
                built straight from the written values, the tower at 224 px,
                write and load seconds, host peak RSS;
 14. llava_mpt_reference - LLaVA-MPT at MPT-7B and ViT-L/14 widths cut to 2
                layers each: float32 loss, pixel gradient and greedy tokens of
                a left-padded batch on the card against the CPU, then bf16 on
                the card (the ALiBi rows' launches at this length);
 15. llava_qualitative - `run_evaluation_qualitative.main` at full width, 10
                iterations on one image: the target's loss fell;
 16. llava_aux  - POPE's, ScienceQA's and MMBench's `main` at full width on
                2 items each (MMBench in every rotation of its options), and
                `gpt_review` over POPE's answers against the labels;
 16a. blip2_reference - BLIP-2 (blip2-opt-2.7b) widths cut to 2 vision, 2
                Q-Former and 2 OPT layers, float32: the per-sample loss,
                pixel gradient and greedy tokens on the card against the CPU;
 16b. blip2   - `run_evaluation.main --model blip2 --model_size 7b
                --blip2_ckpt` at full width (39 + 12 + 32 layers), bf16, on
                an HF-layout fp16 checkpoint it writes under chiprun_out/
                (deleted after): APGD on 2 COCO-format images and one VQAv2
                question, ms per iteration, peak memory, write and load
                seconds, the texts; no attention kernel launched (BLIP-2's
                attention is plain, as in JAX), `linf_step` once an
                iteration;
 17. flamingo_reference - OpenFlamingo-9B widths cut to 4 MPT layers (one
                gated cross-attention block) and 2 vision layers, the whole
                Perceiver, float32, gates opened to 0.5: the per-sample loss
                and pixel gradient through the kernels on the card against
                the plain path on the CPU;
 18. flamingo - `run_evaluation.main --model open_flamingo` at
                OpenFlamingo-9B full width (32 MPT layers, 8 gated blocks,
                ViT-L/14 at 224 px), bf16, 25 APGD iterations on 2 of 4
                COCO-format images (2 text-only demos each), the gates
                opened after the CLI builds the model (a random model with
                the reference's zero gates ignores its image): ms per APGD
                iteration, peak memory, the prompt length, each kernel's
                launches (the flash kernels with ALiBi slopes), x_adv, the
                loss at x_adv above clean, captions and CIDEr;
 19. flamingo_ensemble - the ensemble schedule at OpenFlamingo-9B full width
                with both precisions held, every stage run: peak memory and
                the ms of one float32 loss and gradient;
 20. benchmark_reference - ConvNeXt-B (convnext_base_w) at full width, 256
                px, and ViT-g/14 widths cut to 2 vision layers (head dim 88:
                its kernels inside a real tower), float32, batch 2: zero-shot
                logits and pixel gradient through the card against the CPU;
 21. benchmark - `benchmark.cli.main` (the zero-shot benchmark CLI) at full
                width on fixtures written under chiprun_out/ (a
                wds/vtab/cifar10-layout webdataset of 2 tar shards of 16 PNGs
                at 224 px, a COCO-style captions fixture): ViT-L/14 (bf16,
                AutoAttack 20 iterations on 16 images, then retrieval,
                caption selection, linear probe and caption scores),
                ViT-g/14 (bf16, AutoAttack 5 iterations on 8: the head dim 88
                rows' launches), ConvNeXt-B (bf16, AutoAttack 5 iterations)
                and ja_clip ViT-B/16 (clean); metrics in range, adv <= clean,
                x_adv in [0,1] and the ball, `linf_step` launches equal to
                the cascade's APGD iterations, the C++ image transform
                taken, no ViT kernel in the ConvNeXt run; ms per APGD
                iteration, seconds and peak memory per model;
 22. serve    - the model worker (`build_worker`, its CLI's path) at
                LLaVA-1.5-7B full width with int4 LM weights behind the
                port's controller on local ports: captions, VQA, a stream,
                the shift body and a batch-4 micro-batch over HTTP, with ms
                per decode step, tokens/s, held and peak memory, launches,
                and one decode step's logits through the kernel against the
                kernel's plain version;
 23. serve_continuous - on the serve phase's adapter, `ModelWorker` with a
                `ContinuousEngine` (4 lanes, width 32, 32 new tokens) behind
                the controller: 8 caption/VQA streams 0.25 s apart (and 4
                short ones through the shift body): each request's tokens
                against its solo batch-1 stream (equal, or a first
                divergence at a near tie), a request admitted while another
                decodes, q4_matmul only at 4 rows, 225 a step; lane isolation
                bit for bit (tokens and lane logits beside two sets of
                neighbours); a lane cancelled on a stop string freeing its
                slot; aggregate tokens/s, latencies, peak memory, a
                dispatch's wall and a step's device time (graph replay);
 24. serve_continuous[int8 kv] - the same with `quantize_kv`: int8 lanes
                with float32 scales, held against the solo int8 stream, with
                the cache's bytes and the step beside the bf16 one;
 25. serve_speculate - `ModelWorker(speculate=7)`: a 32-token caption by
                /worker_generate_stream against the solo stream (same rule),
                q4_matmul only at 8 rows, 225 a verify step, the stats
                against the tokens streamed; accept rate, tokens per verify
                step, tokens/s against the plain stream.
 26. parallel - `robustvlm_tpu_torch.parallel` over a world-size-1 NCCL
                process group: `driver.main` with train[tecoa2]'s argv for 2
                steps in the group against without it (parameters
                bit-equal, one gradient all-reduce a step); LLaVA-1.5-7B
                bf16 under `shard_params` against the same model unsharded
                (loss and pixel gradient at 665 tokens on 2 images, 5 APGD
                iterations, to llava_reference's limits, bitwise status
                reported) and the continuous engine on both (near-tie
                rule); the eval merge over NCCL; ms, peaks and launches.
Then the `kernels` JSON line, the card's name and power limit as nvidia-smi
reports them, and last the device line. Without CUDA, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
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
# (n, head dim, extreme scores): the three towers' lengths, every scaled
# score far below exp's underflow point, a ragged length (one key past a
# 64-row tile), and head dims 80 (ViT-H/14) and 88 (ViT-g/14), whose shared
# rows are padded
ATTN_CASES = ([(n, ATTN_D, False) for n in ATTN_NS] + [(257, ATTN_D, True), (129, ATTN_D, False)]
              + [(129, 80, False), (257, 80, False), (129, 88, False), (257, 88, False)])
# The timed ViT rows: ViT-L/14's head dim (launches from the CLI's main
# runs) and ViT-g/14's (launches from the benchmark phases' ViT-g-14 runs:
# the float32 2-layer cut of `benchmark_reference`, the bf16 CLI run)
ATTN_TIMED = {ATTN_D: None,
              88: {"float32": "benchmark_reference[ViT-g-14]", "bfloat16": "benchmark[ViT-g-14]"}}
# Attention against its plain version, per output tensor: float32 within
# 1e-5 abs; bf16 within 2e-2 of the reference's largest magnitude; lse is
# float32 in both dtypes and held to 1e-5 abs + 1e-6 of its value.
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LSE_TOL = (1e-5, 1e-6)  # (atol, rtol)
ATTN_OUTPUTS = ("o", "lse", "dq", "dk", "dv")
# How the attention rows are timed. The kernels and the library forward are
# captured in a CUDA graph and replayed (time_graph_ms): no host time between
# launches. The library backward is captured too, as PyTorch's whole-network
# capture does it: SDPA's forward and `torch.autograd.grad` together in one
# graph (the backward of a forward captured on a stream runs on that
# stream), less the same forward alone with inputs that require grad, which
# may save more than a no-grad forward (time_graph_fwd_bwd_ms; both terms
# are in the row). Plain versions by events around a Python loop (time_ms).
TIMED_BY = {
    "fwd": {"ms": "graph", "library_ms": "graph", "plain_ms": "events"},
    "bwd": {"ms": "graph",
            "library_ms": "graph: forward + autograd.grad less the forward with grad inputs",
            "plain_ms": "events"},
}


T_START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line, and keep it in chiprun_out/chip_smoke.jsonl.
    Each line of a phase carries `t_s`, the script's seconds so far."""
    line = json.dumps({**obj, "t_s": round(time.perf_counter() - T_START, 1)} if "phase" in obj else obj)
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


def time_graph_ms(fn, iters: int = 24, replays: int = 5) -> float:
    """Mean device time of fn() from a CUDA graph of `iters` calls, replayed:
    no host time between launches, which `time_ms` would measure instead for
    a kernel shorter than the Python call that launches it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def time_graph_fwd_bwd_ms(fwd, inputs, grad_out, iters: int = 12) -> dict:
    """The library backward by CUDA-graph replay: `fwd(*inputs)` and
    `torch.autograd.grad` of its output into `inputs` captured together,
    and the same forward alone (inputs that require grad, so it saves what
    the backward needs); the backward is the difference."""
    import torch

    def both():
        torch.autograd.grad(fwd(*inputs), inputs, grad_out)

    def forward():
        fwd(*inputs)

    fb = time_graph_ms(both, iters=iters)
    f = time_graph_ms(forward, iters=iters)
    return {"library_ms": fb - f, "library_fwd_bwd_ms": fb, "library_fwd_ms": f}


# kernel-name markers of SDPA's backends, in the order they are tested
# (cuDNN's kernel names also hold "flash")
SDPA_BACKENDS = (("cudnn", "cuDNN"), ("flash", "flash"), ("fmha_cutlass", "memory-efficient"),
                 ("efficient", "memory-efficient"))


def sdpa_backend(fn) -> dict:
    """Which of SDPA's backends ran in fn(), from the names of the CUDA
    kernels of one torch.profiler pass; "math" when none of theirs ran, "not
    measured" when the pass recorded no CUDA kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA})
    hits = [n for n in names if any(m in n for m, _ in SDPA_BACKENDS)]
    backend = next((b for m, b in SDPA_BACKENDS if any(m in n for n in hits)), "math")
    if not names:  # the profiler saw no CUDA kernel at all: nothing to name
        backend = "not measured"
    return {"library_backend": backend, "library_kernels": [n[:120] for n in hits[:4]],
            "profiled_kernels": len(names)}


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


def linf_inputs(gen, b: int, f: int, eps: float) -> tuple:
    """(x_adv, x_old, grad, x, step) of one APGD step at (b, f) on the card:
    iterates inside the eps-ball, Gaussian gradients, halved steps on every
    other row (as after a checkpoint)."""
    import torch

    dev = torch.device("cuda")
    x = torch.rand(b, f, generator=gen, device=dev)
    x_adv = (x + (torch.rand(b, f, generator=gen, device=dev) * 2 - 1) * eps).clamp(0, 1)
    x_old = (x + (torch.rand(b, f, generator=gen, device=dev) * 2 - 1) * eps).clamp(0, 1)
    grad = torch.randn(b, f, generator=gen, device=dev)
    step = torch.full((b,), 2 * eps, device=dev)
    step[1::2] = eps
    return x_adv, x_old, grad, x, step


def linf_edge_cases(gen, x_adv, x_old, grad, x, step, eps: float) -> list:
    """Operand sets (x_adv, x_old, grad, x, step) of the step's edge cases,
    from a full-size set: zero, -0.0 and NaN gradients and x at 0 and 1 in
    an odd F (1001: the scalar tail); the full set in contiguous views one
    float past 16-byte alignment; B = 1; and B = 33 at the full F."""
    import torch

    xe, xae, xoe, ge = (t[:, :1001].clone() for t in (x, x_adv, x_old, grad))
    xe[:, :50], xe[:, 50:100] = 0.0, 1.0
    ge[:, 100:150], ge[:, 150:200], ge[:, 200:250] = 0.0, -0.0, float("nan")
    odd = (xae, xoe, ge, xe)
    misaligned = tuple(torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)
                       for t in (x_adv, x_old, grad, x))
    one = tuple(t[:1] for t in (x_adv, x_old, grad, x, step))
    return [(*odd, step), (*misaligned, step), one, linf_inputs(gen, 33, x.shape[1], eps)]


def time_linf_graph_ms(step_fn, sets: list) -> float:
    """`step_fn(x_adv, x_old, grad, x, step)` by CUDA-graph replay, each
    launch taking the next of `sets` (enough that they pass the L2, so every
    operand comes from device memory as in an attack) and writing an output
    of its own."""
    it = iter(range(10**9))
    outs = []
    ms = time_graph_ms(lambda: outs.append(step_fn(*sets[next(it) % len(sets)])))
    outs.clear()
    return ms


def check_linf_step(peaks: dict) -> dict:
    """The l-inf step kernel bitwise against its plain version (a = 1 and
    0.75, at the main path's shape and its edge cases), then timed: kernel
    and plain version by CUDA-graph replay over operand sets rotated past
    the L2 (`ms`, `plain_ms`); `ms_events` is the old reading, CUDA events
    around 200 launches from Python on one set, the host's launch pace that
    an eager attack loop pays."""
    import torch

    from robustvlm_tpu_torch.ops.kernels import attack_step as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, f = LINF_SHAPE
    eps = 2.0 / 255.0
    x_adv, x_old, grad, x, step = linf_inputs(gen, b, f, eps)
    ok, err = True, 0.0
    for args in [(x_adv, x_old, grad, x, step)] + linf_edge_cases(gen, x_adv, x_old, grad, x, step, eps):
        for a in (1.0, 0.75):
            got = K.linf_step_cuda(*args, eps, a)
            ref = K.linf_step_plain(*args, eps, a)
            ok &= _bits_equal(got, ref)
            both = ~(torch.isnan(got) | torch.isnan(ref))
            err = max(err, float((got - ref)[both].abs().max()))
    torch.cuda.synchronize()
    if not ok:
        raise AssertionError("linf_step kernel is not bitwise equal to its plain version")
    n_bytes = 5 * b * f * 4 + b * 4
    sets = _rotating(lambda: tuple(t.clone() for t in (x_adv, x_old, grad, x, step)), n_bytes)
    ms = time_linf_graph_ms(lambda *s: K.linf_step_cuda(*s, eps, 0.75), sets)
    plain_ms = time_linf_graph_ms(lambda *s: K.linf_step_plain(*s, eps, 0.75), sets)
    ms_events = time_ms(lambda: K.linf_step_cuda(x_adv, x_old, grad, x, step, eps, 0.75), iters=200)
    bnd, by = bound_ms(n_bytes, 12 * b * f, "float32", peaks)
    return {"name": "linf_step", "route": "cuda",
            "source": "robustvlm_tpu_torch/csrc/attack_step.cu",
            "replaces": "robustvlm_tpu/ops/pallas/attack_step.py:71",
            "dtype": "float32", "shape": [b, f], "bitwise_equal": True,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "ms_events": ms_events,
            "operand_sets": len(sets), "bound_ms": bnd, "bound_by": by, "library_ms": None,
            "timed_by": {"ms": "graph, operands rotated past the L2",
                         "plain_ms": "graph, operands rotated past the L2",
                         "ms_events": "events around 200 launches from Python, one operand set"}}


def _qkv(n: int, dtype, seed: int, extreme: bool = False, d: int = ATTN_D):
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (ATTN_BH, n, d)
    if extreme:  # every scaled score is -800: far below exp's underflow point
        q = torch.full(shape, 10.0, device=dev)
        k = torch.full(shape, -10.0, device=dev)
    else:
        q = torch.randn(shape, generator=gen, device=dev) * 0.5
        k = torch.randn(shape, generator=gen, device=dev) * 0.5
    v = torch.randn(shape, generator=gen, device=dev) * 0.5
    do = torch.randn(shape, generator=gen, device=dev)
    return [t.to(dtype).contiguous() for t in (q, k, v, do)]


def _attn_check(dname: str, got, ref, extreme: bool, names=ATTN_OUTPUTS) -> dict:
    """The kernels' outputs (o, lse, dq, dk, dv, or those `names` say)
    against the plain version's: {output: (max abs error, within its
    limit)}."""
    import torch

    res = {}
    for name, g, r in zip(names, got, ref):
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
            scale = ref[names.index("dk")] if (extreme and name == "dq") else r
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


# Where each attention kernel's code is: every kernel that both attention
# sources launch lives in a header of csrc/ (float32 forward and backward;
# the bf16 forward; the bf16 backward).
CSRC = "robustvlm_tpu_torch/csrc/"
SHARED_ATTN_KERNELS = {("fwd", "float32"): "attn_f32_tile.cuh", ("bwd", "float32"): "attn_f32_tile.cuh",
                       ("fwd", "bfloat16"): "attn_bf16_fwd.cuh", ("bwd", "bfloat16"): "attn_bf16_bwd.cuh"}


def _attn_source(pass_: str, dname: str, launcher: str) -> dict:
    return {"source": CSRC + SHARED_ATTN_KERNELS.get((pass_, dname), launcher)}


def check_attention(peaks: dict) -> list:
    import torch

    from robustvlm_tpu_torch.ops.kernels import vit_attention as A

    results = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        # worst errors: the D = 64 rows take every case's, the D = 88 rows those at 88
        worst = {d: {"fwd": 0.0, "bwd": 0.0} for d in ATTN_TIMED}
        for n, d, extreme in ATTN_CASES:
            q, k, v, do = _qkv(n, dtype, seed=n + d, extreme=extreme, d=d)
            o, lse = A.attention_fwd_cuda(q, k, v)
            grads = A.attention_bwd_cuda(q, k, v, o, lse, do)
            again = A.attention_bwd_cuda(q, k, v, o, lse, do)
            got = (o, lse, *grads)
            # the plain backward takes the plain forward's residuals, so a
            # wrong O or lse from the kernel shows in the gradients too
            o_ref, lse_ref = A.attention_fwd_plain(q, k, v)
            ref = (o_ref, lse_ref, *A.attention_bwd_plain(q, k, v, o_ref, lse_ref, do))
            res = _attn_check(dname, got, ref, extreme)
            repeatable = all(torch.equal(a, b) for a, b in zip(grads, again))
            ok = all(r[1] for r in res.values()) and repeatable
            line = {"phase": "kernels", "kernel": "vit_attention", "dtype": dname,
                    "n": n, "d": d, "extreme": extreme,
                    "max_abs_err": {name: e for name, (e, _) in res.items()},
                    "within": {name: w for name, (_, w) in res.items()},
                    "bwd_bitwise_repeatable": repeatable,
                    "tol": {"outputs": ATTN_TOL[dname], "relative_to_max_ref": dname != "float32",
                            "lse": LSE_TOL}, "ok": ok}
            if n == 257 and d in ATTN_TIMED and not extreme:
                line["controls_caught"] = _attn_controls(dname, q, k, v, do, got, ref)
                ok = ok and all(line["controls_caught"].values())
            emit(line)
            if not ok:
                raise AssertionError(f"vit_attention {dname} n={n} d={d} extreme={extreme}: "
                                     "disagrees, is not repeatable, or a planted fault passed "
                                     "the check")
            for w in (worst[key] for key in {ATTN_D, d} & worst.keys()):
                w["fwd"] = max(w["fwd"], res["o"][0])
                w["bwd"] = max(w["bwd"], res["dq"][0], res["dk"][0], res["dv"][0])

        # times at the main paths' shapes: ViT-L/14 and ViT-g/14, batch 8;
        # kernels and the library forward by CUDA-graph replay (TIMED_BY)
        for d, sources in ATTN_TIMED.items():
            results += _attn_timed_rows(peaks, dtype, d, worst[d], sources and sources[dname])
    return results


def _attn_timed_rows(peaks: dict, dtype, d: int, worst: dict, launches_from) -> list:
    """The forward and backward rows of the ViT kernels at (B*H = 128, 257,
    d): graph-timed ms, plain ms, bound and SDPA's ms and backend."""
    import torch
    import torch.nn.functional as F

    from robustvlm_tpu_torch.ops.kernels import vit_attention as A

    dname = str(dtype).split(".")[-1]
    n = 257
    q, k, v, do = _qkv(n, dtype, seed=1, d=d)
    o, lse = A.attention_fwd_cuda(q, k, v)
    fwd_ms = time_graph_ms(lambda: A.attention_fwd_cuda(q, k, v))
    fwd_plain = time_ms(lambda: A.attention_fwd_plain(q, k, v))
    bwd_ms = time_graph_ms(lambda: A.attention_bwd_cuda(q, k, v, o, lse, do))
    bwd_plain = time_ms(lambda: A.attention_bwd_plain(q, k, v, o, lse, do))
    q4, k4, v4 = (t.view(8, 16, n, d) for t in (q, k, v))
    lib_fwd = time_graph_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
    do4 = do.view(8, 16, n, d)
    lib_bwd = time_graph_fwd_bwd_ms(F.scaled_dot_product_attention, (ql, kl, vl), do4)
    lib_bwd.update(sdpa_backend(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(ql, kl, vl), (ql, kl, vl), do4)))
    itm = q.element_size()
    elems = ATTN_BH * n * d
    fb, fby = bound_ms(4 * elems * itm + ATTN_BH * n * 4, 4 * ATTN_BH * n * n * d, dname, peaks)
    bb, bby = bound_ms(8 * elems * itm + ATTN_BH * n * 4, 10 * ATTN_BH * n * n * d, dname, peaks)
    tag = dname if d == ATTN_D else f"{dname},d{d}"
    common = {"route": "cuda", "dtype": dname, "shape": [ATTN_BH, n, d]}
    if launches_from:
        common["launches_from"] = launches_from
    return [{"name": f"vit_attention_fwd[{tag}]", **common,
             **_attn_source("fwd", dname, "vit_attention.cu"),
             "replaces": "robustvlm_tpu/ops/pallas/vit_attention.py:157",
             "max_abs_err": worst["fwd"], "ms": fwd_ms, "plain_ms": fwd_plain,
             "bound_ms": fb, "bound_by": fby, "library_ms": lib_fwd,
             "timed_by": TIMED_BY["fwd"]},
            {"name": f"vit_attention_bwd[{tag}]", **common,
             **_attn_source("bwd", dname, "vit_attention.cu"),
             "replaces": "robustvlm_tpu/ops/pallas/vit_attention.py:181",
             "max_abs_err": worst["bwd"], "ms": bwd_ms, "plain_ms": bwd_plain,
             "bound_ms": bb, "bound_by": bby, **lib_bwd,
             "timed_by": TIMED_BY["bwd"]}]


# The bf16 ViT forward at one 336 px image through ViT-L/14-336 (16 heads, 577
# tokens, head dim 64): the tower of every admission and speculative prefill
# in the serving phases.
VIT_SERVE_SHAPE = (16, 577, 64)


def check_vit_serve_row(peaks: dict) -> dict:
    """The ViT forward kernel at VIT_SERVE_SHAPE in bf16 against its plain
    version (ATTN_TOL, LSE_TOL), then timed: the kernel and SDPA by graph
    replay, the plain version by events."""
    import torch
    import torch.nn.functional as F

    from robustvlm_tpu_torch.ops.kernels import vit_attention as A

    bh, n, d = VIT_SERVE_SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(577)
    q, k, v = ((torch.randn(bh, n, d, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
               for _ in range(3))
    got = A.attention_fwd_cuda(q, k, v)
    res = _attn_check("bfloat16", got, A.attention_fwd_plain(q, k, v), False, names=("o", "lse"))
    ok = all(w for _, w in res.values())
    emit({"phase": "kernels", "kernel": "vit_attention", "dtype": "bfloat16", "n": n, "d": d, "bh": bh,
          "max_abs_err": {name: e for name, (e, _) in res.items()},
          "within": {name: w for name, (_, w) in res.items()}, "ok": ok})
    if not ok:
        raise AssertionError(f"vit_attention bf16 at {VIT_SERVE_SHAPE} disagrees with its plain version")
    q4d, k4d, v4d = (t.view(1, bh, n, d) for t in (q, k, v))
    elems = bh * n * d
    bnd, by = bound_ms(4 * elems * 2 + bh * n * 4, 4 * bh * n * n * d, "bfloat16", peaks)
    return {"name": "vit_attention_fwd[bfloat16,336px]", "route": "cuda", "dtype": "bfloat16",
            "shape": list(VIT_SERVE_SHAPE), **_attn_source("fwd", "bfloat16", "vit_attention.cu"),
            "replaces": "robustvlm_tpu/ops/pallas/vit_attention.py:157", "counter": "vit_attention_fwd",
            "launches_from": "serve_continuous", "max_abs_err": res["o"][0],
            "ms": time_graph_ms(lambda: A.attention_fwd_cuda(q, k, v)),
            "plain_ms": time_ms(lambda: A.attention_fwd_plain(q, k, v)),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": time_graph_ms(lambda: F.scaled_dot_product_attention(q4d, k4d, v4d)),
            "timed_by": TIMED_BY["fwd"]}


# Flash attention at the main paths' shapes: the LLaVA-1.5-7B LM layer
# (32 heads, the `llava` phase's teacher-forced sequence at batch 1, head
# dim 128) and the CLIP text tower (96 = 8 prompts x 12 heads, 77 tokens,
# 64), plus ALiBi, key padding, causal with Nq < Nk and the extreme-score
# case, and the edges of the kernels' tiling: one query over fewer keys than
# a tile (the cached-decode shape), causal with Nq > Nk (the first rows see
# no key: O = 0, lse = -1e30), one row past a tile boundary at each head
# dim, ALiBi with key padding at head dim 64, and the one-query, Nq > Nk,
# key-padding and past-a-tile edges at the other head dim. Limits as
# ATTN_TOL/LSE_TOL.
CLIP_TEXT_SHAPE = (96, 77, 64)  # (B*H, N, D) of the text tower on 8 prompts


def _flash_llava_shape(config: str = "llava-1.5-7b") -> tuple:
    """(B*H, Nq, Nk, D) of LLaVA's teacher-forced LM at `config`'s tower:
    576 image tokens (336 px) or the robust 224 px tower's 256."""
    from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS

    n = adapter_seq_len(LLAVA_CONFIGS[config], LLAVA_POST_LEN)
    return (32, n, n, 128)


FLASH_LM_CASES = ("llava_lm", "causal_nq_lt_nk", "extreme")  # the cases whose shape is the LM's


def _flash_cases(config: str = "llava-1.5-7b", lm_only: bool = False) -> list:
    """(label, bh, nq, nk, d, causal, alibi, extreme) of every flash case
    at `config`'s LM length, or of FLASH_LM_CASES alone."""
    bh, n, _, d = _flash_llava_shape(config)
    tbh, tn, td = CLIP_TEXT_SHAPE
    cases = [
        ("llava_lm", bh, n, n, d, True, False, False),
        ("clip_text", tbh, tn, tn, td, True, False, False),
        ("alibi_causal", 32, 300, 300, 128, True, True, False),
        ("keypad_noncausal", 96, 50, 50, 64, False, False, False),
        ("causal_nq_lt_nk", 32, 100, n, 128, True, False, False),
        ("extreme", bh, n, n, d, True, False, True),
        ("one_query_noncausal", 8, 1, 5, 128, False, False, False),
        ("one_query_causal", 8, 1, 5, 128, True, False, False),
        ("causal_nq_gt_nk", 8, 100, 40, 64, True, False, False),
        ("past_tile_d128", 8, 65, 65, 128, True, False, False),
        ("past_tile_d64", 8, 129, 129, 64, True, False, False),
        ("alibi_keypad_noncausal_d64", 8, 50, 50, 64, False, True, False),
        ("one_query_causal_d64", 8, 1, 5, 64, True, False, False),
        ("causal_nq_gt_nk_d128", 8, 100, 40, 128, True, False, False),
        ("keypad_noncausal_d128", 8, 50, 50, 128, False, False, False),
        ("past_tile_one_row_d64", 8, 65, 65, 64, True, False, False),
    ]
    return [c for c in cases if c[0] in FLASH_LM_CASES] if lm_only else cases


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


def check_flash(peaks: dict, config: str = "llava-1.5-7b", dtypes=("float32", "bfloat16"),
                tag: str = "", launches_from: str = "") -> list:
    """The flash kernels against their plain versions (limits ATTN_TOL/
    LSE_TOL, the backward bitwise repeatable, four planted faults caught at
    the LM shape) and their rows, timed at the causal LLaVA LM shape of
    `config` by CUDA-graph replay against SDPA. The default runs every case
    in both dtypes; a `tag` (another config) runs FLASH_LM_CASES alone, tags
    the cases and row names, and takes the launches of `launches_from`."""
    import torch
    import torch.nn.functional as Fn

    from robustvlm_tpu_torch.ops.kernels import flash_attention as F

    results = []
    suffix = f", {tag}" if tag else ""
    for dname in dtypes:
        dtype = getattr(torch, dname)
        worst = {"fwd": 0.0, "bwd": 0.0}
        for label, bh, nq, nk, d, causal, alibi, extreme in _flash_cases(config, lm_only=bool(tag)):
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
            line = {"phase": "kernels", "kernel": "flash_attention", "case": label + (f"[{tag}]" if tag else ""),
                    "dtype": dname, "shape": [bh, nq, nk, d], "causal": causal, "alibi": alibi,
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
        bh, n, _, d = _flash_llava_shape(config)
        (q, k, v, do), _ = _flash_inputs(bh, n, n, d, dtype, seed=1)
        o, lse = F.flash_fwd_cuda(q, k, v, causal=True)
        fwd_ms = time_graph_ms(lambda: F.flash_fwd_cuda(q, k, v, causal=True))
        fwd_plain = time_ms(lambda: F.flash_fwd_plain(q, k, v, causal=True), iters=5)
        bwd_ms = time_graph_ms(lambda: F.flash_bwd_cuda(q, k, v, o, lse, do, causal=True))
        bwd_plain = time_ms(lambda: F.flash_bwd_plain(q, k, v, o, lse, do, causal=True), iters=5)
        q4, k4, v4, do4 = (t.view(1, bh, n, d) for t in (q, k, v, do))
        lib_fwd = time_graph_ms(lambda: Fn.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))

        def sdpa_causal(q_, k_, v_):
            return Fn.scaled_dot_product_attention(q_, k_, v_, is_causal=True)

        lib_bwd = time_graph_fwd_bwd_ms(sdpa_causal, (ql, kl, vl), do4)
        lib_bwd.update(sdpa_backend(lambda: torch.autograd.grad(
            sdpa_causal(ql, kl, vl), (ql, kl, vl), do4)))
        itm = q.element_size()
        elems = bh * n * d
        causal_pairs = bh * n * (n + 1) / 2  # (query, key) pairs the causal mask keeps
        fb, fby = bound_ms(4 * elems * itm + bh * n * 4, 4 * causal_pairs * d, dname, peaks)
        bb, bby = bound_ms(8 * elems * itm + bh * n * 4, 10 * causal_pairs * d, dname, peaks)
        common = {"route": "cuda", "dtype": dname, "shape": [bh, n, d], "causal": True,
                  **({"launches_from": launches_from} if launches_from else {})}
        results.append({"name": f"flash_attention_fwd[{dname}{suffix}]", **common,
                        **_attn_source("fwd", dname, "flash_attention.cu"),
                        "replaces": "robustvlm_tpu/ops/pallas/flash_attention.py:154",
                        "max_abs_err": worst["fwd"], "ms": fwd_ms, "plain_ms": fwd_plain,
                        "bound_ms": fb, "bound_by": fby, "library_ms": lib_fwd,
                        "timed_by": TIMED_BY["fwd"]})
        results.append({"name": f"flash_attention_bwd[{dname}{suffix}]", **common,
                        **_attn_source("bwd", dname, "flash_attention.cu"),
                        "replaces": "robustvlm_tpu/ops/pallas/flash_attention.py:273 (dQ), :295 (dK/dV)",
                        "max_abs_err": worst["bwd"], "ms": bwd_ms, "plain_ms": bwd_plain,
                        "bound_ms": bb, "bound_by": bby, **lib_bwd,
                        "timed_by": TIMED_BY["bwd"]})
        if dtype == torch.float32 and not tag:
            results.append(_flash_clip_text_row(worst["fwd"], peaks))
    return results


def _flash_clip_text_row(max_abs_err: float, peaks: dict) -> dict:
    """The float32 forward at the CLIP text tower's shape (head dim 64,
    causal), as `main[float32]` launches it. The kernel and the library call
    are timed by CUDA-graph replay: a launch this short is paced by the
    host otherwise."""
    import torch
    import torch.nn.functional as Fn

    from robustvlm_tpu_torch.ops.kernels import flash_attention as F

    bh, n, d = CLIP_TEXT_SHAPE
    (q, k, v, _), _ = _flash_inputs(bh, n, n, d, torch.float32, seed=2)
    q4, k4, v4 = (t.view(8, bh // 8, n, d) for t in (q, k, v))
    ms = time_graph_ms(lambda: F.flash_fwd_cuda(q, k, v, causal=True))
    lib = time_graph_ms(lambda: Fn.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
    plain = time_ms(lambda: F.flash_fwd_plain(q, k, v, causal=True), iters=5)
    bnd, by = bound_ms(4 * bh * n * d * 4 + bh * n * 4, 4 * bh * n * (n + 1) / 2 * d, "float32", peaks)
    return {"name": "flash_attention_fwd[float32, head dim 64]", "route": "cuda",
            **_attn_source("fwd", "float32", "flash_attention.cu"), "dtype": "float32",
            "shape": [bh, n, d], "causal": True, "launches_from": "main[float32]",
            "replaces": "robustvlm_tpu/ops/pallas/flash_attention.py:154",
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "library_ms": lib}


# q4_matmul at the LLaVA-1.5-7B decode step's weights: (K, N) and the number
# of launches of each in one step (32 layers x wq/wk/wv/wo, w_gate/w_up,
# w_down; the LM head), batches 1 (a stream step), 4 (the batcher's and a
# continuous step's 4 lanes), 8 (a speculative verify step at k = 7), 9 (an
# odd count: a verify at k = 8; checked, not timed) and 32 (the most the
# kernel takes). Limits as tests/test_torch_q4_matmul.py: bf16 x within
# 2^-7 |ref| + 1e-5 max|ref| per element, float32 x within 1e-5 max|ref|.
# At 8 rows each row must also equal, bit for bit, the same row inside
# another 8-row batch (lane isolation rests on it).
Q4_SHAPES = ((4096, 4096, 128), (4096, 11008, 64), (11008, 4096, 32), (4096, 32000, 1))
Q4_BATCHES = (1, 4, 8, 9, 32)
Q4_UNTIMED = (9,)
# the decode steps that get a row: rows per launch -> the phase whose run
# gives the row its launches
Q4_STEP_ROWS = {1: "serve", 4: "serve_continuous", 8: "serve_speculate"}
Q4_GROUP = 128
L2_BYTES = 50 * 2**20  # H100 L2: timing cycles through more weight copies than this


def _q4_within(got, ref, dname: str):
    import torch

    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    top = float(r.abs().max())
    if dname == "float32":
        return float(diff.max()), bool(diff.max() <= 1e-5 * top)
    return float(diff.max()), bool((diff <= 2.0 ** -7 * r.abs() + 1e-5 * top).all())


def _rotating(make, n_bytes: int) -> list:
    """Enough copies of a weight that cycling through them reads each from
    device memory, as a decode step does (every weight once per step)."""
    return [make() for _ in range(max(2, -(-2 * L2_BYTES // n_bytes)))]


# PyTorch's int4 weight-only matmul (tinygemm) as the library yardstick of
# both q4_matmul rows: with zeros 0 its dequant, w = (q - 8) * scale + zero in
# bf16, is the shift body's w = bf16(bf16(q - 8) * bf16(s)); its float32 sums
# run in another order. It takes the (N, K) codes packed by
# torch._convert_weight_to_int4pack: on CUDA from uint8 (N, K/2), code k = 2i
# in the high nibble of byte i and 2i + 1 in the low one (its meta function's
# input, and the layout of PyTorch's own tests of the op); the CPU twin
# (`_for_cpu`) takes the int32 codes themselves.
Q4_INNER_K_TILES = 8  # K a multiple of 8 * 16 at every 7B shape (4096, 11008)


def tinygemm_operands(p, s):
    """The port's half-split packed weight (p (K/2, N) uint8: row r of W_lo in
    the low nibble, row K/2 + r of W_hi in the high one; s (K/G, 1, N)
    float32, the first K/(2G) groups for W_lo) as the (N, K) int32 codes of
    W = [W_lo; W_hi] and tinygemm's scales_and_zeros (K/G, N, 2) bf16: s
    rounded to bf16, zeros 0."""
    import torch

    codes = torch.cat([p & 0x0F, p >> 4], dim=0).t().to(torch.int32).contiguous()
    sc = s.reshape(s.shape[0], p.shape[1]).to(torch.bfloat16)
    return codes, torch.stack([sc, torch.zeros_like(sc)], dim=-1).contiguous()


def tinygemm_pack(codes):
    """The codes packed for the op on their device."""
    import torch

    if codes.device.type == "cpu":
        return torch._convert_weight_to_int4pack_for_cpu(codes, Q4_INNER_K_TILES)
    pairs = ((codes[:, ::2] << 4) | codes[:, 1::2]).to(torch.uint8)
    return torch._convert_weight_to_int4pack(pairs, Q4_INNER_K_TILES)


def tinygemm_mm(x, packed, group_size: int, sz):
    """x (B, K) bf16 times the packed weight -> (B, N) bf16."""
    import torch

    if x.device.type == "cpu":
        return torch._weight_int4pack_mm_for_cpu(x, packed, group_size, sz)
    return torch._weight_int4pack_mm(x, packed, group_size, sz)


def _q4_library(x, p, s) -> dict:
    """torch._weight_int4pack_mm on the same weight and bf16 x: held first
    against the shift body's plain version at the bf16 limit, then timed by
    CUDA-graph replay over rotated copies; a call that raises or disagrees
    has no time (library_ms None, with library_error)."""
    import torch

    from robustvlm_tpu_torch.ops.kernels import q4_matmul as Q

    group_size = 2 * p.shape[0] // s.shape[0]
    try:
        codes, sz = tinygemm_operands(p, s)
        packed = tinygemm_pack(codes)
        del codes
        got = tinygemm_mm(x, packed, group_size, sz)
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - the op's own error is the finding
        return {"library_ms": None, "library_error": f"{type(e).__name__}: {e}"[:300]}
    err, ok = _q4_within(got, Q.q4_matmul_reference(x, p, s, group=False), "bfloat16")
    res = {"library_max_abs_err_vs_shift_plain": err, "library_within": ok}
    if not ok:
        return {**res, "library_ms": None,
                "library_error": "disagrees with the shift body's plain version"}
    copies = _rotating(lambda: (packed.clone(), sz.clone()), packed.numel() * 4 + sz.numel() * 2)
    it = iter(range(10**9))

    def call():
        pk, z = copies[next(it) % len(copies)]
        tinygemm_mm(x, pk, group_size, z)

    ms = time_graph_ms(call)
    del copies
    return {**res, "library_ms": ms}


def check_q4_matmul(peaks: dict) -> list:
    """Both bodies of the q4_matmul kernel against their plain version at
    every 7B decode shape and batch (and one float32-x case), bitwise
    repeatable, with two planted faults at the MLP up-projection; times
    against bound, plain version, PyTorch's int4 weight-only matmul
    (torch._weight_int4pack_mm, the shift body's function: `library_ms`,
    timed once per shape and bf16 batch and given to both bodies' rows) and
    a bf16 torch.matmul of the same x against the weight held in bf16 (a
    yardstick of a different function: the unquantized decode's read). The
    kernel and both yardsticks are timed by CUDA-graph replay (device time),
    each launch reading its weight from device memory;
    `ms_eager_back_to_back` is the same launch from Python in a loop, which
    the host paces. Rows per body: a decode step at 1, 4 and 8 rows (a
    stream step, a continuous step of 4 lanes, a verify step at k = 7), each
    term summed over its 225 launches (library_ms None if any shape has
    none)."""
    import torch

    from robustvlm_tpu_torch.ops.kernels import q4_matmul as Q
    from robustvlm_tpu_torch.ops.quant import quantize_q4

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    library = {}  # (k, n, b) -> the library's line fields, shared by both bodies
    for body in ("group", "shift"):
        group = body == "group"
        steps = {b: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "yardstick_bf16_matmul_ms": 0.0,
                     "library_ms": 0.0} for b in Q4_STEP_ROWS}
        library_errors = {b: [] for b in Q4_STEP_ROWS}
        worst = 0.0
        for k, n, count in Q4_SHAPES:
            w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
            qw = quantize_q4(w, group_size=Q4_GROUP)
            p, s = qw.p, qw.s
            w16 = w.to(torch.bfloat16)
            del w, qw
            copies = _rotating(lambda: (p.clone(), s.clone()), p.numel() + s.numel() * 4)
            w16s = _rotating(w16.clone, w16.numel() * 2)
            cases = [(b, torch.bfloat16) for b in Q4_BATCHES]
            if (k, n) == (4096, 11008):
                cases.append((4, torch.float32))
            for b, dtype in cases:
                dname = str(dtype).split(".")[-1]
                x = (torch.randn(b, k, generator=gen, device=dev) * 0.5).to(dtype)
                got = Q.q4_matmul_cuda(x, p, s, group=group)
                again = Q.q4_matmul_cuda(x, p, s, group=group)
                ref = Q.q4_matmul_reference(x, p, s, group=group)
                torch.cuda.synchronize()
                err, ok = _q4_within(got, ref, dname)
                repeatable = torch.equal(got, again)
                line = {"phase": "kernels", "kernel": "q4_matmul", "body": body, "dtype": dname,
                        "shape": {"x": [b, k], "packed": [k // 2, n], "scales": list(s.shape)},
                        "max_abs_err": err, "within": ok, "bitwise_repeatable": repeatable}
                if b == 8:  # row 0 inside another batch of 8: bit-equal
                    other = x.clone()
                    other[1:] = (torch.randn(b - 1, k, generator=gen, device=dev) * 0.5).to(dtype)
                    line["rows_independent"] = torch.equal(
                        Q.q4_matmul_cuda(other, p, s, group=group)[0], got[0])
                    repeatable = repeatable and line["rows_independent"]
                if b in Q4_UNTIMED:
                    line["ok"] = ok and repeatable
                    emit(line)
                    if not line["ok"]:
                        raise AssertionError(f"q4_matmul {body} x {b}x{k}, W {k}x{n}: disagrees or "
                                             "is not repeatable")
                    worst = max(worst, err)
                    continue
                if (k, n, b, dtype) == (4096, 11008, 4, torch.bfloat16):
                    swapped = Q.q4_matmul_reference(x, (p >> 4) | (p << 4), s, group=group)
                    shifted = s.clone()
                    shifted[1] = s[2]
                    faults = {"nibbles_swapped": swapped,
                              "group_1_takes_group_2_scales": Q.q4_matmul_reference(x, p, shifted, group=group)}
                    line["controls_caught"] = {f: not _q4_within(got, r, dname)[1] for f, r in faults.items()}
                    ok = ok and all(line["controls_caught"].values())
                it = iter(range(10**9))
                ms = time_graph_ms(lambda: Q.q4_matmul_cuda(x, *copies[next(it) % len(copies)],
                                                            group=group))
                plain_ms = time_ms(lambda: Q.q4_matmul_reference(x, p, s, group=group), iters=3, warmup=1)
                xb = x.to(torch.bfloat16)
                yard = time_graph_ms(lambda: torch.matmul(xb, w16s[next(it) % len(w16s)]))
                host_ms = time_ms(lambda: Q.q4_matmul_cuda(x, p, s, group=group), iters=60)
                lib = {"library_ms": None, "library_error": "the op takes bf16 x only"}
                if dtype == torch.bfloat16:
                    if (k, n, b) not in library:
                        library[k, n, b] = _q4_library(x, p, s)
                    lib = library[k, n, b]
                n_bytes = b * k * x.element_size() + p.numel() + s.numel() * 4 + b * n * x.element_size()
                bnd, by = bound_ms(n_bytes, 2 * b * k * n, "bfloat16", peaks)
                line.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                             **lib, "yardstick_bf16_matmul_ms": yard, "ms_eager_back_to_back": host_ms,
                             "launches_per_7b_step": count, "ok": ok and repeatable})
                emit(line)
                if not (ok and repeatable):
                    raise AssertionError(f"q4_matmul {body} {dname} x {b}x{k}, W {k}x{n}: disagrees, "
                                         "is not repeatable, or a planted fault passed the check")
                worst = max(worst, err)
                if b in Q4_STEP_ROWS and dtype == torch.bfloat16:
                    for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bnd),
                                   ("yardstick_bf16_matmul_ms", yard),
                                   ("library_ms", lib["library_ms"] or 0.0)):
                        steps[b][key] += count * v
                    if lib["library_ms"] is None:
                        library_errors[b].append(f"{k}x{n}: {lib['library_error']}")
            del copies, w16s, p, s, w16
            torch.cuda.empty_cache()
        for b, phase in Q4_STEP_ROWS.items():
            what = {1: "a stream step at batch 1", 4: "a continuous step of 4 lanes",
                    8: "a speculative verify step at k = 7"}[b]
            rows.append({"name": f"q4_matmul[{body}]" if b == 1 else f"q4_matmul[{body},{b} rows]",
                         "route": "cuda", "source": "robustvlm_tpu_torch/csrc/q4_matmul.cu",
                         "replaces": "robustvlm_tpu/ops/pallas/q4_matmul.py:168 ("
                                     + ("_kernel_group :103" if group else "_kernel :66, Q4_KERNEL=shift")
                                     + ")",
                         "dtype": "bfloat16",
                         "counter": f"q4_matmul_{body}" if b == 1 else f"q4_matmul_{body}@{b}",
                         "launches_from": phase,
                         "shape": f"LLaVA-1.5-7B decode, {what}: 225 launches of x ({b}, K), 32 x (4 x "
                                  "4096x4096, 2 x 4096x11008, 11008x4096) + 4096x32000, group 128; "
                                  "each time summed",
                         "max_abs_err": worst, **steps[b], "bound_by": "bytes",
                         "library": "torch._weight_int4pack_mm (zeros 0, bf16 scales; the shift "
                                    "body's function), CUDA-graph replay"})
            if library_errors[b]:
                rows[-1].update({"library_ms": None, "library_error": "; ".join(library_errors[b])})
    return rows


def phase_kernels(peaks: dict) -> list:
    rows = [check_linf_step(peaks)]
    emit({"phase": "kernels", "kernel": "linf_step", "ok": True,
          "bitwise_equal": True, "shape": list(LINF_SHAPE)})
    rows += check_attention(peaks)
    rows += check_flash(peaks)
    rows += check_flash_alibi(peaks, max(flamingo_prompt_lens()))
    # the robust 224 px tower's LM length, as `llava_rob` runs it (bf16)
    rows += check_flash(peaks, "llava-1.5-7b-rob", ("bfloat16",), tag="llava-rob", launches_from="llava_rob")
    rows += check_flash_alibi(peaks, llava_mpt_seq_len(), case="alibi_llava_mpt", tag="llava-mpt",
                              launches_from=LLAVA_MPT_RUNS, launches_cut=LLAVA_MPT_CUT)
    rows.append(check_vit_serve_row(peaks))
    rows += check_q4_matmul(peaks)
    return rows


def _counters() -> list:
    from robustvlm_tpu_torch.ops.kernels import attack_step, flash_attention, q4_matmul, vit_attention

    return [attack_step.LAUNCHES, vit_attention.LAUNCHES, flash_attention.LAUNCHES, q4_matmul.LAUNCHES,
            q4_matmul.LAUNCHES_BY_ROWS]


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
          "argv": argv, "wall_s": wall, "attack_s": result["wall_s"], "clean_acc": result["clean_acc"],
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
    from robustvlm_tpu_torch.models.clip.model import cast_matrices_
    from robustvlm_tpu_torch.ops.losses import ce_loss

    cfg = CLIP_CONFIGS["ViT-L-14"]
    # the CLI's bf16 layout: matrices in bf16, 1-D parameters in float32
    model = cast_matrices_(CLIP(cfg, device="cuda").init_random_(0), torch.bfloat16)
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
# AutoAttack's breadth at ViT-L/14 full width (224 px, N = 257), bf16, on 8
# synthetic images with random weights (seed 0) and `--labels predicted`:
# the card's l1 and hyperplane projections against the CPU's, FAB-T, Square,
# l2 and l1 APGD-CE (decr-eps) and `--full_benchmark`. Random weights are
# fooled at once, so a cascade stops after its first stage; each stage is
# also driven on its own, where it sees every example. Cuts: 10 iterations
# (FAB-T, APGD, the cascade; 20 until PR 12) and 500 Square queries, of the
# default 100 and 5000.
BREADTH_N = 8
BREADTH_ITERS = 10  # cut from 20 for the smoke's time (PR 12)
BREADTH_QUERIES = 500
BREADTH_EPS = {"linf": 2.0, "l2": 127.5, "l1": 3060.0}  # /255: 2/255, 0.5, 12
# The projections sum 150,528 float32 entries a row, as in JAX, and the card
# sums in another order than the CPU: on the inputs below that moved the ball
# by 8.2e-6 and the hyperplane by 1.5e-5 (H100), where the CPU's own float32
# sits 7e-7 and 9e-6 from its float64. float32 is held to 5e-5; the same code
# in float64, where the order no longer shows, to 1e-6 and 1e-5.
PROJ_TOL = {"float32": {"l1_ball_projection": 5e-5, "projection_hyperplane_box": 5e-5},
            "float64": {"l1_ball_projection": 1e-6, "projection_hyperplane_box": 1e-5}}


def breadth_argv(tag: str, *flags) -> list:
    return ["--device", "cuda", "--clip_model_name", "ViT-L-14", "--template", "std",
            "--dataset", "synthetic", "--n_ex", str(BREADTH_N), "--attack_batch", str(BREADTH_N),
            "--batch_size", str(BREADTH_N), "--compute_dtype", "bfloat16", "--labels", "predicted",
            "--n_iter", str(BREADTH_ITERS), "--output_dir", str(OUT / f"breadth-{tag}"), "--save_adv",
            *flags]


def _projections_card_vs_cpu() -> dict:
    """l1_ball_projection and projection_hyperplane_box (each norm) at full
    image size, the card against the CPU on the same numpy draws, in float32
    and in float64 (PROJ_TOL)."""
    import numpy as np
    import torch

    from robustvlm_tpu_torch.attacks.fab import projection_hyperplane_box
    from robustvlm_tpu_torch.ops.projections import l1_ball_projection

    npr = np.random.RandomState(11)
    x = npr.rand(BREADTH_N, 3, 224, 224).astype(np.float32)
    y = (npr.randn(BREADTH_N, 3, 224, 224) * 0.05).astype(np.float32)
    y[0] = 0.0  # an all-zero row: every breakpoint ties
    eps = BREADTH_EPS["l1"] / 255.0
    u = x.reshape(BREADTH_N, -1)
    w = npr.randn(*u.shape).astype(np.float32)
    b = ((w * u).sum(1) - np.abs(npr.randn(BREADTH_N)) * 50.0).astype(np.float32)
    errs, ok = {}, {}
    for dt in ("float32", "float64"):
        def on(a, d):
            return torch.from_numpy(a).to(d, getattr(torch, dt))

        outs = [l1_ball_projection(on(x, d), on(y, d), eps).cpu() for d in ("cuda", "cpu")]
        errs[f"l1_ball_projection[{dt}]"] = float((outs[0] - outs[1]).abs().max())
        for norm in ("linf", "l2", "l1"):
            zs = [projection_hyperplane_box(on(u, d), on(w, d), on(b, d), norm).cpu() for d in ("cuda", "cpu")]
            scale = max(1.0, float(zs[1].abs().max()))
            errs[f"projection_hyperplane_box[{norm},{dt}]"] = float((zs[0] - zs[1]).abs().max()) / scale
        ok.update({k: v <= PROJ_TOL[dt][k.split("[")[0]] for k, v in errs.items() if dt in k})
    return {"max_err": errs, "tol": PROJ_TOL, "ok": ok}


def _adv_checks(x, x_adv, y, logits_fn, norm: str, eps: float) -> dict:
    """x_adv in [0,1] and the eps ball; each example the run changed is
    misclassified when run again (the cascade writes fooled examples only)."""
    import numpy as np
    import torch

    d = x_adv.astype(np.float64) - x
    flat = np.abs(d.reshape(len(x), -1))
    size = {"linf": flat.max(1), "l2": np.sqrt((flat ** 2).sum(1)), "l1": flat.sum(1)}[norm]
    tol = 1e-6 if norm == "linf" else eps * 1e-5
    box_tol = 1e-5 if norm == "l1" else 0.0  # l1 returns x + delta + d unclipped, as JAX
    changed = flat.max(1) > 0
    with torch.no_grad():
        pred = logits_fn(torch.from_numpy(x_adv).cuda()).argmax(-1).cpu().numpy()
    return {"norm_max": float(size.max()), "eps": eps, "fooled": int(changed.sum()),
            "checks": {"finite": bool(np.isfinite(x_adv).all()),
                       "in_box": bool(x_adv.min() >= -box_tol and x_adv.max() <= 1.0 + box_tol),
                       "in_ball": bool((size <= eps + tol).all()),
                       "fooled_on_rerun": bool((pred[changed] != y[changed]).all())}}


def phase_robustbench_breadth() -> dict:
    """FAB-T, Square, l2 and l1 APGD-CE and the standard cascade at ViT-L/14
    through `robustbench.main` (Square through `AutoAttack` on the CLI's own
    classifier), with launches, ms per FAB-T iteration and per Square query
    and peak memory; returns the FAB-T run's launches."""
    import numpy as np
    import torch

    from robustvlm_tpu_torch.attacks.fab import fab_attack
    from robustvlm_tpu_torch.data.loaders import SyntheticClassificationDataset
    from robustvlm_tpu_torch.eval import robustbench
    from robustvlm_tpu_torch.eval.autoattack import VERSIONS, AutoAttack

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    proj = _projections_card_vs_cpu()
    # the CLI's classifier (the same seed-0 weights every CLI run draws)
    args = robustbench.build_parser().parse_args(breadth_argv("model"))
    _, logits_fn, _ = robustbench.build_classifier(args, torch.device("cuda"))
    x, _ = SyntheticClassificationDataset(n=BREADTH_N, size=224).arrays()
    with torch.no_grad():
        y = logits_fn(torch.from_numpy(x).cuda()).argmax(-1).cpu().numpy()

    def cli(tag, norm, *flags):
        _reset_launches()
        t0 = time.perf_counter()
        result = robustbench.main(breadth_argv(tag, "--norm", norm, "--eps", str(BREADTH_EPS[norm]), *flags))
        torch.cuda.synchronize()
        run = {"wall_s": time.perf_counter() - t0, "attack_s": result["wall_s"],
               "cascade": result["cascade"], "launches": _launches()}
        x_adv = np.load(OUT / f"breadth-{tag}" / "x_adv.npy")
        run.update(_adv_checks(x, x_adv, y, logits_fn, norm, BREADTH_EPS[norm] / 255.0))
        return run

    runs = {"fab-t": cli("fab-t", "linf", "--attacks", "fab-t")}
    # ms per FAB-T iteration, timed alone: one target, 5 iterations
    xc, yc = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    fab_attack(logits_fn, xc, yc, n_iter=1, eps=2 / 255, targeted=True, n_target_classes=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fab_attack(logits_fn, xc, yc, n_iter=5, eps=2 / 255, targeted=True, n_target_classes=1)
    torch.cuda.synchronize()
    fab_ms = (time.perf_counter() - t0) / 5 * 1e3

    # Square through AutoAttack on the CLI's classifier; every forward counted
    calls = []

    def counted(xa):
        calls.append(xa.shape[0])
        return logits_fn(xa)

    _reset_launches()
    aa = AutoAttack(counted, eps=BREADTH_EPS["linf"] / 255.0, attacks_to_run=["square"],
                    square_n_queries=BREADTH_QUERIES, verbose=False, device="cuda")
    t0 = time.perf_counter()
    x_adv = aa.run_standard_evaluation(x, y, bs=BREADTH_N, run_checks=False).numpy()
    torch.cuda.synchronize()
    sq_s = time.perf_counter() - t0
    sq_calls = len(calls) - 2  # less the clean pass and the re-check after the stage
    d = np.abs(x_adv.astype(np.float64) - x)
    on_vertex = (np.abs(d - BREADTH_EPS["linf"] / 255.0) <= 1e-6) | (x_adv == 0.0) | (x_adv == 1.0)
    runs["square"] = {"wall_s": sq_s, "cascade": aa.robust_accuracy_dict, "launches": _launches(),
                      "queries": sq_calls, "ms_per_query": sq_s / max(sq_calls, 1) * 1e3,
                      **_adv_checks(x, x_adv, y, logits_fn, "linf", BREADTH_EPS["linf"] / 255.0)}
    runs["square"]["checks"].update({
        "queries_within_budget": 1 <= sq_calls <= BREADTH_QUERIES,
        "delta_on_vertices": bool(on_vertex[d > 0].all()) and bool((d > 0).any()),
        "no_vit_backward": runs["square"]["launches"]["vit_attention_bwd"] == 0})

    runs["apgd-ce[l2]"] = cli("l2", "l2", "--attacks", "apgd-ce")
    runs["apgd-ce[l1]"] = cli("l1", "l1", "--attacks", "apgd-ce")
    runs["full_benchmark"] = cli("full", "linf", "--full_benchmark")
    stages = [k for k in runs["full_benchmark"]["cascade"] if k != "clean"]

    for name in ("fab-t", "apgd-ce[l2]", "apgd-ce[l1]"):
        la = runs[name]["launches"]
        runs[name]["checks"].update({"vit_fwd_bwd_launched": _launched(la, CLIP_KERNELS[1:]),
                                     "no_linf_step": la["linf_step"] == 0})
    runs["full_benchmark"]["checks"]["standard_order"] = (
        bool(stages) and stages == VERSIONS["standard"][: len(stages)])
    checks = {f"{name}.{k}": v for name, r in runs.items() for k, v in r["checks"].items()}
    checks.update({f"projections.{k}": v for k, v in proj["ok"].items()})
    emit({"phase": "robustbench_breadth", "entry": "robustvlm_tpu_torch.eval.robustbench.main",
          "model": "ViT-L-14", "compute_dtype": "bfloat16", "n_ex": BREADTH_N, "n_iter": BREADTH_ITERS,
          "square_queries": BREADTH_QUERIES, "projections": proj, "runs": runs,
          "full_benchmark_stopped_after": stages[-1] if stages else None,
          "fab_t_ms_per_iter": fab_ms, "square_ms_per_query": runs["square"]["ms_per_query"],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "phase_s": time.perf_counter() - t_phase, "card": card_line(),
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"robustbench_breadth checks failed: {[k for k, v in checks.items() if not v]}")
    return runs["fab-t"]["launches"]


# ------------------------------------------------------------------ phases 7-8
# TeCoA/FARE fine-tuning (BASELINE.json configs 3-4) through the training CLI
# at ViT-L/14 full width. Cut: 3 steps of 20,000; batch 32 of the paper's 128,
# in 4 chunks of 8 (--grad_accum); random weights from seed 0; synthetic
# images. Each run's linf_step launches are exact: 10 APGD iterations x 4
# chunks x 3 steps for fare4 (no text embedding, so no eval); none from PGD
# and 50 from the APGD-50 eval after step 1 for tecoa2.
TRAIN_COMMON = ["--device", "cuda", "--clip_model_name", "ViT-L-14", "--dataset", "synthetic",
                "--batch_size", "32", "--grad_accum", "4", "--steps", "3", "--warmup", "1"]
TRAIN_RUNS = {
    "fare4": ["--loss", "l2", "--inner_loss", "l2", "--attack", "apgd", "--eps", "4",
              "--iterations_adv", "10", "--compute_dtype", "float32"],
    "tecoa2": ["--loss", "ce", "--inner_loss", "ce", "--attack", "pgd", "--eps", "2",
               "--stepsize_adv", "1", "--iterations_adv", "10", "--compute_dtype", "bfloat16"],
}
TRAIN_LINF_LAUNCHES = {"fare4": 10 * 4 * 3, "tecoa2": 50}
TRAIN_CUTS = ["3 steps of 20,000", "batch 32 of 128, in 4 chunks of 8", "random weights (seed 0)",
              "synthetic images"]
# train_reference's limits, relative, on the loss and in norm on each
# gradient leaf, against the plain path on the CPU in float32. bf16 keeps 8
# significant bits (2^-9 relative rounding) in every activation of the
# forward and the backward; its limits leave room for that rounding and
# none for a wrong kernel, whose error is of the order of the value itself.
TRAIN_REF_TOL = {"float32": {"loss_rel": 1e-5, "grad_rel": 1e-4},
                 "bfloat16": {"loss_rel": 1e-2, "grad_rel": 5e-2}}
# (loss, dtype on the card). TeCoA's cross-entropy at logit scale 100 is not
# compared in bf16: with random weights its softmax is near saturation, and
# bf16's rounding of the embedding moves the margins between the top logits
# by about their own size, so its gradients differ from float32's by more
# than any kernel does. FARE's l2 loss runs the same bf16 kernels.
TRAIN_REF_CASES = (("l2", "float32"), ("ce", "float32"), ("l2", "bfloat16"))


def phase_train_reference() -> dict:
    """One outer loss and its weight gradients through the kernels on the
    card against the plain versions on the CPU in float32: ViT-L/14 widths
    cut to 2 layers, batch 4, on the same fixed x_adv; FARE (l2 to a frozen
    original of other weights) and TeCoA (ce against class embeddings) in
    float32, and FARE in bf16 on the card (`train[tecoa2]`'s compute
    dtype)."""
    import dataclasses

    import numpy as np
    import torch

    from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS
    from robustvlm_tpu_torch.train.trainer import TrainConfig, TrainStep

    t0 = time.perf_counter()
    full = CLIP_CONFIGS["ViT-L-14"]
    cfg = dataclasses.replace(full, vision=dataclasses.replace(full.vision, layers=2),
                              text=dataclasses.replace(full.text, layers=2))
    npr = np.random.RandomState(0)
    x = npr.rand(4, 3, cfg.image_size, cfg.image_size).astype(np.float32)
    x_adv = np.clip(x + np.sign(npr.randn(*x.shape)) * 4 / 255, 0, 1).astype(np.float32)
    y = npr.randint(0, 10, 4)
    temb = npr.randn(cfg.embed_dim, 10).astype(np.float32)
    temb /= np.linalg.norm(temb, axis=0, keepdims=True)
    cpu, cpu_orig = CLIP(cfg, device="cpu").init_random_(0), CLIP(cfg, device="cpu").init_random_(1)

    def loss_and_grads(loss, dev, dtype):
        tcfg = TrainConfig(loss=loss, inner_loss=loss, attack="none", compute_dtype=dtype)
        model, orig = CLIP(cfg, device=dev), CLIP(cfg, device=dev)
        model.load_state_dict(cpu.state_dict())
        orig.load_state_dict(cpu_orig.state_dict())
        step = TrainStep(tcfg, model, orig, torch.from_numpy(temb).to(dev))
        xs, xas, ys = (torch.from_numpy(a).to(dev) for a in (x, x_adv, y))
        total, _ = step.outer_loss(xs, ys, xas, step.frozen_embedding(xs))
        names, params = zip(*model.visual.named_parameters())
        grads = torch.autograd.grad(total, params)
        return float(total.detach()), {n: g.detach().cpu().double() for n, g in zip(names, grads)}

    witness = {loss: loss_and_grads(loss, "cpu", "float32") for loss in {c[0] for c in TRAIN_REF_CASES}}
    res, launches, checks = {}, {}, {}
    for loss, dtype in TRAIN_REF_CASES:
        key = f"{loss}[{dtype}]"
        _reset_launches()
        got = loss_and_grads(loss, "cuda", dtype)
        torch.cuda.synchronize()
        launches[key] = _launches()
        ref = witness[loss]
        loss_rel = abs(got[0] - ref[0]) / abs(ref[0])
        g_rel = {n: float((got[1][n] - g).norm() / g.norm()) for n, g in ref[1].items()
                 if float(g.norm()) > 0}
        res[key] = {"loss": ref[0], "loss_rel_err": loss_rel, "grad_rel_err_max": max(g_rel.values()),
                    "grad_rel_err_worst_leaf": max(g_rel, key=g_rel.get), "leaves": len(g_rel)}
        tol = TRAIN_REF_TOL[dtype]
        checks[f"{key}_loss_rel"] = loss_rel <= tol["loss_rel"]
        checks[f"{key}_grad_rel"] = res[key]["grad_rel_err_max"] <= tol["grad_rel"]
    checks["launched"] = all(_launched(v, ("vit_attention_fwd", "vit_attention_bwd"))
                             for v in launches.values())
    emit({"phase": "train_reference", "model": "ViT-L-14 widths, 2 layers", "witness": "cpu float32",
          "batch": 4, "results": res, "tol": TRAIN_REF_TOL, "launches": launches,
          "wall_s": time.perf_counter() - t0, "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"train_reference checks failed: {checks}")
    return launches["l2[float32]"]


def phase_train(name: str) -> dict:
    """`driver.main` (the training CLI) at ViT-L/14 full width for 3 steps,
    then checks: every loss finite, the weights moved and the frozen
    original did not, one chunk's x_adv inside the eps-ball and [0, 1] with
    its inner loss above clean, and the visual tower exported as the
    checkpoint manager writes `final.pt` loading back through
    `visual_from_openai` to the same embedding."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from robustvlm_tpu_torch.attacks.apgd import fold_in
    from robustvlm_tpu_torch.data.loaders import SyntheticClassificationDataset
    from robustvlm_tpu_torch.models.clip import CLIP, visual_from_openai
    from robustvlm_tpu_torch.ops.image import normalize_clip
    from robustvlm_tpu_torch.train import driver
    from robustvlm_tpu_torch.utils.checkpoint import CheckpointManager

    # the run's files (a 1.2 GB export) go to a temporary directory
    out = Path(tempfile.mkdtemp(prefix=f"train-{name}-"))
    argv = TRAIN_COMMON + TRAIN_RUNS[name] + ["--output_dir", str(out), "--save_checkpoints", "false"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    try:
        run = driver.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        recs = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()]
        steps = [r for r in recs if "loss" in r]
        cfg, ts = run.model.cfg, run.train_step
        eps = ts.cfg.eps

        moved = any(not torch.equal(a, b) for a, b in zip(run.model.visual.parameters(),
                                                          run.model_orig.visual.parameters()))
        fresh = CLIP(cfg, device="cuda").init_random_(0)
        frozen = all(torch.equal(a, b) for a, b in zip(run.model_orig.parameters(), fresh.parameters()))
        del fresh

        x, y = SyntheticClassificationDataset(n=8, size=cfg.image_size).arrays()
        x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
        emb_orig = ts.frozen_embedding(x)
        x_adv = ts.inner_attack(x, y, emb_orig, fold_in(fold_in(1, 0), 0))
        with torch.no_grad():
            inner_adv, inner_clean = (float(ts.inner_loss(t, y, emb_orig)) for t in (x_adv, x))
        linf = float((x_adv - x).abs().max())

        t_exp = time.perf_counter()
        path = CheckpointManager(str(out), 3).export_torch_visual(run.model, cfg)
        sd = run.model.state_dict()
        sd.update(visual_from_openai(torch.load(path), cfg))
        back = CLIP(cfg, device="cuda")
        back.load_state_dict(sd)
        with torch.no_grad():
            same = torch.equal(back.encode_image(normalize_clip(x[:2])),
                               run.model.encode_image(normalize_clip(x[:2])))
        export_s = time.perf_counter() - t_exp
        del back, sd
    finally:
        shutil.rmtree(out, ignore_errors=True)
    step_s = [r["step_s"] for r in steps]
    batch = int(argv[argv.index("--batch_size") + 1])
    kernels = ("linf_step", "vit_attention_fwd", "vit_attention_bwd")
    checks = {
        "steps": [r["step"] for r in steps] == [1, 2, 3],
        "losses_finite": all(math.isfinite(r["loss"]) and math.isfinite(r["loss_total"]) for r in steps),
        "weights_moved": moved, "frozen_unchanged": frozen,
        "x_adv_in_ball": linf <= eps + 1e-6,
        "x_adv_in_box": float(x_adv.min()) >= 0.0 and float(x_adv.max()) <= 1.0,
        "inner_loss_above_clean": inner_adv > inner_clean,
        "export_round_trip": same,
        "linf_step_launches": launches["linf_step"] == TRAIN_LINF_LAUNCHES[name],
        "launched": _launched(launches, kernels)
        and (name != "tecoa2" or launches["flash_attention_fwd"] > 0),
        "eval": (run.eval_metrics is not None) == (name == "tecoa2"),
    }
    emit({"phase": f"train[{name}]", "entry": "robustvlm_tpu_torch.train.driver.main", "argv": argv,
          "cuts": TRAIN_CUTS, "wall_s": wall, "run_wall_s": run.wall_s,
          "s_per_step": step_s, "imgs_per_sec": batch / (sum(step_s[1:]) / len(step_s[1:])),
          "imgs_per_sec_cli": steps[-1]["imgs_per_sec"], "peak_mem_gib": peak,
          "loss": [r["loss"] for r in steps], "cos_sim": [r["cos_sim"] for r in steps],
          "eval": run.eval_metrics, "x_adv_linf": linf, "eps": eps,
          "inner_loss": {"clean": inner_clean, "x_adv": inner_adv}, "export_s": export_s,
          "launches": launches, "expected_linf_step_launches": TRAIN_LINF_LAUNCHES[name],
          "card": card_line(), "checks": checks, "ok": all(checks.values())})
    del run
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"train[{name}] checks failed: {checks}")
    return launches


# ------------------------------------------------------------------ phase 9
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
    (1e-3 rel). On the card the same loss and gradient with `remat=True`
    (each block recomputed in the backward, the flash forward run again)
    must equal them bit for bit. Returns the kernels' launches of the
    card's run without remat."""
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
            adapter.remat = True
            _reset_launches()
            loss_r = adapter(xa)
            (grad_r,) = torch.autograd.grad(loss_r.sum(), xa)
            torch.cuda.synchronize()
            remat = {"loss_bit_equal": bool(torch.equal(loss_r, loss)),
                     "grad_bit_equal": bool(torch.equal(grad_r, grad)),
                     "grad_max_abs_diff": float((grad_r - grad).abs().max()), "launches": _launches()}
        out[dev] = (loss.detach().cpu().double(), grad.cpu().double())
        del model, adapter
    loss_rel = float(((out["cuda"][0] - out["cpu"][0]).abs() / out["cpu"][0].abs()).max())
    g_rel = float((out["cuda"][1] - out["cpu"][1]).norm() / out["cpu"][1].norm())
    checks = {"loss_rel": loss_rel <= 1e-4, "grad_rel": g_rel <= 1e-3,
              "finite": bool(torch.isfinite(out["cuda"][1]).all()),
              "launched": _launched(launches, ("vit_attention_fwd", "vit_attention_bwd",
                                               "flash_attention_fwd", "flash_attention_bwd")),
              "remat_loss_bit_equal": remat["loss_bit_equal"], "remat_grad_bit_equal": remat["grad_bit_equal"],
              # recompute: each block's flash forward once more, the backward once
              "remat_flash_recomputed": (remat["launches"]["flash_attention_fwd"]
                                         == 2 * launches["flash_attention_fwd"]
                                         and remat["launches"]["flash_attention_bwd"]
                                         == launches["flash_attention_bwd"])}
    emit({"phase": "llava_reference", "model": cfg.name, "dtype": "float32", "batch": 1,
          "seq_len": int(adapter_seq_len(cfg)), "loss": float(out["cpu"][0][0]),
          "loss_rel_err": loss_rel, "grad_rel_err": g_rel, "tol": {"loss_rel": 1e-4, "grad_rel": 1e-3},
          "launches": launches, "remat": remat, "card": card_line(), "wall_s": time.perf_counter() - t0,
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


# ------------------------------------------------------------------ phase 10
LLAVA_EPS = 2.0  # /255
LLAVA_IMAGES = [  # COCO-style references, two images
    ["a man riding a wave on top of a surfboard", "a surfer rides a large wave in the ocean",
     "a person on a surfboard in the water", "a surfer catching a wave", "a man surfing a big wave"],
    ["a plate of food with broccoli and rice", "a white plate topped with rice and vegetables",
     "broccoli and chicken on a plate", "a meal of rice and broccoli", "a dinner plate with food"],
]


def _coco_fixture(root: Path, captions=LLAVA_IMAGES) -> tuple:
    """Seeded 400x360 RGB images, one a caption list, and a COCO-format
    annotations json."""
    import numpy as np
    from PIL import Image

    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i, caps in enumerate(captions):
        name = f"COCO_val2014_{i:012d}.png"
        Image.fromarray(rng.randint(0, 255, (360, 400, 3), np.uint8)).save(img_dir / name)
        images.append({"id": i, "file_name": name})
        anns += [{"image_id": i, "caption": c} for c in caps]
    ann = root / "captions.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns}))
    return img_dir, ann


LLAVA_ITERS = 25  # cut from 100 for the smoke's time (PR 12)


def phase_llava() -> dict:
    """`run_evaluation.main` at LLaVA-1.5-7B full width (32 LM layers, the
    336 px tower), random weights from seed 0, bf16 APGD (--attack apgd, the
    half-precision untargeted run), eps 2/255, LLAVA_ITERS iterations, 2 images.
    PIL imports on the card, so the CLI reads a COCO-format fixture written
    here. Then the loss at x_adv is recomputed against the clean loss, and
    `llava_remat_iteration` takes one iteration's loss and pixel gradient
    with `LlavaEvalModel(remat=True)` and without."""
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
            "--attack", "apgd", "--eps", str(LLAVA_EPS), "--n_iter", str(LLAVA_ITERS), "--num_samples", "2",
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
    remat = llava_remat_iteration(model, ds[0], out_dir)
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
        "iterations": result["attack_iters"] == LLAVA_ITERS * len(per_image),
        "remat_loss_equal": remat["loss"][True] == remat["loss"][False],
        "remat_grad_within_bf16_tol": remat["grad_max_abs_diff"] <= ATTN_TOL["bfloat16"] * remat["grad_max_abs"],
        "remat_flash_recomputed": remat["flash_attention_fwd"][True] == 2 * remat["flash_attention_fwd"][False],
    }
    emit({"phase": "llava", "entry": "robustvlm_tpu_torch.vlm_eval.run_evaluation.main",
          "argv": argv, "model": cfg.name, "dtype": "bfloat16", "seq_len": adapter_seq_len(cfg, LLAVA_POST_LEN),
          "wall_s": wall, "attack_s": result["attack_s"], "attack_iters": result["attack_iters"],
          "ms_per_apgd_iter": ms_per_iter, "peak_mem_gib": peak_run, "cider": result["cider"],
          "per_image": per_image, "eps": LLAVA_EPS / 255.0, "launches": launches, "remat": remat,
          "card": card_line(), "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"llava checks failed: {checks}")
    return launches


def llava_remat_iteration(model, item, out_dir: Path) -> dict:
    """The loss and pixel gradient of one APGD iteration (its forward and
    backward) at `item`'s x_adv, bf16, full width, through
    `LlavaEvalModel(remat=False)` and `(remat=True)` on the same weights, in
    turns (without, with, with, without): each one's loss, peak memory above
    what is held, ms (both turns) and flash launches (keyed by remat), and
    the gradients' max abs difference."""
    import numpy as np
    import torch

    from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel, WordTokenizer

    x = torch.from_numpy(np.load(out_dir / "coco" / "adv" / f"{item['image_id']}.npy")[None]).cuda()
    res = {k: {} for k in ("loss", "peak_gib", "ms", "flash_attention_fwd", "flash_attention_bwd")}
    grads = {}
    for remat in (False, True, True, False):
        adapter = LlavaEvalModel(model, WordTokenizer(), compute_dtype=torch.bfloat16, remat=remat)
        adapter.set_inputs([adapter.get_caption_prompt(item["all_captions"][0])])
        xa = x.clone().requires_grad_(True)
        _free()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t = time.perf_counter()
        loss = adapter(xa)
        (grads[remat],) = torch.autograd.grad(loss.sum(), xa)
        torch.cuda.synchronize()
        res["ms"].setdefault(remat, []).append((time.perf_counter() - t) * 1e3)
        res["peak_gib"][remat] = (torch.cuda.max_memory_allocated() - held) / 2**30
        res["loss"][remat] = float(loss.detach()[0])
        for k in ("flash_attention_fwd", "flash_attention_bwd"):
            res[k][remat] = _launches()[k]
    res["grad_max_abs_diff"] = float((grads[True] - grads[False]).abs().max())
    res["grad_max_abs"] = float(grads[False].abs().max())
    res["grad_bit_equal"] = bool(torch.equal(grads[True], grads[False]))
    return res


# ------------------------------------------------------------------ phase 12
LLAVA_ENSEMBLE_ITERS = 5


class _FullStageLaunches(dict):
    """`build_llava_models`' (or `build_models`') result; notes the launch
    counts when the float32 model is first taken, at the start of the
    ensemble's last stage, the only one that runs it."""

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
    schedule = run_evaluation.attack_schedule(args)
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
    del adapter
    vqa = llava_ensemble_vqa(built, out_dir)
    del models, built
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
        **{f"vqa_{k}": v for k, v in vqa.pop("checks").items()},
    }
    emit({"phase": "llava_ensemble", "entry": "robustvlm_tpu_torch.vlm_eval.run_evaluation."
          "evaluate_captioning", "argv": argv, "threshold": "-inf", "model": "llava-1.5-7b",
          "stages": len(schedule), "iters_per_stage": LLAVA_ENSEMBLE_ITERS, "wall_s": wall,
          "attack_s": result["attack_s"], "attack_iters": result["attack_iters"],
          "float32_ms_per_loss_and_grad": fp32_ms, "weights_allocated_gib": allocated / 2**30,
          "held_tensor_gib": sum(held.values()) / 2**30, "peak_mem_gib": peak,
          "launches": total, "launches_float32_stage": full, "linf": linf,
          "cider": result["cider"], "vqa": vqa, "card": card_line(), "checks": checks,
          "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"llava_ensemble checks failed: {checks}")
    return full


def llava_ensemble_vqa(built: dict, out_dir: Path) -> dict:
    """`evaluate_vqa --attack ensemble` on one question of the `llava_vqa`
    fixture over the models `llava_ensemble` already holds, threshold -inf:
    the clean pass, 5 bf16 gt stages, the targeted 'maybe' and 'Word' stages
    and the float32 prev-best stage, LLAVA_ENSEMBLE_ITERS iterations each.
    Returns its numbers and checks."""
    import torch

    from robustvlm_tpu_torch.vlm_eval import run_evaluation as R

    img_dir, qf, af = _vqa_fixture(OUT / "llava-vqa")
    argv = vqa_argv("vqav2", img_dir, qf, af, out_dir, "--attack", "ensemble", "--n_iter",
                    str(LLAVA_ENSEMBLE_ITERS), "--num_samples", "1")
    args = R.build_parser().parse_args(argv)
    schedule = R.attack_schedule(args, "vqa")
    models = _FullStageLaunches(built)
    _reset_launches()
    t0 = time.perf_counter()
    result = R.evaluate_vqa(args, "vqav2", models=models, threshold=-math.inf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = _launches()
    full = {k: total[k] - models.at_full[k] for k in total}
    state = json.loads((out_dir / "vqav2" / "ensemble_state.json").read_text())
    stages = [(s.kind, s.precision, s.target_str) for s in schedule]
    checks = {
        "every_stage_ran": state["stages_done"] == len(schedule) == 9,
        "targeted_maybe_word": stages[6:8] == [("apgd", "half", "maybe"), ("apgd", "half", "Word")],
        "float32_prev_best_last": schedule[-1].precision == "full" and schedule[-1].init_from_best,
        "float32_stage_launched_flash": _launched(full, ("flash_attention_fwd", "flash_attention_bwd")),
        "iterations": result["attack_iters"] == 8 * LLAVA_ENSEMBLE_ITERS,
        "question_key": (len(state["ids"]) == 1 and set(state["best_outputs"]) == set(state["ids"])
                         and state["ids"][0] in {str(q[0]) for q in VQA_QUESTIONS}),
        "vqa_accuracy": math.isfinite(result["vqa_accuracy"]),
    }
    return {"argv": argv, "threshold": "-inf", "stages": len(schedule), "wall_s": wall,
            "attack_s": result["attack_s"], "attack_iters": result["attack_iters"],
            "vqa_accuracy": result["vqa_accuracy"], "launches": total, "launches_float32_stage": full,
            "checks": checks}


# ------------------------------------------------------------------ VQA fixtures
# 10 of the CLI's 100 iterations: cut for the smoke's time (the bf16 flash
# rows take their launches from `llava`, not from here)
VQA_ITERS = 10
VQA_QUESTIONS = [  # (question_id, image_id, question, 10 annotator answers): 2 on the first image
    (70, 7, "what is the man riding?", ["surfboard"] * 6 + ["wave"] * 3 + ["board"]),
    (71, 7, "is the water calm?", ["no"] * 8 + ["yes"] * 2),
    (110, 11, "what vegetable is on the plate?", ["broccoli"] * 7 + ["rice"] * 2 + ["vegetables"]),
]


def _vqa_fixture(root: Path, layout: str = "vqav2", questions=VQA_QUESTIONS) -> tuple:
    """Seeded 400x360 RGB JPEGs and VQAv2-format questions and annotations
    jsons: images named `COCO_val2014_%012d.jpg` (VQAv2, OK-VQA) or
    `{image_id}.jpg` (TextVQA, VizWiz)."""
    import numpy as np
    from PIL import Image

    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    for iid in sorted({q[1] for q in questions}):
        name = f"COCO_val2014_{iid:012d}.jpg" if layout == "vqav2" else f"{iid}.jpg"
        Image.fromarray(rng.randint(0, 255, (360, 400, 3), np.uint8)).save(img_dir / name, quality=95)
    qf, af = root / "questions.json", root / "annotations.json"
    qf.write_text(json.dumps({"questions": [{"question_id": q, "image_id": i, "question": t}
                                            for q, i, t, _ in questions]}))
    af.write_text(json.dumps({"annotations": [{"question_id": q, "answers": [{"answer": a} for a in ans]}
                                              for q, _, _, ans in questions]}))
    return img_dir, qf, af


def vqa_argv(dataset: str, img_dir, qf, af, out_dir, *flags) -> list:
    return ["--device", "cuda", "--model", "llava", "--model_size", "7b", f"--eval_{dataset}",
            f"--{dataset}_image_dir", str(img_dir), f"--{dataset}_questions", str(qf),
            f"--{dataset}_annotations", str(af), "--eps", str(LLAVA_EPS), "--max_new_tokens", "16",
            "--out_base_path", str(out_dir), "--verbose", *flags]


@contextlib.contextmanager
def adapters_of_cli(module, seen: dict):
    """`module.build_eval_model` wrapped for the duration: each adapter the
    CLI builds is kept in seen[precision]."""
    orig = module.build_eval_model

    def build(args, precision, models=None):
        seen[precision] = orig(args, precision, models)
        return seen[precision]

    module.build_eval_model = build
    try:
        yield seen
    finally:
        module.build_eval_model = orig


def _free() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 11
def phase_llava_vqa() -> dict:
    """`run_evaluation.main --eval_vqav2` at LLaVA-1.5-7B full width, random
    weights from seed 0, bf16, a targeted APGD run (--attack apgd --targeted
    --target_str maybe), eps 2/255, VQA_ITERS iterations on each of the 3
    questions of a VQAv2-layout fixture (2 share an image). Then, on the
    CLI's own adapter, the target's teacher-forced loss at each x_adv against
    the clean image. Returns the kernels' launches."""
    import numpy as np
    import torch

    from robustvlm_tpu_torch.vlm_eval import run_evaluation as R
    from robustvlm_tpu_torch.vlm_eval.datasets import VQADataset

    _free()
    root = OUT / "llava-vqa"
    img_dir, qf, af = _vqa_fixture(root)
    out_dir = root / "out"
    argv = vqa_argv("vqav2", img_dir, qf, af, out_dir, "--attack", "apgd", "--targeted", "--target_str",
                    "maybe", "--n_iter", str(VQA_ITERS), "--num_samples", str(len(VQA_QUESTIONS)))
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with adapters_of_cli(R, {}) as seen:
        result = R.main(argv)["vqav2"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated() / 2**30

    adapter = seen["half"]
    args = R.build_parser().parse_args(argv)
    ds = VQADataset(str(img_dir), str(qf), str(af), size=R._image_size(args),
                    **R.vqa_layout_for_dir("vqav2", str(img_dir)))
    state = json.loads((out_dir / "vqav2" / "ensemble_state.json").read_text())
    per_q = []
    with torch.no_grad():
        for k in range(len(ds)):
            item = ds[k]
            qid = str(item["question_id"])
            x = np.asarray(item["image"], np.float32)
            x_adv = np.load(out_dir / "vqav2" / "adv" / f"{qid}.npy")
            adapter.set_inputs([adapter.get_vqa_prompt(item["question"], "maybe")])
            losses = [float(adapter(torch.from_numpy(a[None]).cuda())[0]) for a in (x, x_adv)]
            per_q.append({"question_id": qid, "image_id": item["image_id"], "target_loss_clean": losses[0],
                          "target_loss_adv": losses[1], "linf": float(np.abs(x_adv.astype(np.float64) - x).max()),
                          "in_box": bool(x_adv.min() >= 0.0 and x_adv.max() <= 1.0),
                          "answer": state["best_outputs"].get(qid)})
    del adapter, seen
    _free()
    checks = {
        "in_box": all(r["in_box"] for r in per_q),
        "in_ball": all(r["linf"] <= LLAVA_EPS / 255.0 + 1e-6 for r in per_q),
        "target_loss_fell": all(r["target_loss_adv"] < r["target_loss_clean"] for r in per_q),
        "scored_per_question": sorted(state["best_outputs"]) == sorted(str(q[0]) for q in VQA_QUESTIONS)
        and all(isinstance(r["answer"], str) for r in per_q),
        "vqa_accuracy": math.isfinite(result["vqa_accuracy"]),
        "success_rate": math.isfinite(result["success_rate"]),
        "iterations": result["attack_iters"] == VQA_ITERS * len(VQA_QUESTIONS),
        "launched": _launched(launches, LLAVA_KERNELS),
    }
    emit({"phase": "llava_vqa", "entry": "robustvlm_tpu_torch.vlm_eval.run_evaluation.main",
          "argv": argv, "model": "llava-1.5-7b", "dtype": "bfloat16", "wall_s": wall,
          "attack_s": result["attack_s"], "attack_iters": result["attack_iters"],
          "ms_per_apgd_iter": result["attack_s"] / result["attack_iters"] * 1e3, "peak_mem_gib": peak,
          "vqa_accuracy": result["vqa_accuracy"], "success_rate": result["success_rate"],
          "per_question": per_q, "eps": LLAVA_EPS / 255.0, "launches": launches, "card": card_line(),
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"llava_vqa checks failed: {checks}")
    return launches


# ------------------------------------------------------------------ phase 13
ROB_ITERS = 25  # cut from 100 for the smoke's time (PR 12)
ROB_QUESTIONS = VQA_QUESTIONS[:1]
ROB_SHARD_LAYERS = 4  # LM layers a shard: 8 shards of about 1.6 GB + one of the rest


def hf_llava_names(cfg) -> dict:
    """The port's LM and projector names -> (HF LLaVA-1.5 key, transposed),
    written out independently of the importer, which inverts it."""
    names = {"llama.tok_embedding": ("model.embed_tokens.weight", False),
             "llama.norm": ("model.norm.weight", False), "llama.lm_head": ("lm_head.weight", True),
             "projector.w1": ("model.mm_projector.0.weight", True),
             "projector.b1": ("model.mm_projector.0.bias", False),
             "projector.w2": ("model.mm_projector.2.weight", True),
             "projector.b2": ("model.mm_projector.2.bias", False)}
    for i in range(cfg.llama.n_layers):
        lay, ours = f"model.layers.{i}.", f"llama.blocks.{i}."
        names[ours + "attn_norm"] = (lay + "input_layernorm.weight", False)
        names[ours + "ffn_norm"] = (lay + "post_attention_layernorm.weight", False)
        for n in "qkvo":
            names[ours + f"attn.w{n}"] = (lay + f"self_attn.{n}_proj.weight", True)
        for n in ("gate", "up", "down"):
            names[ours + f"mlp.w_{n}"] = (lay + f"mlp.{n}_proj.weight", True)
    return names


def write_llava_rob_checkpoint(root: Path) -> tuple:
    """An HF-layout LLaVA-1.5-7B directory of fp16 `.bin` shards (LM and
    projector, as the published checkpoint holds them) and a robust ViT-L/14
    tower file in the `vision_encoder_state_dict` wrapper (the port's
    float32 export format), both from the seed-0 random `llava-1.5-7b-rob`
    weights drawn on the card. Returns (checkpoint dir, tower file, the bf16
    state a `Llava` built straight from the written values holds, seconds
    to write)."""
    import torch

    from robustvlm_tpu_torch.models.clip.convert import export_visual_state_dict
    from robustvlm_tpu_torch.models.llava.convert import init_random_state
    from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS, half_state

    cfg = LLAVA_CONFIGS["llava-1.5-7b-rob"]
    t0 = time.perf_counter()
    state = init_random_state(cfg, 0, "cuda")
    ckpt, tower = root / "llava-1.5-7b-rob-hf", root / "fare-vit-l-14.pt"
    ckpt.mkdir(parents=True, exist_ok=True)
    visual = {"visual." + k[len("vision."):]: v for k, v in state.items() if k.startswith("vision.")}
    torch.save({"vision_encoder_state_dict": export_visual_state_dict(visual, cfg.vision)}, tower)
    ref = half_state({k: state.pop(k) for k in list(state) if k.startswith("vision.")})
    names = hf_llava_names(cfg)
    n_shards = cfg.llama.n_layers // ROB_SHARD_LAYERS + 1
    shards = [{} for _ in range(n_shards)]
    for ours in list(state):
        theirs, transpose = names[ours]
        v16 = state.pop(ours).to(torch.float16)
        ref.update(half_state({ours: v16.float()}))  # the values as the checkpoint holds them
        shard = int(ours.split(".")[2]) // ROB_SHARD_LAYERS if ".blocks." in ours else n_shards - 1
        shards[shard][theirs] = (v16.T if transpose else v16).contiguous().cpu()
    for k, part in enumerate(shards):
        torch.save(part, ckpt / f"pytorch_model-{k + 1:05d}-of-{n_shards:05d}.bin")
    return ckpt, tower, ref, time.perf_counter() - t0


def phase_llava_rob() -> dict:
    """The loaders at LLaVA-1.5-7B full width: `run_evaluation.main
    --llava_ckpt DIR --vision_encoder_pretrained FILE --eval_textvqa --attack
    apgd` (bf16, ROB_ITERS iterations, one question) on the checkpoint that
    `write_llava_rob_checkpoint` writes under chiprun_out/ (deleted at the
    end). The CLI's model against a `Llava` built straight from the written
    values (logits bit-equal), the tower at 224 px with `vit_attention` at
    257 tokens, the LM's flash forward at the length of the `llava-rob` flash
    rows, x_adv in the eps-ball and the box, the loss at x_adv above clean.
    Returns the kernels' launches."""
    import resource
    import shutil

    import numpy as np
    import torch

    from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS, Llava, llava_forward
    from robustvlm_tpu_torch.ops.kernels import flash_attention, vit_attention
    from robustvlm_tpu_torch.vlm_eval import run_evaluation as R
    from robustvlm_tpu_torch.vlm_eval.datasets import VQADataset

    _free()
    root = OUT / "llava-rob"
    try:
        ckpt, tower, ref_state, write_s = write_llava_rob_checkpoint(root)
        ckpt_gb = sum(f.stat().st_size for f in ckpt.iterdir()) / 1e9
        _free()
        img_dir, qf, af = _vqa_fixture(root / "textvqa", "textvqa", ROB_QUESTIONS)
        out_dir = root / "out"
        argv = vqa_argv("textvqa", img_dir, qf, af, out_dir, "--llava_ckpt", str(ckpt),
                        "--vision_encoder_pretrained", str(tower), "--attack", "apgd",
                        "--n_iter", str(ROB_ITERS), "--num_samples", "1")
        load = {}
        real_build, real_fwd = R.build_llava_models, vit_attention.attention_fwd_cuda
        real_flash = flash_attention.flash_fwd_cuda
        tokens_seen, flash_seen = set(), set()

        def timed_build(*a):
            t = time.perf_counter()
            out = real_build(*a)
            torch.cuda.synchronize()
            load["s"] = time.perf_counter() - t
            return out

        def fwd(q, k, v):
            tokens_seen.add(int(q.shape[1]))
            return real_fwd(q, k, v)

        def flash_fwd(q, k, v, **kw):
            flash_seen.add(int(q.shape[1]))
            return real_flash(q, k, v, **kw)

        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        R.build_llava_models, vit_attention.attention_fwd_cuda = timed_build, fwd
        flash_attention.flash_fwd_cuda = flash_fwd
        try:
            with adapters_of_cli(R, {}) as seen:
                result = R.main(argv)["textvqa"]
        finally:
            R.build_llava_models, vit_attention.attention_fwd_cuda = real_build, real_fwd
            flash_attention.flash_fwd_cuda = real_flash
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
        peak = torch.cuda.max_memory_allocated() / 2**30

        adapter = seen["half"]
        cfg = LLAVA_CONFIGS["llava-1.5-7b-rob"]
        direct = Llava.from_state(cfg, ref_state)
        args = R.build_parser().parse_args(argv)
        size = R._image_size(args)
        ds = VQADataset(str(img_dir), str(qf), str(af), size=size, **R.vqa_layout_for_dir("textvqa", str(img_dir)))
        item = ds[0]
        x = np.asarray(item["image"], np.float32)
        qid = str(item["question_id"])
        x_adv = np.load(out_dir / "textvqa" / "adv" / f"{qid}.npy")
        with torch.no_grad():
            adapter.set_inputs([adapter.get_vqa_prompt(item["question"], item["gt_answer"])])
            c = adapter._cached
            xr = torch.from_numpy(np.random.RandomState(1).rand(1, 3, size, size).astype(np.float32)).cuda()
            logits = [llava_forward(m, xr, c.pre, c.post, compute_dtype=torch.bfloat16)
                      for m in (adapter.model, direct)]
            losses = [float(adapter(torch.from_numpy(a[None]).cuda())[0]) for a in (x, x_adv)]
        del adapter, seen, direct, ref_state
        _free()
        linf = float(np.abs(x_adv.astype(np.float64) - x).max())
        checks = {
            "logits_bit_equal_direct": bool(torch.equal(logits[0], logits[1])),
            "robust_config": args.vision_encoder_pretrained != "" and R._llava_config(args).name == cfg.name,
            "tower_224px": size == 224 == cfg.vision.image_size,
            "vit_attention_257_tokens": tokens_seen == {257},
            "flash_at_row_length": _flash_llava_shape(cfg.name)[1] in flash_seen,
            "in_box": bool(x_adv.min() >= 0.0 and x_adv.max() <= 1.0),
            "in_ball": linf <= LLAVA_EPS / 255.0 + 1e-6,
            "loss_raised": losses[1] > losses[0],
            "vqa_accuracy": math.isfinite(result["vqa_accuracy"]),
            "iterations": result["attack_iters"] == ROB_ITERS,
            "launched": _launched(launches, LLAVA_KERNELS),
        }
        emit({"phase": "llava_rob", "entry": "robustvlm_tpu_torch.vlm_eval.run_evaluation.main",
              "argv": argv, "model": cfg.name, "dtype": "bfloat16", "checkpoint_gb": ckpt_gb,
              "write_s": write_s, "load_s": load["s"], "wall_s": wall, "attack_s": result["attack_s"],
              "ms_per_apgd_iter": result["attack_s"] / result["attack_iters"] * 1e3,
              "peak_mem_gib": peak, "host_peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
              "vit_tokens": sorted(tokens_seen), "flash_tokens": sorted(flash_seen), "loss_clean": losses[0], "loss_adv": losses[1], "linf": linf,
              "launches": launches, "card": card_line(), "checks": checks, "ok": all(checks.values())})
        if not all(checks.values()):
            raise AssertionError(f"llava_rob checks failed: {checks}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------ phase 14
LLAVA_MPT_LAYERS = 2
LLAVA_MPT_POST_LEN = 16
LLAVA_MPT_RUNS = ("llava_mpt_reference[bfloat16]", "llava_mpt_reference[float32]")
LLAVA_MPT_CUT = f"{LLAVA_MPT_LAYERS} of 32 MPT-7B layers, {LLAVA_MPT_LAYERS} of 24 ViT-L/14 layers"
LLAVA_MPT_NEW_TOKENS = 8


def _llava_mpt_cut(n_layers: int = LLAVA_MPT_LAYERS):
    """LLaVA-MPT as the JAX package pairs it at full size (`test-tiny-mpt`
    with `dataclasses.replace`): the robust 224 px ViT-L/14 tower and MPT-7B,
    both cut to `n_layers` transformer layers."""
    import dataclasses

    from robustvlm_tpu_torch.models.clip.model import CLIP_CONFIGS
    from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS
    from robustvlm_tpu_torch.models.mpt.model import MPT_CONFIGS

    vision = CLIP_CONFIGS["ViT-L-14"]
    vision = dataclasses.replace(vision, vision=dataclasses.replace(vision.vision, layers=n_layers))
    return dataclasses.replace(LLAVA_CONFIGS["test-tiny-mpt"], name=f"llava-mpt-7b-{n_layers}l", vision=vision,
                               mpt=dataclasses.replace(MPT_CONFIGS["mpt-7b"], n_layers=n_layers))


def llava_mpt_seq_len() -> int:
    """Tokens of `llava_mpt_reference`'s teacher-forced sequence (256 image
    tokens and the prompt), the ALiBi rows' length."""
    return adapter_seq_len(_llava_mpt_cut(), LLAVA_MPT_POST_LEN)


def phase_llava_mpt_reference() -> dict:
    """LLaVA-MPT through the kernels on the card against the plain path on
    the CPU: MPT-7B and ViT-L/14 widths cut to 2 layers each (random weights,
    seed 0), float32, batch 1, max_post_len 16: the per-sample CE (1e-4
    relative), its pixel gradient (1e-3 of its largest element, not 0), and
    the greedy tokens of a left-padded batch of 2 prompts of different
    lengths (equal; the pad sits mid-sequence, so the ALiBi distances go
    through `kv_positions`). Then the same loss and gradient in bf16 on the
    card (its loss within 5e-2 of float32's). Returns the launches of the
    card's bf16 and float32 runs, keyed as LLAVA_MPT_RUNS."""
    import numpy as np
    import torch

    from robustvlm_tpu_torch.models.generation import greedy_generate
    from robustvlm_tpu_torch.models.llava.convert import init_random_state
    from robustvlm_tpu_torch.models.llava.model import Llava, half_state
    from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel, WordTokenizer

    _free()
    t0 = time.perf_counter()
    cfg = _llava_mpt_cut()
    state = init_random_state(cfg, 0, "cpu")
    size = cfg.vision.image_size
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(2, 3, size, size).astype(np.float32))
    caption = "two dogs play with a red ball on the grass"
    out, launches, tokens, n_pad, seq_lens = {}, {}, {}, None, set()
    torch.cuda.reset_peak_memory_stats()
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.float32), ("cuda", torch.bfloat16)):
        on_dev = {k: v.to(dev) for k, v in state.items()}
        model = Llava.from_state(cfg, half_state(on_dev) if dtype == torch.bfloat16 else on_dev)
        adapter = LlavaEvalModel(model, WordTokenizer(), compute_dtype=dtype, max_post_len=LLAVA_MPT_POST_LEN)
        adapter.set_inputs([adapter.get_caption_prompt(caption)])
        seq_lens.add(adapter._cached.pre.shape[1] + cfg.n_image_tokens + adapter._cached.post.shape[1])
        xa = x[:1].to(dev).requires_grad_(True)
        _reset_launches()
        loss = adapter(xa)
        (grad,) = torch.autograd.grad(loss.sum(), xa)
        key = f"{dev}[{str(dtype).split('.')[-1]}]"
        if dev == "cuda":
            torch.cuda.synchronize()
            launches[f"llava_mpt_reference[{str(dtype).split('.')[-1]}]"] = _launches()
        out[key] = (loss.detach().cpu().double(), grad.cpu().double())
        if dtype == torch.float32:
            prompts = [adapter.get_vqa_prompt("what is in the picture and what color is it?"),
                       adapter.get_caption_prompt(None)]
            pf, df, toks, n_pad = adapter._decode_fns(x.to(dev), prompts, LLAVA_MPT_NEW_TOKENS)
            res = greedy_generate(pf, df, toks, n_pad, max_new_tokens=LLAVA_MPT_NEW_TOKENS,
                                  eos_id=adapter.tok.eos_token_id, pad_id=adapter.tok.pad_token_id)
            tokens[dev] = res.tokens.cpu().tolist()
            n_pad = n_pad.cpu().tolist()
        del model, adapter, on_dev
    _free()
    ref, card, half = out["cpu[float32]"], out["cuda[float32]"], out["cuda[bfloat16]"]
    loss_rel = float(((card[0] - ref[0]).abs() / ref[0].abs()).max())
    g_max = float(ref[1].abs().max())
    g_err = float((card[1] - ref[1]).abs().max())
    half_rel = float(((half[0] - card[0]).abs() / card[0].abs()).max())
    seq_len = llava_mpt_seq_len()
    checks = {"loss_rel": loss_rel <= 1e-4, "grad": g_err <= 1e-3 * g_max,
              "grad_nonzero": g_max > 0 and float(card[1].abs().max()) > 0,
              "finite": bool(torch.isfinite(card[1]).all() and torch.isfinite(half[1]).all()),
              "greedy_tokens_equal": tokens["cpu"] == tokens["cuda"],
              "left_padded_batch": len(set(n_pad)) == 2,
              "seq_len_as_kernel_rows": seq_lens == {seq_len},
              "bf16_loss": half_rel <= 5e-2,
              "launched_alibi": all(_launched(v, ("flash_attention_fwd_alibi", "flash_attention_bwd_alibi",
                                                  "vit_attention_fwd", "vit_attention_bwd"))
                                    for v in launches.values())}
    emit({"phase": "llava_mpt_reference", "model": cfg.name, "dtypes": ["float32", "bfloat16 (card)"],
          "batch": 1, "seq_len": seq_len, "loss": float(ref[0][0]), "loss_rel_err": loss_rel,
          "grad_max_abs_err": g_err, "grad_max_abs": g_max, "bf16_loss_rel_to_float32": half_rel,
          "tol": {"loss_rel": 1e-4, "grad_of_largest": 1e-3, "bf16_loss_rel": 5e-2},
          "greedy_tokens": tokens, "n_pad": n_pad, "launches": launches,
          "cuts": [f"{LLAVA_MPT_LAYERS} of 32 MPT-7B layers", f"{LLAVA_MPT_LAYERS} of 24 ViT-L/14 layers",
                   "random weights (seed 0)"],
          "wall_s": time.perf_counter() - t0, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"llava_mpt_reference checks failed: {checks}")
    return launches


# ------------------------------------------------------------------ phase 15
QUAL_ITERS = 10  # cut from 50 for the smoke's time


def phase_llava_qualitative() -> dict:
    """`run_evaluation_qualitative.main` at LLaVA-1.5-7B full width (bf16,
    random weights from seed 0) on one fixture image, the default target
    with its table seed, eps 2/255, QUAL_ITERS iterations: the target's
    teacher-forced loss at the saved x_adv below clean, on the CLI's own
    adapter, x_adv in the eps-ball and the box. Returns the launches."""
    import numpy as np
    import torch
    from PIL import Image

    from robustvlm_tpu_torch.benchmark.templates import target_to_seed
    from robustvlm_tpu_torch.data.loaders import default_image_transform
    from robustvlm_tpu_torch.vlm_eval import run_evaluation as R
    from robustvlm_tpu_torch.vlm_eval import run_evaluation_qualitative as Q

    _free()
    root = OUT / "llava-qualitative"
    root.mkdir(parents=True, exist_ok=True)
    img = root / "surfer.png"
    Image.fromarray(np.random.RandomState(3).randint(0, 255, (360, 400, 3), np.uint8)).save(img)
    target = Q.build_parser().get_default("target_str")
    argv = ["--device", "cuda", "--model", "llava", "--model_size", "7b", "--images", str(img),
            "--eps", str(LLAVA_EPS), "--n_iter", str(QUAL_ITERS), "--max_new_tokens", "16",
            "--out_base_path", str(root / "out")]
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with adapters_of_cli(R, {}) as seen:
        report = Q.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    adapter = seen["half"]
    with Image.open(img) as im:
        x = default_image_transform(adapter.cfg.vision.image_size)(im)
    x_adv = np.load(root / "out" / "adv" / "surfer.npy")
    with torch.no_grad():
        adapter.set_inputs([adapter.get_caption_prompt(target)])
        losses = [float(adapter(torch.from_numpy(a[None]).cuda())[0]) for a in (x, x_adv)]
    del adapter, seen
    _free()
    linf = float(np.abs(x_adv.astype(np.float64) - x).max())
    checks = {"target_loss_fell": losses[1] < losses[0],
              "in_box": bool(x_adv.min() >= 0.0 and x_adv.max() <= 1.0),
              "in_ball": linf <= LLAVA_EPS / 255.0 + 1e-6,
              "report": set(report) == {"target_str", "eps", "n_iter", "success_rate", "results", "wall_s"}
              and report["target_str"] == target and math.isfinite(report["results"][0]["loss"]),
              "launched": _launched(launches, LLAVA_KERNELS)}
    emit({"phase": "llava_qualitative", "entry": "robustvlm_tpu_torch.vlm_eval.run_evaluation_qualitative.main",
          "argv": argv, "model": "llava-1.5-7b", "dtype": "bfloat16", "target_str": target,
          "seed": Q.table_seed(target_to_seed(), target), "n_iter": QUAL_ITERS, "wall_s": wall,
          "target_loss_clean": losses[0], "target_loss_adv": losses[1], "linf": linf,
          "caption": report["results"][0]["caption"], "success_rate": report["success_rate"],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
          "card": card_line(), "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"llava_qualitative checks failed: {checks}")
    return launches


# ------------------------------------------------------------------ phase 16
def phase_llava_aux() -> dict:
    """POPE's, ScienceQA's and MMBench's `main` at LLaVA-1.5-7B full width
    (the float32 adapter each CLI builds, random weights from seed 0) on 2
    fixture items each (one ScienceQA problem text-only; MMBench a 2-row TSV
    asked in every rotation of its options): finite metrics, 7 MMBench
    answer records. Then `gpt_review` with its offline judge over POPE's
    answers against the labels as a second answer file: one review row a
    question, the summary's counts."""
    import base64
    import csv
    import io

    import numpy as np
    import torch
    from PIL import Image

    from robustvlm_tpu_torch.vlm_eval import gpt_review, mmbench, pope, science_qa

    _free()
    root = OUT / "llava-aux"
    (root / "sqa" / "q1").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(4)
    for path in (root / "pope.jpg", root / "sqa" / "q1" / "image.png"):
        Image.fromarray(rng.randint(0, 255, (360, 400, 3), np.uint8)).save(path)
    tsv = root / "mmbench.tsv"
    with open(tsv, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["index", "question", "hint", "answer", "A", "B", "C", "D", "image"],
                           delimiter="\t")
        w.writeheader()
        for i, (q, hint, ans, opts) in enumerate([("What is the main object?", "", "B", ("a car", "a wave", "a cup", "")),
                                                  ("How many people are there?", "Count them.", "A",
                                                   ("one", "two", "three", "four"))]):
            buf = io.BytesIO()
            Image.fromarray(rng.randint(0, 255, (360, 400, 3), np.uint8)).save(buf, format="PNG")
            w.writerow({"index": str(i), "question": q, "hint": hint, "answer": ans, **dict(zip("ABCD", opts)),
                        "image": base64.b64encode(buf.getvalue()).decode()})
    qfile = root / "pope.jsonl"
    qfile.write_text("".join(json.dumps({"question_id": i, "image": "pope.jpg", "text": t, "label": lab}) + "\n"
                             for i, (t, lab) in enumerate([("Is there a surfboard in the image?", "yes"),
                                                           ("Is there a giraffe in the image?", "no")])))
    pfile = root / "problems.json"
    pfile.write_text(json.dumps({
        "q1": {"question": "Which animal is shown?", "choices": ["a dog", "a cat", "a bird"], "answer": 0,
               "image": "image.png"},
        "q2": {"question": "Which is a liquid?", "choices": ["ice", "water"], "answer": 1}}))
    common = ["--device", "cuda", "--model", "llava", "--model_size", "7b", "--max_new_tokens", "8"]
    _reset_launches()
    t0 = time.perf_counter()
    m_pope = pope.main([*common, "--pope_questions", str(qfile), "--image_root", str(root),
                        "--answers_path", str(root / "pope_answers.jsonl")])
    t1 = time.perf_counter()
    _free()
    m_sqa = science_qa.main([*common, "--problems", str(pfile), "--image_root", str(root / "sqa")])
    t2 = time.perf_counter()
    _free()
    m_mmb = mmbench.main([*common, "--mmbench_tsv", str(tsv), "--answers_file", str(root / "mmbench.jsonl")])
    t3 = time.perf_counter()
    launches = _launches()
    _free()
    questions = pope.load_pope_questions(str(qfile))
    labels = [{"question_id": q["question_id"], "text": q["label"]} for q in questions]
    reviews = gpt_review.review_answers(
        [{**q, "category": "pope"} for q in questions], pope.load_pope_questions(str(root / "pope_answers.jsonl")),
        labels, output_path=str(root / "review.jsonl"))
    summary = gpt_review.summarize_reviews(reviews)
    n_records = len((root / "mmbench.jsonl").read_text().splitlines())

    def finite(m):
        return all(math.isfinite(v) for v in m.values() if isinstance(v, (int, float)))

    # generation only: the tower's forward kernel (the LM's cached prefill
    # and decode are masked plain attention, as in JAX)
    checks = {"pope_metrics": finite(m_pope) and {"precision", "recall", "f1", "accuracy", "yes_ratio"} <= set(m_pope),
              "science_qa_metrics": finite(m_sqa) and m_sqa["total"] == 2,
              "mmbench_metrics": finite(m_mmb) and m_mmb["n_questions"] == 2 and n_records == 3 + 4,
              "review_rows": len(reviews) == 2 and (root / "review.jsonl").is_file()
              and all(r["tuple"][0] >= 1 for r in reviews) and summary["all"]["n"] == 2,
              "launched": _launched(launches, ("vit_attention_fwd",))}
    emit({"phase": "llava_aux", "entry": ["robustvlm_tpu_torch.vlm_eval.pope.main",
                                          "robustvlm_tpu_torch.vlm_eval.science_qa.main",
                                          "robustvlm_tpu_torch.vlm_eval.mmbench.main",
                                          "robustvlm_tpu_torch.vlm_eval.gpt_review.review_answers"],
          "model": "llava-1.5-7b", "dtype": "float32", "pope": m_pope, "science_qa": m_sqa,
          "mmbench": m_mmb, "review_summary": summary,
          "pope_wall_s": t1 - t0, "science_qa_wall_s": t2 - t1, "mmbench_wall_s": t3 - t2, "launches": launches,
          "card": card_line(), "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"llava_aux checks failed: {checks}")
    return launches


# ------------------------------------------------------------------ phases 17-18
# BLIP-2 (EVA ViT-g/14, Q-Former, OPT-2.7B). Its attention is plain PyTorch,
# as in JAX, where BLIP-2 reaches no Pallas kernel: only the l-inf step of
# APGD launches a kernel of the port on this path.
BLIP2_LAYERS = 2
BLIP2_CUT = [f"{BLIP2_LAYERS} of 39 vision layers", f"{BLIP2_LAYERS} of 12 Q-Former layers",
             f"{BLIP2_LAYERS} of 32 OPT-2.7B layers", "random weights (seed 0)"]
BLIP2_NEW_TOKENS = 8
BLIP2_ITERS = 25
BLIP2_SHARD_LAYERS = 8  # OPT layers a shard
ATTN_KERNELS = ("vit_attention_fwd", "vit_attention_bwd", "flash_attention_fwd", "flash_attention_bwd")


def _blip2_cut(n_layers: int = BLIP2_LAYERS):
    """blip2-opt-2.7b at full widths with the vision tower, the Q-Former and
    OPT cut to `n_layers` layers each."""
    import dataclasses

    from robustvlm_tpu_torch.models.blip2.model import BLIP2_CONFIGS

    cfg = BLIP2_CONFIGS["blip2-opt-2.7b"]
    return dataclasses.replace(
        cfg, name=f"blip2-opt-2.7b-{n_layers}l", vision=dataclasses.replace(cfg.vision, layers=n_layers),
        qformer=dataclasses.replace(cfg.qformer, layers=n_layers), opt=dataclasses.replace(cfg.opt, n_layers=n_layers))


def phase_blip2_reference() -> dict:
    """BLIP-2 on the card against the CPU: full widths (vision 1408, Q-Former
    768, OPT 2560), 2 layers each, float32, random weights from seed 0: the
    adapter's per-sample CE of a caption (1e-4 relative), its pixel gradient
    (1e-3 of its largest element, not 0), and the greedy tokens of a
    left-padded batch of 2 prompts of different lengths (equal). Returns the
    card's launches (the attention kernels' none)."""
    import numpy as np
    import torch

    from robustvlm_tpu_torch.models.blip2 import Blip2, init_random_state
    from robustvlm_tpu_torch.models.generation import greedy_generate
    from robustvlm_tpu_torch.vlm_eval.eval_models import Blip2EvalModel, WordTokenizer

    _free()
    t0 = time.perf_counter()
    cfg = _blip2_cut()
    state = init_random_state(cfg, 0, "cpu")
    size = cfg.vision.image_size
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, size, size).astype(np.float32))
    out, tokens, launches, n_pad = {}, {}, None, None
    torch.cuda.reset_peak_memory_stats()
    for dev in ("cpu", "cuda"):
        model = Blip2.from_state(cfg, {k: v.to(dev) for k, v in state.items()})
        adapter = Blip2EvalModel(model, WordTokenizer(), compute_dtype=torch.float32)
        adapter.set_inputs([adapter.get_caption_prompt("two dogs play with a red ball on the grass")])
        xa = x[:1].to(dev).requires_grad_(True)
        _reset_launches()
        loss = adapter(xa)
        (grad,) = torch.autograd.grad(loss.sum(), xa)
        prompts = [adapter.get_vqa_prompt("what is in the picture and what color is it?"),
                   adapter.get_caption_prompt()]
        pf, df, toks, n_pad = adapter._decode_fns(x.to(dev), prompts, BLIP2_NEW_TOKENS)
        res = greedy_generate(pf, df, toks, n_pad, max_new_tokens=BLIP2_NEW_TOKENS,
                              eos_id=adapter.tok.eos_token_id, pad_id=adapter.tok.pad_token_id)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = _launches()
        tokens[dev] = res.tokens.cpu().tolist()
        n_pad = n_pad.cpu().tolist()
        out[dev] = (loss.detach().cpu().double(), grad.cpu().double())
        del model, adapter, pf, df
    del state
    _free()
    ref, card = out["cpu"], out["cuda"]
    loss_rel = float(((card[0] - ref[0]).abs() / ref[0].abs()).max())
    g_max, g_err = float(ref[1].abs().max()), float((card[1] - ref[1]).abs().max())
    checks = {"loss_rel": loss_rel <= 1e-4, "grad": g_err <= 1e-3 * g_max,
              "grad_nonzero": g_max > 0 and float(card[1].abs().max()) > 0,
              "finite": bool(torch.isfinite(card[1]).all()),
              "greedy_tokens_equal": tokens["cpu"] == tokens["cuda"],
              "left_padded_batch": len(set(n_pad)) == 2,
              "no_attention_kernel": all(launches[k] == 0 for k in ATTN_KERNELS)}
    emit({"phase": "blip2_reference", "model": cfg.name, "dtype": "float32", "batch": 1,
          "loss": float(ref[0][0]), "loss_rel_err": loss_rel, "grad_max_abs_err": g_err, "grad_max_abs": g_max,
          "tol": {"loss_rel": 1e-4, "grad_of_largest": 1e-3}, "greedy_tokens": tokens, "n_pad": n_pad,
          "launches": launches, "cuts": BLIP2_CUT, "wall_s": time.perf_counter() - t0,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card_line(), "checks": checks,
          "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"blip2_reference checks failed: {checks}")
    return launches


def hf_blip2_names(cfg) -> dict:
    """The port's BLIP-2 names -> (HF `Blip2ForConditionalGeneration` key,
    transposed), written out independently of the importer, which inverts
    it. OPT's LM head is the embedding (tied): not written."""
    names = {"visual.patch_bias": ("vision_model.embeddings.patch_embedding.bias", False),
             "visual.ln_post.g": ("vision_model.post_layernorm.weight", False),
             "visual.ln_post.b": ("vision_model.post_layernorm.bias", False),
             "qformer.ln_embed.g": ("qformer.layernorm.weight", False),
             "qformer.ln_embed.b": ("qformer.layernorm.bias", False),
             "language_projection.w": ("language_projection.weight", True),
             "language_projection.b": ("language_projection.bias", False)}
    vis = {"ln_1.g": "layer_norm1.weight", "ln_1.b": "layer_norm1.bias", "attn.qkv_w": "self_attn.qkv.weight",
           "attn.qkv_b": "self_attn.qkv.bias", "attn.out_w": "self_attn.projection.weight",
           "attn.out_b": "self_attn.projection.bias", "ln_2.g": "layer_norm2.weight",
           "ln_2.b": "layer_norm2.bias", "mlp.fc_w": "mlp.fc1.weight", "mlp.fc_b": "mlp.fc1.bias",
           "mlp.proj_w": "mlp.fc2.weight", "mlp.proj_b": "mlp.fc2.bias"}
    for i in range(cfg.vision.layers):
        for ours, theirs in vis.items():
            names[f"visual.blocks.{i}.{ours}"] = (f"vision_model.encoder.layers.{i}.{theirs}", ours.endswith("_w"))
    att = {"q_w": "attention.query.weight", "q_b": "attention.query.bias", "k_w": "attention.key.weight",
           "k_b": "attention.key.bias", "v_w": "attention.value.weight", "v_b": "attention.value.bias",
           "out_w": "output.dense.weight", "out_b": "output.dense.bias", "ln_g": "output.LayerNorm.weight",
           "ln_b": "output.LayerNorm.bias"}
    ffn = {"fc_w": "intermediate_query.dense.weight", "fc_b": "intermediate_query.dense.bias",
           "proj_w": "output_query.dense.weight", "proj_b": "output_query.dense.bias",
           "ln_g": "output_query.LayerNorm.weight", "ln_b": "output_query.LayerNorm.bias"}
    for i in range(cfg.qformer.layers):
        lay = f"qformer.encoder.layer.{i}."
        subs = [("self_attn", "attention.", att), ("ffn", "", ffn)]
        if i % cfg.qformer.xattn_every == 0:
            subs.append(("cross", "crossattention.", att))
        for ours, pre, table in subs:
            for leaf, theirs in table.items():
                names[f"qformer.layers.{i}.{ours}.{leaf}"] = (lay + pre + theirs, leaf.endswith("_w"))
    dec = "language_model.model.decoder."
    names.update({"opt.tok_embedding": (dec + "embed_tokens.weight", False),
                  "opt.pos_embedding": (dec + "embed_positions.weight", False),
                  "opt.final_norm.g": (dec + "final_layer_norm.weight", False),
                  "opt.final_norm.b": (dec + "final_layer_norm.bias", False)})
    opt = {"ln1.g": "self_attn_layer_norm.weight", "ln1.b": "self_attn_layer_norm.bias",
           "ln2.g": "final_layer_norm.weight", "ln2.b": "final_layer_norm.bias",
           "mlp.fc1": "fc1.weight", "mlp.b1": "fc1.bias", "mlp.fc2": "fc2.weight", "mlp.b2": "fc2.bias"}
    for n, proj in zip("qkvo", ("q_proj", "k_proj", "v_proj", "out_proj")):
        opt[f"attn.w{n}"], opt[f"attn.b{n}"] = f"self_attn.{proj}.weight", f"self_attn.{proj}.bias"
    for i in range(cfg.opt.n_layers):
        for ours, theirs in opt.items():
            leaf = ours.rsplit(".", 1)[-1]
            names[f"opt.blocks.{i}.{ours}"] = (f"{dec}layers.{i}.{theirs}", leaf in ("fc1", "fc2") or
                                               leaf.startswith("w"))
    return names


def write_blip2_checkpoint(root: Path) -> tuple:
    """An HF-layout blip2-opt-2.7b directory of fp16 `.bin` shards from the
    seed-0 random weights drawn on the card (the patch embedding as a conv
    weight, the class and position embeddings and the query tokens with
    their leading axes). Returns (directory, the bf16 state a `Blip2` built
    straight from the written values holds, seconds to write)."""
    import torch

    from robustvlm_tpu_torch.models.blip2 import BLIP2_CONFIGS, half_state, init_random_state

    cfg = BLIP2_CONFIGS["blip2-opt-2.7b"]
    vc = cfg.vision
    t0 = time.perf_counter()
    state = init_random_state(cfg, 0, "cuda")
    ckpt = root / "blip2-opt-2.7b-hf"
    ckpt.mkdir(parents=True, exist_ok=True)
    names = hf_blip2_names(cfg)
    shaped = {"visual.patch_embed": ("vision_model.embeddings.patch_embedding.weight",
                                     lambda v: v.T.reshape(vc.width, 3, vc.patch_size, vc.patch_size)),
              "visual.class_embedding": ("vision_model.embeddings.class_embedding",
                                         lambda v: v.reshape(1, 1, vc.width)),
              "visual.positional_embedding": ("vision_model.embeddings.position_embedding",
                                              lambda v: v.reshape(1, vc.n_tokens, vc.width)),
              "query_tokens": ("query_tokens", lambda v: v.reshape(1, *v.shape))}
    n_shards = cfg.opt.n_layers // BLIP2_SHARD_LAYERS + 1
    shards = [{} for _ in range(n_shards)]
    ref = {}
    del state["opt.lm_head"]
    for ours in list(state):
        v16 = state.pop(ours).to(torch.float16)
        ref.update(half_state({ours: v16.float()}))  # the values as the checkpoint holds them
        if ours in shaped:
            theirs, shape = shaped[ours]
            out = shape(v16)
        else:
            theirs, transpose = names[ours]
            out = v16.T if transpose else v16
        shard = int(ours.split(".")[2]) // BLIP2_SHARD_LAYERS if ours.startswith("opt.blocks.") else n_shards - 1
        shards[shard][theirs] = out.contiguous().cpu()
    ref["opt.lm_head"] = ref["opt.tok_embedding"].T.contiguous()
    for k, part in enumerate(shards):
        torch.save(part, ckpt / f"pytorch_model-{k + 1:05d}-of-{n_shards:05d}.bin")
    return ckpt, ref, time.perf_counter() - t0


def phase_blip2() -> dict:
    """`run_evaluation.main --model blip2 --model_size 7b --blip2_ckpt DIR` at
    blip2-opt-2.7b full width (39 + 12 + 32 layers), bf16: --eval_coco
    --attack apgd on 2 images, then one VQAv2 question, BLIP2_ITERS iterations
    each, on the HF-layout checkpoint `write_blip2_checkpoint` writes under
    chiprun_out/ (deleted at the end). The CLI's model against a `Blip2`
    built straight from the written values (logits bit-equal), x_adv in the
    box and the eps-ball, the loss at x_adv above clean; ms per APGD
    iteration, the run's peak memory above what the phase held before it,
    write and load seconds, the texts and the
    launches: `linf_step` once an iteration, no attention kernel (BLIP-2's
    attention is plain, as in JAX). Returns the launches."""
    import shutil

    import numpy as np
    import torch

    from robustvlm_tpu_torch.models.blip2 import Blip2, blip2_forward
    from robustvlm_tpu_torch.vlm_eval import run_evaluation as R
    from robustvlm_tpu_torch.vlm_eval.datasets import CaptionDataset

    _free()
    root = OUT / "blip2"
    try:
        ckpt, ref_state, write_s = write_blip2_checkpoint(root)
        ckpt_gb = sum(f.stat().st_size for f in ckpt.iterdir()) / 1e9
        _free()
        img_dir, ann = _coco_fixture(root / "coco")
        vimg, qf, af = _vqa_fixture(root / "vqav2", "vqav2", ROB_QUESTIONS)
        out_dir = root / "out"
        argv = ["--device", "cuda", "--model", "blip2", "--model_size", "7b", "--blip2_ckpt", str(ckpt),
                "--eval_coco", "--coco_image_dir", str(img_dir), "--coco_annotations", str(ann),
                "--eval_vqav2", "--vqav2_image_dir", str(vimg), "--vqav2_questions", str(qf),
                "--vqav2_annotations", str(af), "--attack", "apgd", "--eps", str(LLAVA_EPS),
                "--n_iter", str(BLIP2_ITERS), "--num_samples", "2", "--max_new_tokens", "16",
                "--out_base_path", str(out_dir), "--verbose"]
        load = {}
        real_build = R.build_blip2_models

        def timed_build(*a):
            t = time.perf_counter()
            out = real_build(*a)
            torch.cuda.synchronize()
            load["s"] = time.perf_counter() - t
            return out

        held = torch.cuda.memory_allocated()  # the written values' bf16 copy, kept for the check below
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        R.build_blip2_models = timed_build
        try:
            with adapters_of_cli(R, {}) as seen:
                result = R.main(argv)
        finally:
            R.build_blip2_models = real_build
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30

        adapter = seen["half"]
        cfg = adapter.cfg
        direct = Blip2.from_state(cfg, ref_state)
        size = R._image_size(R.build_parser().parse_args(argv))
        ds = CaptionDataset(str(img_dir), str(ann), size=size, split="val")
        per_image = []
        with torch.no_grad():
            toks = torch.tensor([[adapter.tok.bos_token_id, *adapter.tok.encode("a photo of two dogs")]],
                                device="cuda")
            xr = torch.from_numpy(np.random.RandomState(1).rand(1, 3, size, size).astype(np.float32)).cuda()
            logits = [blip2_forward(m, xr, toks, compute_dtype=torch.bfloat16) for m in (adapter.model, direct)]
            for i in range(len(ds)):
                item = ds[i]
                x = np.asarray(item["image"], np.float32)
                x_adv = np.load(out_dir / "coco" / "adv" / f"{item['image_id']}.npy")
                adapter.set_inputs([adapter.get_caption_prompt(item["all_captions"][0])])
                losses = [float(adapter(torch.from_numpy(a[None]).cuda())[0]) for a in (x, x_adv)]
                per_image.append({"image_id": item["image_id"], "loss_clean": losses[0], "loss_adv": losses[1],
                                  "linf": float(np.abs(x_adv.astype(np.float64) - x).max()),
                                  "in_box": bool(x_adv.min() >= 0.0 and x_adv.max() <= 1.0)})
        del adapter, seen, direct, ref_state
        _free()
        captions = json.loads((out_dir / "coco" / "ensemble_state.json").read_text())["best_outputs"]
        answers = json.loads((out_dir / "vqav2" / "ensemble_state.json").read_text())["best_outputs"]
        iters = result["coco"]["attack_iters"] + result["vqav2"]["attack_iters"]
        checks = {
            "logits_bit_equal_direct": bool(torch.equal(logits[0], logits[1])),
            "in_box": all(r["in_box"] for r in per_image),
            "in_ball": all(r["linf"] <= LLAVA_EPS / 255.0 + 1e-6 for r in per_image),
            "loss_raised": all(r["loss_adv"] > r["loss_clean"] for r in per_image),
            "texts": all(isinstance(t, str) for t in [*captions.values(), *answers.values()]),
            "iterations": result["coco"]["attack_iters"] == 2 * BLIP2_ITERS
            and result["vqav2"]["attack_iters"] == BLIP2_ITERS,
            "linf_step_once_an_iteration": launches["linf_step"] == iters,
            "no_attention_kernel": all(launches[k] == 0 for k in ATTN_KERNELS),
            "metrics": math.isfinite(result["coco"]["cider"]) and math.isfinite(result["vqav2"]["vqa_accuracy"]),
        }
        emit({"phase": "blip2", "entry": "robustvlm_tpu_torch.vlm_eval.run_evaluation.main", "argv": argv,
              "model": cfg.name, "dtype": "bfloat16", "checkpoint_gb": ckpt_gb, "write_s": write_s,
              "load_s": load["s"], "wall_s": wall, "attack_s": {k: result[k]["attack_s"] for k in ("coco", "vqav2")},
              "attack_iters": iters,
              "ms_per_apgd_iter": result["coco"]["attack_s"] / result["coco"]["attack_iters"] * 1e3,
              "ms_per_apgd_iter_vqa": result["vqav2"]["attack_s"] / result["vqav2"]["attack_iters"] * 1e3,
              "peak_mem_gib": peak, "held_before_gib": held / 2**30,
              "cider": result["coco"]["cider"], "vqa_accuracy": result["vqav2"]["vqa_accuracy"],
              "captions": captions, "answers": answers, "per_image": per_image, "eps": LLAVA_EPS / 255.0,
              "launches": launches, "card": card_line(), "checks": checks, "ok": all(checks.values())})
        if not all(checks.values()):
            raise AssertionError(f"blip2 checks failed: {checks}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------ phase 17
# OpenFlamingo-9B. The reference initialises both gates of every gated
# cross-attention block at 0, where tanh(0) = 0 and a random OpenFlamingo
# ignores its image: the pixel gradient would be exactly 0 and APGD would
# step by sign(0) = 0. The port's init and CLI keep the zero gates; these
# phases open them to FLAMINGO_GATE after the weights are made.
FLAMINGO_GATE = 0.5
FLAMINGO_EPS = 2.0  # /255
FLAMINGO_IMAGES = LLAVA_IMAGES + [  # four images: each attacked one has 2 demos besides itself
    ["a dog catching a frisbee in a park", "a brown dog jumps for a frisbee",
     "a dog playing on the grass", "a dog leaping in the air", "a dog with a red frisbee"],
    ["a red bus parked on a city street", "a double decker bus on the road",
     "a bus stopped at a station", "a large red bus near buildings", "a city bus driving by"],
]
FLAMINGO_KERNELS = ("linf_step", "vit_attention_fwd", "vit_attention_bwd",
                    "flash_attention_fwd_alibi", "flash_attention_bwd_alibi")
FLAMINGO_ENSEMBLE_ITERS = 5


@contextlib.contextmanager
def open_gates_in_cli(seen: dict):
    """`run_evaluation.build_eval_model` wrapped for the duration: each
    adapter the CLI builds gets its model's gates opened to FLAMINGO_GATE,
    and records its teacher-forced prompts and their token lengths in
    `seen` ("prompts", "lens"); the adapters stay in seen["adapters"]."""
    import torch

    from robustvlm_tpu_torch.vlm_eval import run_evaluation as R

    orig = R.build_eval_model
    seen.setdefault("prompts", [])
    seen.setdefault("lens", [])
    seen.setdefault("adapters", {})

    def build(args, precision, models=None):
        adapter = orig(args, precision, models)
        with torch.no_grad():
            open_gates_(adapter.model)
        set_inputs = adapter.set_inputs

        def record(prompts):
            set_inputs(prompts)
            seen["prompts"].append(list(prompts))
            seen["lens"].append(int(adapter._lang.shape[1]))

        adapter.set_inputs = record
        seen["adapters"][precision] = adapter
        return adapter

    R.build_eval_model = build
    try:
        yield seen
    finally:
        R.build_eval_model = orig


def open_gates_(model) -> None:
    """Both gates of every cross-attention block to FLAMINGO_GATE, in place."""
    for blk in model.xattn:
        blk.attn_gate.fill_(FLAMINGO_GATE)
        blk.ff_gate.fill_(FLAMINGO_GATE)


def flamingo_prompt(adapter, caption: str) -> str:
    """The 0-shot captioning prompt: 2 text-only demos (the CLI's, with
    OpenFlamingo at 0 shots) and `caption` teacher-forced."""
    from robustvlm_tpu_torch.vlm_eval.fewshot import build_context_text

    demos = [{"caption": caps[0]} for caps in FLAMINGO_IMAGES[2:]]
    return build_context_text(adapter, demos, 0) + adapter.get_caption_prompt(caption)


def _flamingo_cut(n_lm: int, n_vision: int):
    """openflamingo-9b at full width with the MPT cut to `n_lm` layers (one
    gated block every 4) and the vision tower to `n_vision`; the Perceiver
    whole; the hash tokenizer's <image> id."""
    import dataclasses

    from robustvlm_tpu_torch.models.flamingo.model import FLAMINGO_CONFIGS
    from robustvlm_tpu_torch.vlm_eval.eval_models import WordTokenizer

    cfg = FLAMINGO_CONFIGS["openflamingo-9b"]
    vision = dataclasses.replace(cfg.vision, vision=dataclasses.replace(cfg.vision.vision, layers=n_vision))
    return dataclasses.replace(cfg, name=f"openflamingo-9b-{n_lm}l", vision=vision,
                               mpt=dataclasses.replace(cfg.mpt, n_layers=n_lm),
                               media_token_id=WordTokenizer().media_token_id)


def phase_flamingo_reference() -> dict:
    """The OpenFlamingo loss path through the kernels on the card against the
    plain path on the CPU: OF-9B widths cut to 4 MPT layers (one gated block)
    and 2 vision layers, the whole 6-layer Perceiver with 64 latents,
    float32, batch 1, the 2-demo 0-shot prompt, gates opened: the per-sample
    loss (1e-4 relative) and its pixel gradient (1e-3 of its largest
    element, and not 0). Returns the kernels' launches of the card's run."""
    import numpy as np
    import torch

    from robustvlm_tpu_torch.models.flamingo.convert import init_random_state
    from robustvlm_tpu_torch.models.flamingo.model import Flamingo
    from robustvlm_tpu_torch.vlm_eval.eval_models import FlamingoEvalModel, WordTokenizer

    t0 = time.perf_counter()
    cfg = _flamingo_cut(4, 2)
    state = init_random_state(cfg, 0, "cpu")
    for i in range(cfg.n_xattn):
        for gate in ("attn_gate", "ff_gate"):
            state[f"xattn.{i}.{gate}"].fill_(FLAMINGO_GATE)
    size = cfg.vision.image_size
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 3, size, size).astype(np.float32))
    out, launches, seq_len = {}, None, None
    torch.cuda.reset_peak_memory_stats()
    for dev in ("cpu", "cuda"):
        model = Flamingo.from_state(cfg, {k: v.to(dev) for k, v in state.items()})
        adapter = FlamingoEvalModel(model, WordTokenizer(), compute_dtype=torch.float32)
        adapter.set_inputs([flamingo_prompt(adapter, FLAMINGO_IMAGES[0][0])])
        seq_len = int(adapter._lang.shape[1])
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
    g_max = float(out["cpu"][1].abs().max())
    g_err = float((out["cuda"][1] - out["cpu"][1]).abs().max())
    checks = {"loss_rel": loss_rel <= 1e-4, "grad": g_err <= 1e-3 * g_max,
              "grad_nonzero": g_max > 0 and float(out["cuda"][1].abs().max()) > 0,
              "finite": bool(torch.isfinite(out["cuda"][1]).all()),
              "launched": _launched(launches, FLAMINGO_KERNELS[1:])}
    emit({"phase": "flamingo_reference", "model": cfg.name, "dtype": "float32", "batch": 1,
          "seq_len": seq_len, "gates": FLAMINGO_GATE, "loss": float(out["cpu"][0][0]),
          "loss_rel_err": loss_rel, "grad_max_abs_err": g_err, "grad_max_abs": g_max,
          "tol": {"loss_rel": 1e-4, "grad_of_largest": 1e-3}, "launches": launches,
          "wall_s": time.perf_counter() - t0,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "checks": checks,
          "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"flamingo_reference checks failed: {checks}")
    return launches


def flamingo_argv(img_dir, ann, out_dir, *flags) -> list:
    return ["--device", "cuda", "--model", "open_flamingo", "--model_size", "7b", "--eval_coco",
            "--coco_image_dir", str(img_dir), "--coco_annotations", str(ann),
            "--eps", str(FLAMINGO_EPS), "--max_new_tokens", "32", "--out_base_path", str(out_dir),
            "--verbose", *flags]


def flamingo_prompt_lens() -> list:
    """Token lengths of the `flamingo` phase's teacher-forced prompts, in
    its item order, built by the CLI's own steps without a model: the eval
    subset, the demo pool (the fixture's annotations, as the phase passes no
    train file), each item's 2 text-only demos and its first caption."""
    import torch

    from robustvlm_tpu_torch.models.flamingo.model import Flamingo
    from robustvlm_tpu_torch.vlm_eval import run_evaluation as R
    from robustvlm_tpu_torch.vlm_eval.datasets import CaptionDataset
    from robustvlm_tpu_torch.vlm_eval.eval_models import FlamingoEvalModel
    from robustvlm_tpu_torch.vlm_eval.fewshot import build_context_text

    img_dir, ann = _coco_fixture(OUT / "flamingo-coco", FLAMINGO_IMAGES)
    args = R.build_parser().parse_args(flamingo_argv(img_dir, ann, OUT, "--num_samples", "2"))
    tok = R._tokenizer(args)
    with torch.device("meta"):
        adapter = FlamingoEvalModel(Flamingo(R.flamingo_config(args, tok)), tok)
    size = R._image_size(args)
    ds = CaptionDataset(str(img_dir), str(ann), size=size, split="val")
    train = CaptionDataset(str(img_dir), str(ann), size=size, split="train", image_root_train=str(img_dir))
    items = R._wrap_few_shot(args, ds, train, 0, args.seed)
    lens = []
    for k in R._eval_indices(len(ds.ids), args.num_samples, args.seed):
        item = items[int(k)]
        prompt = build_context_text(adapter, item["demos"], 0) + adapter.get_caption_prompt(
            item["all_captions"][0])
        lens.append(len(adapter._encode(prompt)))
    return lens


# ------------------------------------------------------------------ phase 18
FLAMINGO_ITERS = 25  # cut from 100 for the smoke's time (PR 12)


def phase_flamingo() -> dict:
    """`run_evaluation.main` at OpenFlamingo-9B full width (32 MPT layers, 8
    gated blocks, ViT-L/14 at 224 px), random weights from seed 0 with the
    gates opened after the CLI builds the model (`open_gates_in_cli`), bf16
    APGD (--attack apgd), eps 2/255, FLAMINGO_ITERS iterations, 2 of 4 COCO-format
    images, each with 2 text-only demos of the others. Then the loss at
    x_adv is recomputed against the clean loss on the CLI's own bf16 model.
    Returns the kernels' launches."""
    import gc

    import numpy as np
    import torch

    from robustvlm_tpu_torch.vlm_eval import run_evaluation as R
    from robustvlm_tpu_torch.vlm_eval.datasets import CaptionDataset

    gc.collect()
    torch.cuda.empty_cache()
    root = OUT / "flamingo-coco"
    img_dir, ann = _coco_fixture(root, FLAMINGO_IMAGES)
    out_dir = root / "out"
    argv = flamingo_argv(img_dir, ann, out_dir, "--attack", "apgd", "--n_iter", str(FLAMINGO_ITERS),
                         "--num_samples", "2")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with open_gates_in_cli({}) as seen:
        result = R.main(argv)["coco"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated() / 2**30

    adapter = seen["adapters"]["half"]
    state = json.loads((out_dir / "coco" / "ensemble_state.json").read_text())
    size = R._image_size(R.build_parser().parse_args(argv))
    ds = CaptionDataset(str(img_dir), str(ann), size=size, split="val")
    clean = {str(iid): ds[k]["image"] for k, iid in enumerate(ds.ids)}
    per_image = []
    with torch.no_grad():
        # the runner sets one prompt an attacked image, in its item order
        for iid, prompts in zip(state["ids"], seen["prompts"]):
            x = np.asarray(clean[iid], np.float32)
            x_adv = np.load(out_dir / "coco" / "adv" / f"{iid}.npy")
            adapter.set_inputs(prompts)
            losses = [float(adapter(torch.from_numpy(a[None]).cuda())[0]) for a in (x, x_adv)]
            per_image.append({
                "image_id": iid, "loss_clean": losses[0], "loss_adv": losses[1],
                "linf": float(np.abs(x_adv.astype(np.float64) - x).max()),
                "in_box": bool(x_adv.min() >= 0.0 and x_adv.max() <= 1.0),
                "caption": state["best_outputs"][iid], "prompt_tokens": int(adapter._lang.shape[1]),
            })
    del adapter, seen
    gc.collect()
    torch.cuda.empty_cache()
    checks = {
        "in_box": all(r["in_box"] for r in per_image),
        "in_ball": all(r["linf"] <= FLAMINGO_EPS / 255.0 + 1e-6 for r in per_image),
        "loss_raised": all(r["loss_adv"] > r["loss_clean"] for r in per_image),
        "captions": all(isinstance(r["caption"], str) for r in per_image),
        "cider": isinstance(result["cider"], float) and math.isfinite(result["cider"]),
        "launched": _launched(launches, FLAMINGO_KERNELS),
        "linf_step_per_iteration": launches["linf_step"] == FLAMINGO_ITERS * len(per_image),
        # the ALiBi kernel rows were checked and timed at this length
        "prompt_tokens_as_kernel_rows": [r["prompt_tokens"] for r in per_image] == flamingo_prompt_lens(),
        "iterations": result["attack_iters"] == FLAMINGO_ITERS * len(per_image) == 2 * FLAMINGO_ITERS,
    }
    lens = [r["prompt_tokens"] for r in per_image]
    emit({"phase": "flamingo", "entry": "robustvlm_tpu_torch.vlm_eval.run_evaluation.main",
          "argv": argv, "model": "openflamingo-9b", "dtype": "bfloat16", "gates": FLAMINGO_GATE,
          "prompt_tokens": lens, "wall_s": wall, "attack_s": result["attack_s"],
          "attack_iters": result["attack_iters"],
          "ms_per_apgd_iter": result["attack_s"] / result["attack_iters"] * 1e3,
          "peak_mem_gib": peak, "cider": result["cider"], "per_image": per_image,
          "eps": FLAMINGO_EPS / 255.0, "launches": launches, "card": card_line(),
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"flamingo checks failed: {checks}")
    return launches


# ------------------------------------------------------------------ phase 19
def phase_flamingo_ensemble() -> dict:
    """`--attack ensemble` at OpenFlamingo-9B full width on one image: one
    set of random weights (seed 0, gates opened) held as one float32 and one
    bf16 copy, the clean pass, five bf16 APGD stages and the float32
    prev-best stage at FLAMINGO_ENSEMBLE_ITERS iterations each, through
    `evaluate_captioning` with the early-stop threshold at -inf (random
    weights caption at CIDEr 0, under COCO's 10). Then the float32 adapter's
    loss and pixel gradient are timed alone. Returns the float32 stage's
    launches."""
    import gc

    import numpy as np
    import torch

    from robustvlm_tpu_torch.vlm_eval import run_evaluation as R
    from robustvlm_tpu_torch.vlm_eval.datasets import CaptionDataset

    gc.collect()
    torch.cuda.empty_cache()
    img_dir, ann = _coco_fixture(OUT / "flamingo-coco", FLAMINGO_IMAGES)
    out_dir = OUT / "flamingo-ensemble"
    argv = flamingo_argv(img_dir, ann, out_dir, "--attack", "ensemble", "--n_iter",
                         str(FLAMINGO_ENSEMBLE_ITERS), "--num_samples", "1")
    args = R.build_parser().parse_args(argv)
    schedule = R.attack_schedule(args)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _reset_launches()
    t0 = time.perf_counter()
    built = R.build_models(args, {s.precision for s in schedule}, torch.device("cuda"))
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - before
    held = {t.data_ptr(): t.numel() * t.element_size()
            for m in built.values() for t in m.state_dict().values()}
    n_params = sum(t.numel() for t in built["full"].state_dict().values())
    n_matrix = sum(t.numel() for t in built["half"].state_dict().values() if t.dtype == torch.bfloat16)
    models = _FullStageLaunches(built)
    with open_gates_in_cli({}) as seen:
        result = R.evaluate_captioning(args, "coco", str(img_dir), str(ann), models=models,
                                       threshold=-math.inf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = _launches()
    full = {k: total[k] - models.at_full[k] for k in total}
    peak = torch.cuda.max_memory_allocated() / 2**30

    adapter = seen["adapters"]["full"]
    adapter.set_inputs(seen["prompts"][-1])
    iid = json.loads((out_dir / "coco" / "ensemble_state.json").read_text())["ids"][0]
    ds = CaptionDataset(str(img_dir), str(ann), size=R._image_size(args), split="val")
    x_np = np.asarray(ds[[str(i) for i in ds.ids].index(iid)]["image"], np.float32)
    x = torch.from_numpy(x_np[None]).cuda()

    def fp32_iteration():
        xa = x.clone().requires_grad_(True)
        torch.autograd.grad(adapter(xa).sum(), xa)

    fp32_ms = time_ms(fp32_iteration, iters=3, warmup=1)
    del adapter, seen, models, built
    gc.collect()
    torch.cuda.empty_cache()
    state = json.loads((out_dir / "coco" / "ensemble_state.json").read_text())
    x_adv = np.load(out_dir / "coco" / "adv" / f"{iid}.npy")
    linf = float(np.abs(x_adv.astype(np.float64) - x_np).max())
    checks = {
        "every_stage_ran": (state["stages_done"] == len(schedule)
                            and result["attack_iters"] == (len(schedule) - 1) * FLAMINGO_ENSEMBLE_ITERS),
        "one_copy_per_precision": sum(held.values()) == 4 * n_params + 2 * n_matrix,
        "nothing_else_allocated": allocated <= sum(held.values()) + 2**26,
        "in_box": bool(x_adv.min() >= 0.0 and x_adv.max() <= 1.0),
        "in_ball": linf <= FLAMINGO_EPS / 255.0 + 1e-6,
        "caption": isinstance(state["best_outputs"][iid], str),
        "cider": isinstance(result["cider"], float) and math.isfinite(result["cider"]),
        "launched": _launched(total, FLAMINGO_KERNELS),
        "float32_stage_launched_alibi": _launched(full, FLAMINGO_KERNELS[3:]),
    }
    emit({"phase": "flamingo_ensemble", "entry": "robustvlm_tpu_torch.vlm_eval.run_evaluation."
          "evaluate_captioning", "argv": argv, "threshold": "-inf", "model": "openflamingo-9b",
          "gates": FLAMINGO_GATE, "stages": len(schedule), "iters_per_stage": FLAMINGO_ENSEMBLE_ITERS,
          "wall_s": wall, "attack_s": result["attack_s"], "attack_iters": result["attack_iters"],
          "float32_ms_per_loss_and_grad": fp32_ms, "weights_allocated_gib": allocated / 2**30,
          "held_tensor_gib": sum(held.values()) / 2**30, "peak_mem_gib": peak,
          "launches": total, "launches_float32_stage": full, "linf": linf,
          "cider": result["cider"], "card": card_line(), "checks": checks,
          "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"flamingo_ensemble checks failed: {checks}")
    return full


def check_flash_alibi(peaks: dict, n: int, case: str = "alibi_openflamingo", tag: str = "",
                      launches_from=("flamingo", "flamingo_ensemble[float32 stage]"),
                      launches_cut: str = "") -> list:
    """The flash forward and backward with ALiBi at an MPT-7B shape: 32
    heads of 128, causal, the slopes of `alibi_slopes(32)`, n tokens:
    OpenFlamingo's (`flamingo`'s longest teacher-forced prompt,
    `flamingo_prompt_lens`) or LLaVA-MPT's (`llava_mpt_seq_len`, the row
    names tagged with `tag`); float32 and bf16. The same checks as the other
    flash rows (limits ATTN_TOL/LSE_TOL, four planted faults caught, the
    backward bitwise repeatable); times by CUDA-graph replay against SDPA
    with the ALiBi bias and the causal mask as one additive float attn_mask
    (in q's dtype). Rows take their launches from `launches_from` (bf16's
    run, float32's run): by default `flamingo` and the float32 stage of
    `flamingo_ensemble`; `launches_cut` names the depth cut of a run that
    is not at full depth, in the rows as `launches_cut`."""
    import torch
    import torch.nn.functional as Fn

    from robustvlm_tpu_torch.models.mpt.model import alibi_slopes
    from robustvlm_tpu_torch.ops.kernels import flash_attention as F

    bh, d = 32, 128
    slopes = torch.from_numpy(alibi_slopes(bh)).cuda()
    i = torch.arange(n, device="cuda")
    rel = (i[:, None] - i[None, :]).float()
    bias = torch.where(rel >= 0, -slopes[:, None, None] * rel, -math.inf)[None]  # (1, H, n, n)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        (q, k, v, do), _ = _flash_inputs(bh, n, n, d, dtype, seed=n)
        kw = dict(causal=True, slopes=slopes)
        o, lse = F.flash_fwd_cuda(q, k, v, **kw)
        grads = F.flash_bwd_cuda(q, k, v, o, lse, do, **kw)
        again = F.flash_bwd_cuda(q, k, v, o, lse, do, **kw)
        got = (o, lse, *grads)
        ref = _flash_plain_all(q, k, v, do, kw)
        res = _attn_check(dname, got, ref, False)
        repeatable = all(torch.equal(a, b) for a, b in zip(grads, again))
        controls = _flash_controls(dname, q, k, v, do, kw, got, ref)
        ok = all(r[1] for r in res.values()) and repeatable and all(controls.values())
        emit({"phase": "kernels", "kernel": "flash_attention", "case": case,
              "dtype": dname, "shape": [bh, n, n, d], "causal": True, "alibi": True,
              "max_abs_err": {m: e for m, (e, _) in res.items()},
              "within": {m: w for m, (_, w) in res.items()}, "bwd_bitwise_repeatable": repeatable,
              "controls_caught": controls,
              "tol": {"outputs": ATTN_TOL[dname], "relative_to_max_ref": dname != "float32",
                      "lse": LSE_TOL}, "ok": ok})
        if not ok:
            raise AssertionError(f"flash_attention {dname} with ALiBi ({case}, n = {n}): "
                                 "disagrees, is not repeatable, or a planted fault passed")
        fwd_ms = time_graph_ms(lambda: F.flash_fwd_cuda(q, k, v, **kw))
        fwd_plain = time_ms(lambda: F.flash_fwd_plain(q, k, v, **kw), iters=5)
        bwd_ms = time_graph_ms(lambda: F.flash_bwd_cuda(q, k, v, o, lse, do, **kw))
        bwd_plain = time_ms(lambda: F.flash_bwd_plain(q, k, v, o, lse, do, **kw), iters=5)
        q4, k4, v4, do4 = (t.view(1, bh, n, d) for t in (q, k, v, do))
        mask = bias.to(dtype)

        def sdpa_alibi(q_, k_, v_):
            return Fn.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask)

        lib_fwd = time_graph_ms(lambda: sdpa_alibi(q4, k4, v4))
        lib_err = float((sdpa_alibi(q4, k4, v4).float() - ref[0].view(1, bh, n, d).float()).abs().max())
        fwd_backend = sdpa_backend(lambda: sdpa_alibi(q4, k4, v4))
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
        lib_bwd = time_graph_fwd_bwd_ms(sdpa_alibi, (ql, kl, vl), do4)
        lib_bwd.update(sdpa_backend(lambda: torch.autograd.grad(sdpa_alibi(ql, kl, vl), (ql, kl, vl), do4)))
        itm = q.element_size()
        elems = bh * n * d
        causal_pairs = bh * n * (n + 1) / 2
        fb, fby = bound_ms(4 * elems * itm + bh * n * 4, 4 * causal_pairs * d, dname, peaks)
        bb, bby = bound_ms(8 * elems * itm + bh * n * 4, 10 * causal_pairs * d, dname, peaks)
        common = {"route": "cuda", "dtype": dname, "shape": [bh, n, d], "causal": True, "alibi": True,
                  "launches_from": launches_from[1] if dtype == torch.float32 else launches_from[0],
                  **({"launches_cut": launches_cut} if launches_cut else {}),
                  "library": "SDPA, ALiBi bias + causal mask as one additive float attn_mask"}
        suffix = f", {tag}" if tag else ""
        rows.append({"name": f"flash_attention_fwd_alibi[{dname}{suffix}]", **common,
                     **_attn_source("fwd", dname, "flash_attention.cu"),
                     "replaces": "robustvlm_tpu/ops/pallas/flash_attention.py:154",
                     "max_abs_err": res["o"][0], "ms": fwd_ms, "plain_ms": fwd_plain,
                     "bound_ms": fb, "bound_by": fby, "library_ms": lib_fwd,
                     "library_max_abs_err": lib_err, **fwd_backend, "timed_by": TIMED_BY["fwd"]})
        rows.append({"name": f"flash_attention_bwd_alibi[{dname}{suffix}]", **common,
                     **_attn_source("bwd", dname, "flash_attention.cu"),
                     "replaces": "robustvlm_tpu/ops/pallas/flash_attention.py:273 (dQ), :295 (dK/dV)",
                     "max_abs_err": max(res["dq"][0], res["dk"][0], res["dv"][0]), "ms": bwd_ms,
                     "plain_ms": bwd_plain, "bound_ms": bb, "bound_by": bby, **lib_bwd,
                     "timed_by": TIMED_BY["bwd"]})
    return rows


# ------------------------------------------------------------------ phases 20-21
# The zero-shot benchmark suite. `benchmark_reference`: ConvNeXt-B
# (convnext_base_w) at full width and ViT-g/14 widths cut to 2 vision
# layers (the head dim 88 kernels inside a real tower), float32, card
# against CPU, at the limits of `reference` (logits 1e-3 abs and 1e-4 of the
# largest, pixel gradient 1e-3 relative). The text towers are cut to one
# layer: these checks feed a random class matrix, not the text tower.
BENCH_REF_TOL = {"logits_abs": 1e-3, "logits_rel": 1e-4, "grad_rel": 1e-3}
BENCH_REF_CASES = (("convnext_base_w", None), ("ViT-g-14", 2))


def _cut_config(name: str, vision_layers):
    import dataclasses

    from robustvlm_tpu_torch.models.clip import CLIP_CONFIGS

    cfg = CLIP_CONFIGS[name]
    vision = cfg.vision if vision_layers is None else dataclasses.replace(cfg.vision, layers=vision_layers)
    return dataclasses.replace(cfg, vision=vision, text=dataclasses.replace(cfg.text, layers=1))


def phase_benchmark_reference() -> dict:
    """Returns the kernels' launches of the ViT-g/14 cut (its float32 D = 88
    rows' source)."""
    import numpy as np
    import torch

    from robustvlm_tpu_torch.eval.classifier import make_zero_shot_classifier
    from robustvlm_tpu_torch.models.clip import CLIP

    launches = {}
    for name, layers in BENCH_REF_CASES:
        cfg = _cut_config(name, layers)
        npr = np.random.RandomState(0)
        x = torch.from_numpy(npr.rand(2, 3, cfg.image_size, cfg.image_size).astype(np.float32))
        temb = torch.from_numpy(npr.randn(cfg.embed_dim, 10).astype(np.float32))
        temb = temb / temb.norm(dim=0, keepdim=True)
        cpu = CLIP(cfg, device="cpu").init_random_(0)
        gpu = CLIP(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        out = {}
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            if dev == "cuda":
                _reset_launches()
            fn = make_zero_shot_classifier(model, temb.to(dev))
            xa = x.to(dev).requires_grad_(True)
            logits = fn(xa)
            (grad,) = torch.autograd.grad(logits[:, 0].sum(), xa)
            out[dev] = (logits.detach().cpu(), grad.cpu())
        launches[name] = _launches()
        lg_err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
        lg_rel = lg_err / float(out["cpu"][0].abs().max())
        g_rel = float((out["cuda"][1] - out["cpu"][1]).norm() / out["cpu"][1].norm())
        vit = launches[name]["vit_attention_fwd"] > 0 and launches[name]["vit_attention_bwd"] > 0
        checks = {"logits_abs": lg_err <= BENCH_REF_TOL["logits_abs"],
                  "logits_rel": lg_rel <= BENCH_REF_TOL["logits_rel"],
                  "grad_rel": g_rel <= BENCH_REF_TOL["grad_rel"],
                  "finite": bool(torch.isfinite(out["cuda"][1]).all()),
                  # the ConvNeXt tower has no attention; the ViT-g/14 cut runs the D = 88 kernels
                  "vit_kernels": vit if cfg.vision_arch == "vit" else not vit}
        emit({"phase": "benchmark_reference", "model": name, "batch": 2, "image_size": cfg.image_size,
              "cut": ("full vision width and depth" if layers is None else f"{layers} of 40 vision layers")
              + ", 1 text layer (unused)", "head_dim": None if cfg.vision_arch != "vit"
              else cfg.vision.width // cfg.vision.heads, "logits_max_abs_err": lg_err,
              "logits_rel_err": lg_rel, "grad_rel_err": g_rel, "tol": BENCH_REF_TOL,
              "launches": launches[name], "checks": checks, "ok": all(checks.values())})
        if not all(checks.values()):
            raise AssertionError(f"benchmark_reference {name}: {checks}")
        del cpu, gpu
        _free()
    return launches["ViT-g-14"]


# `benchmark`: the benchmark CLI (`benchmark.cli.main`) at full width on
# fixtures the phase writes under chiprun_out/: a wds/vtab/cifar10-layout
# webdataset (2 tar shards of 16 PNGs at 224 px, nshards.txt, the CIFAR-10
# classnames, two templates; the train split is the same shards) and a
# COCO-style captions fixture (8 images, 2 captions each, and a predictions
# json). Random weights from seed 0, the hash tokenizer, eps 2/255; under
# attack the labels are the model's clean predictions (_AttackProbe).
BENCH_SHARDS, BENCH_PER_SHARD = 2, 16
BENCH_RUNS = {  # name -> (model, compute dtype, extra argv)
    "ViT-L-14": ("ViT-L-14", "bfloat16", ["--attack", "aa", "--n_iter", "20", "--n_samples", "16"]),
    "ViT-g-14": ("ViT-g-14", "bfloat16", ["--attack", "aa", "--n_iter", "5", "--n_samples", "8"]),
    "convnext_base_w": ("convnext_base_w", "bfloat16", ["--attack", "aa", "--n_iter", "5", "--n_samples", "8"]),
    "ja_clip-vit-b-16": ("ja_clip-vit-b-16", "float32", ["--n_samples", "16"]),
}
BENCH_EPS = 2.0  # /255
BENCH_TASK_MODEL = "ViT-L-14"  # runs the four other tasks


def _bench_fixture(root):
    import io
    import json
    import shutil
    import tarfile

    import numpy as np
    from PIL import Image

    from robustvlm_tpu_torch.benchmark.templates import get_classnames

    npr = np.random.RandomState(0)

    def png(h, w):
        buf = io.BytesIO()
        Image.fromarray(npr.randint(0, 256, (h, w, 3), np.uint8)).save(buf, "PNG")
        return buf.getvalue()

    wds = root / "wds"
    (wds / "test").mkdir(parents=True)
    idx = 0
    for s in range(BENCH_SHARDS):
        with tarfile.open(wds / "test" / f"{s}.tar", "w") as tf:
            for _ in range(BENCH_PER_SHARD):
                for ext, data in (("png", png(224, 224)), ("cls", str(idx % 10).encode())):
                    info = tarfile.TarInfo(f"{idx:06d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
                idx += 1
    (wds / "test" / "nshards.txt").write_text(str(BENCH_SHARDS))
    shutil.copytree(wds / "test", wds / "train")  # the linear probe trains on the same shards
    (wds / "classnames.txt").write_text("\n".join(get_classnames("cifar10")) + "\n")
    (wds / "zeroshot_classification_templates.txt").write_text("a photo of a {c}.\na blurry photo of a {c}.\n")
    cap = root / "captions"
    (cap / "img").mkdir(parents=True)
    images, anns, preds = [], [], []
    for i in range(8):
        (cap / "img" / f"{i}.png").write_bytes(png(240, 320))
        images.append({"id": i, "file_name": f"{i}.png"})
        anns += [{"image_id": i, "id": 2 * i + j, "caption": c}
                 for j, c in enumerate((f"a photo of object {i} on a table", f"picture number {i}"))]
        preds.append({"image_id": i, "caption": f"a photo of object {i}"})
    (cap / "ann.json").write_text(json.dumps({"images": images, "annotations": anns}))
    (cap / "preds.json").write_text(json.dumps(preds))
    return wds, cap


class _AttackProbe:
    """Around `benchmark.cli.main`: each AutoAttack run's x and x_adv and its
    seconds, and the APGD runs (each `apgd_attack` call launches `linf_step`
    n_iter times). Under attack the labels are the model's own
    clean predictions, as `main`'s `--labels predicted`: a random model is
    right on few images, and AutoAttack attacks only those, so every image
    is attacked (a smoke setting; the adversarial accuracy is then not
    robust accuracy)."""

    def __init__(self):
        from robustvlm_tpu_torch.attacks import apgd
        from robustvlm_tpu_torch.benchmark import zeroshot
        from robustvlm_tpu_torch.eval import autoattack

        self.mods = (apgd, zeroshot, autoattack.AutoAttack)
        self.real = (apgd.apgd_attack, zeroshot.run_classification,
                     autoattack.AutoAttack.run_standard_evaluation)
        self.reset()

    def reset(self):
        self.adv, self.apgd_iters, self.attack_s = [], 0, 0.0

    def __enter__(self):
        apgd, zeroshot, aa = self.mods
        real_apgd, real_rc, real_rse = self.real

        def apgd_attack(*a, n_iter=100, **kw):
            self.apgd_iters += n_iter
            return real_apgd(*a, n_iter=n_iter, **kw)

        def run_classification(logits_fn, data, **kw):
            import torch

            def predicted():
                for xb, _ in data:
                    with torch.no_grad():
                        yield xb, logits_fn(torch.as_tensor(xb).to(kw["device"])).argmax(-1).cpu().numpy()

            return real_rc(logits_fn, predicted() if kw.get("attack") else data, **kw)

        def run_standard_evaluation(inner, x, y, **kw):
            import torch

            t0 = time.perf_counter()
            x_adv = real_rse(inner, x, y, **kw)
            torch.cuda.synchronize()
            self.attack_s += time.perf_counter() - t0
            self.adv.append((x_adv.numpy(), x))
            return x_adv

        apgd.apgd_attack, zeroshot.run_classification = apgd_attack, run_classification
        aa.run_standard_evaluation = run_standard_evaluation
        return self

    def __exit__(self, *exc):
        apgd, zeroshot, aa = self.mods
        apgd.apgd_attack, zeroshot.run_classification, aa.run_standard_evaluation = self.real


def _metrics_in_range(metrics: dict) -> bool:
    """Finite and in [0, 1]; CIDEr in [0, 10] (pycocoevalcap's scale)."""
    return all(math.isfinite(v) and 0.0 <= v <= (10.0 if k == "CIDEr" else 1.0) for k, v in metrics.items())


def phase_benchmark() -> dict:
    """Returns {f"benchmark[{model}]": launches} of each classification run."""
    import shutil

    import numpy as np
    import torch

    from robustvlm_tpu_torch.benchmark import builder, cli
    from robustvlm_tpu_torch.data import native

    root = OUT / "benchmark"
    shutil.rmtree(root, ignore_errors=True)
    wds, cap = _bench_fixture(root)
    native_ok = native.available() and getattr(builder.WdsShardDataset([], size=224).transform, "native", False)
    common = ["--device", "cuda", "--pretrained", "random", "--eps", str(BENCH_EPS), "--batch_size", "16"]
    runs = {}
    with _AttackProbe() as probe:
        for name, (model, dtype, extra) in BENCH_RUNS.items():
            probe.reset()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            t0 = time.perf_counter()
            res = cli.main(["eval", "--model", model, "--dataset", "wds/vtab/cifar10", "--dataset_root", str(wds),
                            "--compute_dtype", dtype, "--output", str(root / "{model}_{task}.json"), *common,
                            *extra])[0]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = _launches()
            runs[f"benchmark[{name}]"] = launches
            m = res["metrics"]
            checks = {"metrics_in_range": _metrics_in_range(m), "native_transform": bool(native_ok),
                      "flash_text_tower": launches["flash_attention_fwd"] > 0 or name.startswith("ja_clip")}
            line = {"phase": "benchmark", "model": model, "task": "zeroshot_classification",
                    "compute_dtype": dtype, "argv_extra": extra, "metrics": m, "seconds": secs,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches}
            if "--attack" in extra:
                (x_adv, x), = probe.adv
                linf = float(np.abs(x_adv.astype(np.float64) - x).max())
                checks.update({
                    "adv_le_clean": m["adv_acc1"] <= m["acc1"],
                    "x_adv_in_box": bool(np.isfinite(x_adv).all() and x_adv.min() >= 0 and x_adv.max() <= 1),
                    "x_adv_in_ball": linf <= BENCH_EPS / 255.0 + 1e-6,
                    "linf_step_is_the_cascades": launches["linf_step"] == probe.apgd_iters,
                })
                line.update({"linf_max": linf, "apgd_iterations": probe.apgd_iters,
                             "attack_s": probe.attack_s,
                             "ms_per_apgd_iteration": (1e3 * probe.attack_s / probe.apgd_iters
                                                       if probe.apgd_iters else None)})
            if "convnext" in model:
                checks["no_vit_attention"] = launches["vit_attention_fwd"] == launches["vit_attention_bwd"] == 0
            else:  # the ViT towers (ja_clip's is ViT-B/16)
                checks["vit_attention"] = launches["vit_attention_fwd"] > 0 and (
                    "--attack" not in extra or launches["vit_attention_bwd"] > 0)
            line.update({"checks": checks, "ok": all(checks.values())})
            emit(line)
            if not all(checks.values()):
                raise AssertionError(f"benchmark {name}: {checks}")
            _free()
    # the other four tasks at ViT-L/14, float32 (the CLI's dtype for them, as in JAX)
    model = BENCH_TASK_MODEL
    for task, extra in (("zeroshot_retrieval", ["--dataset_root", str(cap / "img"), "--retrieval_annotations",
                                                str(cap / "ann.json")]),
                        ("image_caption_selection", ["--dataset_root", str(cap / "img"),
                                                     "--retrieval_annotations", str(cap / "ann.json")]),
                        ("linear_probe", ["--dataset_root", str(wds)]),
                        ("captioning", ["--predictions", str(cap / "preds.json"), "--retrieval_annotations",
                                        str(cap / "ann.json")])):
        t0 = time.perf_counter()
        dataset = "wds/vtab/cifar10" if task == "linear_probe" else "mscoco_captions"
        res = cli.main(["eval", "--model", model, "--dataset", dataset, "--task", task,
                        "--output", str(root / "{model}_{task}.json"), *common, *extra])[0]
        torch.cuda.synchronize()
        checks = {"metrics_in_range": _metrics_in_range(res["metrics"]) and bool(res["metrics"])}
        emit({"phase": "benchmark", "model": model, "task": task, "metrics": res["metrics"],
              "seconds": time.perf_counter() - t0, "checks": checks, "ok": all(checks.values())})
        if not all(checks.values()):
            raise AssertionError(f"benchmark {model} {task}: {checks}")
    _free()
    return runs


# ------------------------------------------------------------------ phase 22
SERVE_ARGV = ["--device", "cuda", "--model", "llava", "--model_size", "7b", "--quantize-decode",
              "--quantize-bits", "4", "--host", "127.0.0.1", "--port", "0", "--controller-address", ""]
SERVE_NEW_TOKENS = 32
SERVE_BATCH = 4
LAUNCHES_PER_STEP = 225  # 32 layers x 7 LM matrices + the LM head
LOGIT_TOL = 2e-2  # of the largest |logit|: one step through 32 bf16 layers


class _StepTimer:
    """Wraps `make_llava_decode_fns` so every generation records CUDA events:
    before the decode fns are made (the vision tower runs there), after the
    prefill and after each decode step. Events do not synchronize."""

    def __init__(self, make):
        self.make, self.runs = make, []

    def _event(self):
        import torch

        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def __call__(self, *a, **kw):
        run = {"start": self._event(), "prefill": None, "steps": [], "batch": a[1].shape[0]}
        self.runs.append(run)
        pf, df = self.make(*a, **kw)

        def prefill(*b, **k):
            out = pf(*b, **k)
            run["prefill"] = self._event()
            return out

        def decode(*b, **k):
            out = df(*b, **k)
            run["steps"].append(self._event())
            return out

        return prefill, decode

    @staticmethod
    def summary(run) -> dict:
        steps = run["steps"]
        return {"batch": run["batch"], "decode_steps": len(steps),
                "prefill_ms": run["start"].elapsed_time(run["prefill"]),
                "ms_per_decode_step": run["prefill"].elapsed_time(steps[-1]) / len(steps)}


def _png_b64(arr) -> str:
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _held_bytes(model) -> int:
    return sum({t.data_ptr(): t.numel() * t.element_size() for t in model.state_dict().values()}.values())


def _bf16_model_bytes(cfg) -> int:
    """What the bf16 LLaVA model (`half_state`) holds: matrices in bf16, the
    projector and 1-D parameters in float32."""
    import torch

    from robustvlm_tpu_torch.models.llava.model import Llava, half_state

    with torch.device("meta"):
        state = half_state(Llava(cfg).state_dict())
    return sum(t.numel() * t.element_size() for t in state.values())


def _decode_logits_check(adapter, x, prompt) -> dict:
    """One decode step's logits at full width through the kernel, and the
    same step with the kernel's plain version patched in (here only)."""
    import torch

    from robustvlm_tpu_torch.models.generation import _start
    from robustvlm_tpu_torch.ops.kernels import q4_matmul as Q

    with torch.no_grad():
        pf, df, toks, n_pad = adapter._decode_fns(x, [prompt], 1)
        logits0, cache, mask = _start(pf, toks, n_pad, 1)
        t = toks.shape[1]
        mask[:, t] = True
        args = (torch.argmax(logits0, -1)[:, None], cache, t, mask, (t - n_pad)[:, None])
        kernel = df(*args)[0][:, -1].float()
        true_cuda = Q.q4_matmul_cuda
        Q.q4_matmul_cuda = lambda xx, pp, ss: Q.q4_matmul_reference(xx, pp, ss)
        try:
            plain = df(*args)[0][:, -1].float()
        finally:
            Q.q4_matmul_cuda = true_cuda
    err = float((kernel - plain).abs().max())
    top = float(plain.abs().max())
    return {"max_abs_err": err, "max_abs_logit": top, "tol_rel_to_max": LOGIT_TOL,
            "within": err <= LOGIT_TOL * top,
            "same_argmax": bool(torch.equal(kernel.argmax(-1), plain.argmax(-1)))}


def phase_serve() -> tuple:
    """The model worker at LLaVA-1.5-7B full width (32 LM layers, the 336 px
    tower), random weights from seed 0, built as its CLI builds it
    (`build_worker`): float32 draws quantized in place to int4 (group 128),
    the rest held in the bf16 layout. The port's controller and the worker
    on ephemeral 127.0.0.1 ports; one caption to warm up, a timed caption
    (32 new tokens, batch 1), a VQA, a streamed caption, a caption through
    the shift body, and 4 concurrent captions to a second worker around the
    same model with a 20 ms window (one batch-4 decode); then, outside the
    counted requests, the timed caption straight from `get_outputs`. Returns
    the requests' launches and the adapter (the serving phases after it
    reuse the 7B build)."""
    import gc
    import os
    import threading

    import numpy as np
    import torch

    from robustvlm_tpu_torch.ops.quant import QUANTIZED
    from robustvlm_tpu_torch.serve import controller as C
    from robustvlm_tpu_torch.serve import model_worker as MW
    from robustvlm_tpu_torch.vlm_eval import eval_models

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    worker = MW.build_worker(MW.build_parser().parse_args(SERVE_ARGV))
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    adapter = worker.model
    model = adapter.model
    peak_startup = torch.cuda.max_memory_allocated() / 2**30
    held = _held_bytes(model)
    allocated = torch.cuda.memory_allocated() - before
    lm = [m for name, m in model.llama.named_modules() if name.endswith((".attn", ".mlp"))]
    lm_quantized = (all(isinstance(getattr(m, leaf), QUANTIZED) for m in lm
                        for leaf in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
                        if hasattr(m, leaf))
                    and isinstance(model.llama.lm_head, QUANTIZED)
                    and not any(p.dtype == torch.bfloat16 for p in model.llama.blocks.parameters()
                                if p.dim() == 2))

    ctrl = C.serve("127.0.0.1", 0)
    wsrv = MW.serve_worker(worker, "127.0.0.1", 0)
    batch_worker = MW.ModelWorker(adapter, "llava-7b-batched", worker_address="",
                                  image_size=worker.image_size, batch_window_ms=20,
                                  max_batch=SERVE_BATCH)
    bsrv = MW.serve_worker(batch_worker, "127.0.0.1", 0)
    for srv in (ctrl, wsrv, bsrv):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    ctrl_addr = f"http://127.0.0.1:{ctrl.server_address[1]}"
    worker.worker_address = f"http://127.0.0.1:{wsrv.server_address[1]}"
    batch_addr = f"http://127.0.0.1:{bsrv.server_address[1]}"

    rng = np.random.RandomState(0)
    images = [_png_b64(rng.randint(0, 255, (360, 400, 3), np.uint8)) for _ in range(SERVE_BATCH)]
    cap = {"model": worker.model_name, "image_b64": images[0], "task": "caption",
           "max_new_tokens": SERVE_NEW_TOKENS}
    timer = _StepTimer(eval_models.make_llava_decode_fns)
    eval_models.make_llava_decode_fns = timer
    responses = {}
    try:
        registered = _post_json(ctrl_addr + "/register_worker",
                           {"worker_name": worker.worker_address, "check_heart_beat": False})["exist"]
        responses["warmup"] = _post_json(ctrl_addr + "/worker_generate", {**cap, "max_new_tokens": 4})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        n_runs = len(timer.runs)
        t1 = time.perf_counter()
        responses["caption"] = _post_json(ctrl_addr + "/worker_generate", cap)
        torch.cuda.synchronize()
        caption_s = time.perf_counter() - t1
        timed = timer.runs[n_runs]
        responses["vqa"] = _post_json(ctrl_addr + "/worker_generate",
                                {**cap, "task": "vqa", "question": "What is in the image?"})
        chunks = _timed_stream(ctrl_addr + "/worker_generate_stream", cap)["chunks"]
        os.environ["Q4_KERNEL"] = "shift"
        try:
            responses["caption_shift_body"] = _post_json(ctrl_addr + "/worker_generate", cap)
        finally:
            del os.environ["Q4_KERNEL"]
        n_runs = len(timer.runs)
        results = [None] * SERVE_BATCH
        go = threading.Barrier(SERVE_BATCH)

        def send(i):
            go.wait()
            results[i] = _post_json(batch_addr + "/worker_generate", {**cap, "image_b64": images[i]})

        threads = [threading.Thread(target=send, args=(i,)) for i in range(SERVE_BATCH)]
        t2 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t2
        batch_runs = timer.runs[n_runs:]
        launches = _launches()
        peak_serving = torch.cuda.max_memory_allocated() / 2**30
        # the same caption straight from the adapter, outside the counted requests
        x = torch.from_numpy(worker.decode_image(cap))[None].cuda()
        direct = adapter.get_outputs(x, [adapter.get_caption_prompt()],
                                     max_new_tokens=SERVE_NEW_TOKENS)[0]
    finally:
        eval_models.make_llava_decode_fns = timer.make
        for srv in (ctrl, wsrv, bsrv):
            srv.shutdown()
            srv.server_close()
    logits = _decode_logits_check(adapter, x, adapter.get_caption_prompt())

    one = _StepTimer.summary(timed)
    four = [_StepTimer.summary(r) for r in batch_runs]
    every = [responses[k] for k in responses] + chunks + results
    checks = {
        "registered": registered,
        "error_code_0": all(r is not None and r.get("error_code") == 0 for r in every),
        "served_equals_get_outputs": responses["caption"]["text"] == direct,
        "stream_last_equals_text": bool(chunks) and chunks[-1]["text"] == responses["caption"]["text"],
        "batch_4_decode": bool(four) and all(r["batch"] == SERVE_BATCH for r in four),
        "q4_group_launches": (launches["q4_matmul_group"] > 0
                              and launches["q4_matmul_group"] % LAUNCHES_PER_STEP == 0),
        "q4_shift_launches": (launches["q4_matmul_shift"] > 0
                              and launches["q4_matmul_shift"] % LAUNCHES_PER_STEP == 0),
        "vit_attention_launched": launches["vit_attention_fwd"] > 0,
        "no_lm_matrix_in_bf16": lm_quantized,
        "decode_logits_within": logits["within"],
        "decode_logits_same_argmax": logits["same_argmax"],
    }
    cfg = model.cfg
    del batch_worker, model
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve", "entry": "robustvlm_tpu_torch.serve.model_worker.build_worker",
          "argv": SERVE_ARGV, "model": "llava-1.5-7b", "compute_dtype": "bfloat16",
          "weights": "int4 LM (group 128), fp vision tower, projector and embedding",
          "startup_s": startup_s, "held_gib": held / 2**30, "allocated_by_startup_gib": allocated / 2**30,
          "bf16_model_gib": _bf16_model_bytes(cfg) / 2**30, "peak_startup_gib": peak_startup,
          "peak_serving_gib": peak_serving, "new_tokens": SERVE_NEW_TOKENS,
          "batch_1": {**one, "request_s": caption_s,
                      "decode_tok_per_s": 1e3 / one["ms_per_decode_step"],
                      "request_new_tok_per_s": SERVE_NEW_TOKENS / caption_s},
          "batch_4": {"calls": four, "requests_s": batch_s,
                      "decode_tok_per_s": [SERVE_BATCH * 1e3 / r["ms_per_decode_step"] for r in four],
                      "request_new_tok_per_s": SERVE_BATCH * SERVE_NEW_TOKENS / batch_s},
          "texts": {"caption": responses["caption"]["text"],
                    "caption_shift_body": responses["caption_shift_body"]["text"],
                    "vqa": responses["vqa"]["text"], "stream_chunks": len(chunks)},
          "decode_logits_kernel_vs_plain": logits, "launches": launches, "card": card_line(),
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"serve checks failed: {checks}")
    return launches, adapter


# ------------------------------------------------------------------ phases 23-25
# `--continuous --cb-slots 4 --cb-width 32 --cb-max-new 32`, and the 8
# requests' max_new_tokens (lanes free at different times, so requests join
# a batch that is decoding), sent CB_STAGGER_S apart
CB_ARGS = {"n_slots": 4, "width": 32, "max_new": 32}
CB_NEW_TOKENS = (32, 24, 32, 16, 32, 24, 16, 32)
CB_QUESTIONS = (None, "What is in the image?", None, "What color is the sky?", None,
                "How many people are there?", None, "Is it raining?")
CB_STAGGER_S = 0.25
SPEC_K = 7  # the JAX package's own setting (scripts/bench_spec.py)
SPEC_NEW_TOKENS = 32
# Token equality with the batch-1 stream on the card: a batched or wider step
# rounds in other orders (other GEMM shapes, other key lengths), and
# LOGIT_TOL bounds how far a step's bf16 logits move, relative to the
# largest |logit|, under a change of rounding order through the 32 layers
# (`_decode_logits_check`: the kernel against its plain version). Two logits
# that each move by up to that much can swap only where they are within
# twice it: a divergence is accepted only where, at the first divergent
# token, the solo path's logit of the token the other path chose is within
# NEAR_TIE x that step's largest |logit| of the solo path's top logit.
NEAR_TIE = 2 * LOGIT_TOL


def _solo_trace(adapter, x, prompt: str, n: int) -> tuple:
    """The batch-1 greedy stream (`stream_tokens`'s path: `_decode_fns` and
    `greedy_generate_stream`): its token ids and the float32 logits (on the
    host) that each came from."""
    import torch

    from robustvlm_tpu_torch.models.generation import greedy_generate_stream

    rows = []

    def prefill(*a, **k):
        logits, carry = pf(*a, **k)
        rows.append(logits[0].float().cpu())
        return logits, carry

    def decode(*a, **k):
        logits, carry = df(*a, **k)
        rows.append(logits[0, -1].float().cpu())
        return logits, carry

    tok = adapter.tok
    ids = []
    with torch.no_grad():
        pf, df, toks, n_pad = adapter._decode_fns(x, [prompt], n)
        for t in greedy_generate_stream(prefill, decode, toks, n_pad, max_new_tokens=n,
                                        eos_id=tok.eos_token_id, pad_id=tok.pad_token_id):
            if int(t[0]) in (tok.eos_token_id, tok.pad_token_id):
                break
            ids.append(int(t[0]))
    return ids, rows


def _near_tie(got: list, ref: list, rows: list, eos: int) -> dict:
    """Equal tokens, or a first divergence where the token the other path
    chose (EOS where it stopped) is within the NEAR_TIE bound of the solo
    path's top logit."""
    if got == ref:
        return {"equal": True, "ok": True}
    i = next((j for j, (a, b) in enumerate(zip(got, ref)) if a != b), min(len(got), len(ref)))
    if i >= len(rows):
        return {"equal": False, "first_divergence": i, "ok": False}
    row = rows[i]
    other = got[i] if i < len(got) else eos
    top, top_abs = float(row.max()), float(row.abs().max())
    gap = top - float(row[other])
    return {"equal": False, "first_divergence": i, "token": other, "solo_token": int(row.argmax()),
            "gap_to_top": gap, "max_abs_logit": top_abs, "bound": NEAR_TIE * top_abs,
            "ok": gap <= NEAR_TIE * top_abs}


def _timed_stream(url: str, payload: dict) -> dict:
    """/worker_generate_stream with the host times of submission, first and
    last chunk."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    chunks, times = [], []
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            chunks.append(json.loads(line))
            times.append(time.perf_counter())
    return {"chunks": chunks, "t_submit": t0, "t_first": times[0] if times else math.nan,
            "t_last": times[-1] if times else math.nan}


def _hash_ids(text: str) -> list:
    """Token ids back from the hash tokenizer's text ("tok<id>" words)."""
    return [int(w[3:]) for w in text.split()]


def _serving_stack(worker):
    """The port's controller and `worker` on ephemeral 127.0.0.1 ports, the
    worker registered: (controller address, servers)."""
    import threading
    import urllib.request

    from robustvlm_tpu_torch.serve import controller as C
    from robustvlm_tpu_torch.serve import model_worker as MW

    ctrl = C.serve("127.0.0.1", 0)
    wsrv = MW.serve_worker(worker, "127.0.0.1", 0)
    for srv in (ctrl, wsrv):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    addr = f"http://127.0.0.1:{ctrl.server_address[1]}"
    worker.worker_address = f"http://127.0.0.1:{wsrv.server_address[1]}"
    req = urllib.request.Request(addr + "/register_worker", data=json.dumps(
        {"worker_name": worker.worker_address, "check_heart_beat": False}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        if not json.loads(r.read())["exist"]:
            raise AssertionError("the worker did not register")
    return addr, (ctrl, wsrv)


def _post_json(url: str, payload: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def _wait_idle(eng, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while any(s is not None for s in eng._slots) or eng._queue:
        if time.monotonic() > deadline:
            raise AssertionError("the continuous engine did not go idle")
        time.sleep(0.01)


def _step_graph_ms(eng) -> dict:
    """One engine step of all lanes (at post slot width + 16) by CUDA-graph
    replay: its device time without the host's pace. A measurement only: if
    the step cannot be captured, the error is reported instead."""
    import numpy as np
    import torch

    step = eng._cores[1]
    ops = np.stack([eng._nxt, np.full_like(eng._pos, eng.width + 16), eng._npad])
    nxt, pos, npad = torch.from_numpy(ops).to(eng.model.device)
    try:
        with torch.no_grad():
            return {"step_device_ms": time_graph_ms(lambda: step(nxt, eng._bcaches, pos, npad),
                                                    iters=4, replays=3)}
    except Exception as e:  # noqa: BLE001 - reported, not a correctness check
        return {"step_device_ms": None, "step_graph_error": f"{type(e).__name__}: {e}"[:300]}


def phase_serve_continuous(adapter, quantize_kv: bool = False, bf16_kv: dict = None) -> tuple:
    """`--continuous` on the adapter the `serve` phase built (LLaVA-1.5-7B
    full width, int4 LM weights, bf16): an engine of 4 lanes, width 32, 32
    new tokens at most, behind the port's controller on 127.0.0.1; 8
    caption/VQA streams sent CB_STAGGER_S apart (and, in bf16 KV, 4 short
    requests through the shift body). Held: each request's tokens against
    its solo batch-1 stream (NEAR_TIE rule), a request admitted while
    another decodes, q4_matmul only at 4 rows and a multiple of 225 a step,
    the tower's ViT forward once a layer an admission; outside the counted
    requests, lane isolation (one request in lane 0 beside two sets of
    neighbours: bit-equal tokens and lane logits) and a lane cancelled on a
    stop string freeing its slot. Returns (launches, the step's numbers)."""
    import os
    import threading

    import numpy as np
    import torch

    from robustvlm_tpu_torch.serve import model_worker as MW
    from robustvlm_tpu_torch.serve.continuous import ContinuousEngine
    from robustvlm_tpu_torch.vlm_eval import eval_models

    name = "serve_continuous[int8 kv]" if quantize_kv else "serve_continuous"
    adapter.quantize_kv = quantize_kv
    cfg = adapter.cfg
    tower_layers = cfg.vision.vision.layers - 1  # LLaVA drops the tower's last block
    eng = ContinuousEngine(adapter, **CB_ARGS)
    worker = MW.ModelWorker(adapter, "llava-7b", worker_address="", image_size=cfg.vision.image_size,
                            continuous=eng)
    walls = []
    real_dispatch = eng._dispatch

    def timed_dispatch():
        t = time.perf_counter()
        real_dispatch()
        walls.append(time.perf_counter() - t)

    eng._dispatch = timed_dispatch
    rng = np.random.RandomState(1)
    images = [_png_b64(rng.randint(0, 255, (360, 400, 3), np.uint8)) for _ in CB_NEW_TOKENS]
    payloads = [{"model": "llava-7b", "image_b64": img, "max_new_tokens": n,
                 **({"task": "vqa", "question": q} if q else {"task": "caption"})}
                for img, n, q in zip(images, CB_NEW_TOKENS, CB_QUESTIONS)]
    addr, servers = _serving_stack(worker)
    stream_url = addr + "/worker_generate_stream"
    real_step = eval_models.llava_decode_step
    try:
        warm = _post_json(addr + "/worker_generate", {**payloads[0], "max_new_tokens": 4})
        _wait_idle(eng)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        walls.clear()
        results = [None] * len(payloads)

        def send(i):
            results[i] = _timed_stream(stream_url, payloads[i])

        threads = []
        for i in range(len(payloads)):
            threads.append(threading.Thread(target=send, args=(i,)))
            threads[-1].start()
            time.sleep(CB_STAGGER_S)
        for th in threads:
            th.join()
        admissions = len(payloads)
        shift = []
        if not quantize_kv:  # the shift body at 4 rows
            _wait_idle(eng)
            os.environ["Q4_KERNEL"] = "shift"
            try:
                shift = [None] * 4

                def send_shift(i):
                    shift[i] = _post_json(addr + "/worker_generate", {**payloads[i], "max_new_tokens": 4})

                ths = [threading.Thread(target=send_shift, args=(i,)) for i in range(4)]
                for th in ths:
                    th.start()
                for th in ths:
                    th.join()
                _wait_idle(eng)
            finally:
                del os.environ["Q4_KERNEL"]
            admissions += 4
        torch.cuda.synchronize()
        launches = _launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        step_walls_ms = [w * 1e3 for w in walls]

        # lane isolation: request 0 in lane 0, beside requests 1-3 and then 4-6
        rec = {"on": False, "logits": []}

        def recording_step(*a, **kw):
            logits, cache = real_step(*a, **kw)
            if rec["on"]:
                rec["logits"].append(logits[0, -1].clone())
            return logits, cache

        eval_models.llava_decode_step = recording_step
        lane0 = []
        for neighbours in ((1, 2, 3), (4, 5, 6)):
            _wait_idle(eng)
            rec["logits"], rec["on"] = [], True
            r = eng.submit(worker.decode_image(payloads[0]), worker._prompt(payloads[0]), 32)
            others = [eng.submit(worker.decode_image(payloads[j]), worker._prompt(payloads[j]), 32)
                      for j in neighbours]
            ids = r.wait_ids()
            for o in others:
                o.wait_ids()
            rec["on"] = False
            lane0.append((ids, torch.stack(rec["logits"][:max(len(ids) - 1, 0)] or [torch.zeros(1)])))
        eval_models.llava_decode_step = real_step
        isolation = {"tokens_equal": lane0[0][0] == lane0[1][0] and len(lane0[0][0]) > 1,
                     "logits_bit_equal": torch.equal(lane0[0][1], lane0[1][1]),
                     "steps_compared": int(lane0[0][1].shape[0]) if lane0[0][1].dim() == 2 else 0}

        # a lane cancelled on a stop string frees its slot: every hash token
        # holds "tok", so the stream stops at its first token
        _wait_idle(eng)
        long_done = {}

        def send_long(j):
            _post_json(addr + "/worker_generate", {**payloads[j], "max_new_tokens": 32})
            long_done[j] = time.perf_counter()

        adapter.DEFAULT_STOPS = ("tok",)
        try:
            ths = [threading.Thread(target=send_long, args=(j,)) for j in (1, 2, 3)]
            for th in ths:
                th.start()
            cancelled = _timed_stream(stream_url, {**payloads[0], "max_new_tokens": 32})
        finally:
            del adapter.DEFAULT_STOPS
        nxt_req = eng.submit(worker.decode_image(payloads[4]), worker._prompt(payloads[4]), 4)
        next(iter(nxt_req.token_stream()))
        t_next_first = time.perf_counter()
        nxt_req.wait_ids()
        for th in ths:
            th.join()
        cancel = {"stream_text": cancelled["chunks"][-1]["text"] if cancelled["chunks"] else None,
                  "next_first_token_before_long_end_s": min(long_done.values()) - t_next_first}
        step = _step_graph_ms(eng)
        caches = eng._bcaches
        cache_bytes = sum(t.numel() * t.element_size() for t in caches.values())
        cache_dtypes = {k: str(t.dtype).split(".")[-1] for k, t in caches.items()}
    finally:
        eval_models.llava_decode_step = real_step
        eng.shutdown()
        for srv in servers:
            srv.shutdown()
            srv.server_close()

    # the solo batch-1 streams, outside the counted requests
    compare = []
    for payload, res in zip(payloads, results):
        x = torch.from_numpy(worker.decode_image(payload))[None].to(adapter.device)
        ref, rows = _solo_trace(adapter, x, worker._prompt(payload), payload["max_new_tokens"])
        got = _hash_ids(res["chunks"][-1]["text"]) if res["chunks"] else []
        compare.append({"tokens": len(got), **_near_tie(got, ref, rows, adapter.tok.eos_token_id)})
    adapter.quantize_kv = False
    t0 = min(r["t_submit"] for r in results)
    mid_decode = any(any(results[j]["t_first"] < results[i]["t_first"] < results[j]["t_last"]
                         for j in range(i)) for i in range(1, len(results)))
    total_tokens = sum(c["tokens"] for c in compare)
    wall = max(r["t_last"] for r in results) - t0
    per_step = LAUNCHES_PER_STEP
    checks = {
        "error_code_0": warm.get("error_code") == 0 and all(
            c.get("error_code") == 0 for r in results for c in r["chunks"])
        and all(r is not None and r.get("error_code") == 0 for r in shift),
        "tokens_equal_solo_or_near_tie": all(c["ok"] for c in compare),
        "admitted_while_another_decodes": mid_decode,
        "q4_only_at_4_rows": (launches.get("q4_matmul_group@4", 0) > 0
                              and launches.get("q4_matmul_group@4", 0) % per_step == 0
                              and launches["q4_matmul_group"] == launches["q4_matmul_group@4"]),
        "vit_forward_per_admission": launches["vit_attention_fwd"] == tower_layers * admissions,
        "lane_isolation_bitwise": isolation["tokens_equal"] and isolation["logits_bit_equal"],
        "cancel_frees_the_lane": cancel["stream_text"] == ""
                                 and cancel["next_first_token_before_long_end_s"] > 0,
    }
    if quantize_kv:
        checks["int8_caches"] = cache_dtypes == {"k": "int8", "v": "int8", "ks": "float32", "vs": "float32"}
    else:
        checks["q4_shift_at_4_rows"] = (launches.get("q4_matmul_shift@4", 0) > 0
                                        and launches["q4_matmul_shift@4"] % per_step == 0
                                        and launches["q4_matmul_shift"] == launches["q4_matmul_shift@4"])
    numbers = {"dispatch_wall_ms_mean": float(np.mean(step_walls_ms)) if step_walls_ms else None,
               "dispatch_wall_ms_median": float(np.median(step_walls_ms)) if step_walls_ms else None,
               "dispatches": len(step_walls_ms), **step, "cache_bytes": cache_bytes,
               "cache_dtypes": cache_dtypes}
    line = {"phase": name, "entry": "robustvlm_tpu_torch.serve.model_worker.ModelWorker(continuous=)",
            "engine": {**CB_ARGS, "chunk": 1}, "model": "llava-1.5-7b",
            "weights": "the serve phase's: int4 LM (group 128), bf16", "kv": "int8" if quantize_kv else "bf16",
            "requests": len(payloads), "new_tokens": total_tokens, "wall_s": wall,
            "aggregate_tok_per_s": total_tokens / wall,
            "latency_s": [r["t_last"] - r["t_submit"] for r in results],
            "first_token_s": [r["t_first"] - r["t_submit"] for r in results],
            "peak_gib": peak, **numbers, "vs_solo": compare, "lane_isolation": isolation,
            "cancel": cancel, "near_tie_rel_to_max_logit": NEAR_TIE, "launches": launches,
            "card": card_line(), "checks": checks, "ok": all(checks.values())}
    if bf16_kv is not None:
        line["bf16_kv_same_engine"] = bf16_kv
    emit(line)
    if not all(checks.values()):
        raise AssertionError(f"{name} checks failed: {checks}")
    return launches, numbers


def phase_serve_speculate(adapter) -> dict:
    """`--speculate 7` on the `serve` phase's adapter: /worker_generate_stream
    through the port's controller, a 32-token caption by speculation (and an
    8-token one through the shift body), then the same caption by the plain
    stream. Held: the text's tokens against the solo batch-1 stream
    (NEAR_TIE rule), q4_matmul only at 8 rows and 225 launches a verify
    step, the stats consistent with the tokens streamed. Returns the
    speculative caption's launches."""
    import os

    import numpy as np
    import torch

    from robustvlm_tpu_torch.serve import model_worker as MW
    from robustvlm_tpu_torch.serve import speculative

    adapter.quantize_kv = False
    worker = MW.ModelWorker(adapter, "llava-7b", worker_address="",
                            image_size=adapter.cfg.vision.image_size, speculate=SPEC_K)
    rng = np.random.RandomState(2)
    payload = {"model": "llava-7b", "image_b64": _png_b64(rng.randint(0, 255, (360, 400, 3), np.uint8)),
               "task": "caption", "max_new_tokens": SPEC_NEW_TOKENS}
    record = []
    real = speculative.spec_stream_tokens

    def recorded(*a, **kw):
        entry = {"stats": {}, "ids": []}
        record.append(entry)
        gen = real(*a, **{**kw, "stats": entry["stats"]})
        try:
            for t in gen:
                entry["ids"].append(int(t[0]))
                yield t
        finally:
            gen.close()

    speculative.spec_stream_tokens = recorded
    addr, servers = _serving_stack(worker)
    url = addr + "/worker_generate_stream"
    try:
        warm = _timed_stream(url, {**payload, "max_new_tokens": 4})
        torch.cuda.synchronize()
        _reset_launches()
        spec = _timed_stream(url, payload)
        torch.cuda.synchronize()
        launches = _launches()
        stats = record[-1]["stats"]
        streamed = record[-1]["ids"]
        os.environ["Q4_KERNEL"] = "shift"
        try:
            spec_shift = _timed_stream(url, {**payload, "max_new_tokens": 8})
            torch.cuda.synchronize()
        finally:
            del os.environ["Q4_KERNEL"]
        shift_launches = {k: v - launches.get(k, 0) for k, v in _launches().items()}
        worker.speculate = 0
        plain = _timed_stream(url, payload)
    finally:
        speculative.spec_stream_tokens = real
        for srv in servers:
            srv.shutdown()
            srv.server_close()
    x = torch.from_numpy(worker.decode_image(payload))[None].to(adapter.device)
    ref, rows = _solo_trace(adapter, x, worker._prompt(payload), SPEC_NEW_TOKENS)
    got = _hash_ids(spec["chunks"][-1]["text"]) if spec["chunks"] else []
    plain_ids = _hash_ids(plain["chunks"][-1]["text"]) if plain["chunks"] else []
    compare = _near_tie(got, ref, rows, adapter.tok.eos_token_id)
    steps = stats.get("verify_steps", 0)
    per_step = LAUNCHES_PER_STEP
    every = [warm, spec, spec_shift, plain]
    checks = {
        "error_code_0": all(c.get("error_code") == 0 for r in every for c in r["chunks"]),
        "tokens_equal_solo_or_near_tie": compare["ok"],
        "plain_stream_equals_solo": plain_ids == ref,
        "q4_only_at_8_rows": (steps > 0 and launches.get("q4_matmul_group@8", 0) == per_step * steps
                              and launches["q4_matmul_group"] == launches["q4_matmul_group@8"]),
        "q4_shift_at_8_rows": (shift_launches.get("q4_matmul_shift@8", 0) > 0
                               and shift_launches["q4_matmul_shift@8"] % per_step == 0),
        "stats_consistent": (stats.get("emitted") == len(streamed) and 0 < steps <= stats["emitted"]
                             and 0.0 <= stats["accept_rate"] <= 1.0
                             and streamed[:len(got)] == got),
    }
    spec_s = spec["t_last"] - spec["t_submit"]
    plain_s = plain["t_last"] - plain["t_submit"]
    emit({"phase": "serve_speculate", "entry": "robustvlm_tpu_torch.serve.model_worker.ModelWorker(speculate=)",
          "k": SPEC_K, "model": "llava-1.5-7b", "weights": "the serve phase's: int4 LM (group 128), bf16",
          "new_tokens": len(got), "stats": stats,
          "tokens_per_verify_step": (stats["emitted"] - 1) / steps if steps else None,
          "spec_s": spec_s, "plain_s": plain_s, "spec_tok_per_s": len(got) / spec_s,
          "plain_tok_per_s": len(plain_ids) / plain_s, "speedup": plain_s / spec_s,
          "vs_solo": compare, "shift_body": {"stats": record[2]["stats"],
                                             "launches": shift_launches.get("q4_matmul_shift@8", 0)},
          "launches": launches, "card": card_line(), "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"serve_speculate checks failed: {checks}")
    return {**launches, "q4_matmul_shift@8": shift_launches.get("q4_matmul_shift@8", 0)}


# ------------------------------------------------------------------ phase 26
PARALLEL_TRAIN_STEPS = 2
PARALLEL_APGD_ITERS = 5
PARALLEL_NEW_TOKENS = 8
PARALLEL_ENGINE = {"n_slots": 2, "width": 32, "max_new": PARALLEL_NEW_TOKENS}
# llava_reference's limits: the sharded model against the same model unsharded
PARALLEL_TOL = {"loss_rel": 1e-4, "grad_rel_to_max": 1e-3}


def _parallel_train(argv: list) -> dict:
    """`driver.main(argv)`: its parameters (a device copy), step losses,
    gradient all-reduces, kernel launches and wall seconds."""
    import torch

    from robustvlm_tpu_torch.parallel.mesh import COLLECTIVES
    from robustvlm_tpu_torch.train import driver

    _free()
    COLLECTIVES["grad_all_reduce"] = 0
    _reset_launches()
    t0 = time.perf_counter()
    run = driver.main(argv)
    torch.cuda.synchronize()
    out = {"wall_s": time.perf_counter() - t0, "launches": _launches(),
           "all_reduces": COLLECTIVES["grad_all_reduce"],
           "params": {n: p.detach().clone() for n, p in run.model.named_parameters()},
           "loss": [r["loss"] for r in (json.loads(ln) for ln in
                                        (Path(argv[argv.index("--output_dir") + 1]) / "metrics.jsonl")
                                        .read_text().splitlines()) if "loss" in r],
           "eval": run.eval_metrics}
    del run
    return out


def _parallel_llava(adapter, x, prompt: str) -> dict:
    """On `adapter`'s model as it stands (sharded or not): the per-sample
    loss and pixel gradient at 665 tokens on 2 images, PARALLEL_APGD_ITERS
    APGD iterations (bf16, eps 2/255), and the continuous engine's tokens
    for 2 requests of PARALLEL_NEW_TOKENS; with launches, ms and peaks."""
    import torch

    from robustvlm_tpu_torch.attacks.apgd import apgd_attack
    from robustvlm_tpu_torch.serve.continuous import ContinuousEngine

    out = {}
    _free()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    xa = x.clone().requires_grad_(True)
    t = time.perf_counter()
    loss = adapter(xa)
    (grad,) = torch.autograd.grad(loss.sum(), xa)
    torch.cuda.synchronize()
    out["loss_grad_ms"] = (time.perf_counter() - t) * 1e3
    out["loss"], out["grad"] = loss.detach(), grad
    out["launches_loss_grad"] = _launches()

    _reset_launches()
    t = time.perf_counter()
    res = apgd_attack(adapter, x, None, criterion=lambda o, y: o, eps=LLAVA_EPS / 255.0,
                      n_iter=PARALLEL_APGD_ITERS, norm="linf", rng=0)
    torch.cuda.synchronize()
    out["ms_per_apgd_iter"] = (time.perf_counter() - t) * 1e3 / PARALLEL_APGD_ITERS
    out["launches_apgd"] = _launches()
    out["apgd_loss_best"], out["apgd_x_best"] = res.loss_best.detach(), res.x_best.detach()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

    eng = ContinuousEngine(adapter, **PARALLEL_ENGINE)
    try:
        t = time.perf_counter()
        reqs = [eng.submit(x[i].float().cpu().numpy(), prompt, PARALLEL_NEW_TOKENS) for i in range(x.shape[0])]
        out["engine"] = [r.wait_ids() for r in reqs]
        out["engine_s"] = time.perf_counter() - t
    finally:
        eng.shutdown()
    return out


def phase_parallel() -> dict:
    """The parallel layer (`robustvlm_tpu_torch.parallel`) over a world-size-1
    NCCL process group (a FileStore under chiprun_out/; the card is one
    GPU): real collectives and FSDP2's gathers on the device at full width.
      (a) `driver.main` with train[tecoa2]'s argv, 2 steps, in the group
          (data parallel: the rows split, one gradient all-reduce a step)
          against the same argv with no group: parameters bit-equal, losses
          equal;
      (b) LLaVA-1.5-7B, bf16, random weights (seed 0) unsharded and then
          under `shard_params`: the per-sample loss and pixel gradient at
          665 tokens on 2 images, and 5 APGD iterations through
          `LlavaEvalModel`, held to llava_reference's limits (bitwise
          status reported), ms and peaks of both;
      (c) `ContinuousEngine` on both (2 requests of 8 tokens): the sharded
          engine's tokens against the unsharded engine's under
          serve_continuous's near-tie rule, with solo rows;
      (d) `all_gather_results` and `process_shard_indices` over NCCL.
    The group is destroyed before the next phase."""
    import datetime
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from robustvlm_tpu_torch.models.llava.convert import init_random_state
    from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS, Llava
    from robustvlm_tpu_torch.parallel import (
        all_gather_results,
        make_mesh,
        process_shard_indices,
        shard_params,
    )
    from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel, WordTokenizer

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="parallel-"))
    common = list(TRAIN_COMMON)
    common[common.index("--steps") + 1] = str(PARALLEL_TRAIN_STEPS)
    argv = common + TRAIN_RUNS["tecoa2"] + ["--save_checkpoints", "false"]
    try:
        # (a) without the group first, then in it
        single = _parallel_train(argv + ["--output_dir", str(tmp / "single")])
        store = OUT / "parallel-store"
        store.unlink(missing_ok=True)
        dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1,
                                timeout=datetime.timedelta(minutes=5))
        try:
            mesh = make_mesh()
            grouped = _parallel_train(argv + ["--output_dir", str(tmp / "grouped")])
            train_bit_equal = all(torch.equal(grouped["params"][n], p) for n, p in single["params"].items())
            del single["params"], grouped["params"]

            # (b), (c): one 7B model, unsharded, then sharded in place
            cfg = LLAVA_CONFIGS["llava-1.5-7b"]
            model = Llava.from_state(cfg, init_random_state(cfg, 0, "cuda", torch.bfloat16))
            adapter = LlavaEvalModel(model, WordTokenizer(), compute_dtype=torch.bfloat16)
            size = cfg.vision.image_size
            x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, size, size).astype(np.float32)).cuda()
            caps = [c[0] for c in LLAVA_IMAGES]
            adapter.set_inputs([adapter.get_caption_prompt(c) for c in caps])
            prompt = adapter.get_caption_prompt()
            solo = [_solo_trace(adapter, x[i:i + 1], prompt, PARALLEL_NEW_TOKENS) for i in range(2)]
            plain = _parallel_llava(adapter, x, prompt)
            held_gib = torch.cuda.memory_allocated() / 2**30
            t = time.perf_counter()
            shard_params(model, mesh)
            torch.cuda.synchronize()
            shard_s = time.perf_counter() - t
            sharded_params = sum(type(p).__name__ == "DTensor" for p in model.parameters())
            n_params = sum(1 for _ in model.parameters())
            sharded = _parallel_llava(adapter, x, prompt)
            del adapter, model
            _free()

            # (d) the eval merge over NCCL
            payload = {"rank": dist.get_rank(), "ids": process_shard_indices(5), "text": "x" * 40}
            merged = all_gather_results(payload)
        finally:
            dist.destroy_process_group()
            store.unlink(missing_ok=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    loss_rel = float(((sharded["loss"].double() - plain["loss"].double()).abs()
                      / plain["loss"].double().abs()).max())
    g_max = float(plain["grad"].abs().max())
    g_diff = float((sharded["grad"] - plain["grad"]).abs().max())
    apgd_rel = float(((sharded["apgd_loss_best"].double() - plain["apgd_loss_best"].double()).abs()
                      / plain["apgd_loss_best"].double().abs()).max())
    eos = WordTokenizer().eos_token_id
    engine = [_near_tie(got, ref, rows, eos)
              for got, ref, (_, rows) in zip(sharded["engine"], plain["engine"], solo)]
    engine_vs_solo = [_near_tie(got, ids, rows, eos) for got, (ids, rows) in zip(plain["engine"], solo)]
    kernels_b = ("vit_attention_fwd", "vit_attention_bwd", "flash_attention_fwd", "flash_attention_bwd")
    checks = {
        "train_params_bit_equal": train_bit_equal,
        "train_losses_equal": grouped["loss"] == single["loss"],
        "train_one_all_reduce_a_step": (grouped["all_reduces"] == PARALLEL_TRAIN_STEPS
                                        and single["all_reduces"] == 0),
        "train_launched": (_launched(grouped["launches"], CLIP_KERNELS)
                           and grouped["launches"]["linf_step"] == TRAIN_LINF_LAUNCHES["tecoa2"]),
        "llava_sharded": sharded_params == n_params,
        "llava_loss_rel": loss_rel <= PARALLEL_TOL["loss_rel"],
        "llava_grad": g_diff <= PARALLEL_TOL["grad_rel_to_max"] * g_max and g_max > 0.0,
        "llava_apgd_loss_rel": apgd_rel <= PARALLEL_TOL["loss_rel"],
        "llava_launched": (_launched(sharded["launches_loss_grad"], kernels_b)
                           and _launched(sharded["launches_apgd"], LLAVA_KERNELS)),
        "engine_near_tie": all(e["ok"] for e in engine) and any(plain["engine"]),
        "merge": merged == [{"rank": 0, "ids": [0, 1, 2, 3, 4], "text": "x" * 40}],
    }
    launch_keys = ("linf_step",) + kernels_b

    def pick(launches):
        return {k: launches.get(k, 0) for k in launch_keys}

    emit({"phase": "parallel", "entry": "robustvlm_tpu_torch.parallel (make_mesh, shard_params, sharded_call) "
          "under torch.distributed (NCCL, world size 1)", "mesh": mesh.shape,
          "train": {"argv": argv, "steps": PARALLEL_TRAIN_STEPS, "loss": grouped["loss"],
                    "loss_single": single["loss"], "params_bit_equal": train_bit_equal,
                    "grad_all_reduces": grouped["all_reduces"], "wall_s": grouped["wall_s"],
                    "wall_s_single": single["wall_s"], "launches": pick(grouped["launches"])},
          "llava": {"model": cfg.name, "dtype": "bfloat16", "batch": 2,
                    "seq_len": adapter_seq_len(cfg, LLAVA_POST_LEN), "loss": sharded["loss"].float().tolist(),
                    "loss_rel_err": loss_rel, "grad_max_abs_diff": g_diff, "grad_max_abs": g_max,
                    "loss_bit_equal": bool(torch.equal(sharded["loss"], plain["loss"])),
                    "grad_bit_equal": bool(torch.equal(sharded["grad"], plain["grad"])),
                    "apgd_iters": PARALLEL_APGD_ITERS, "apgd_loss_best_rel_err": apgd_rel,
                    "apgd_x_best_bit_equal": bool(torch.equal(sharded["apgd_x_best"], plain["apgd_x_best"])),
                    "ms_loss_grad": {"sharded": sharded["loss_grad_ms"], "unsharded": plain["loss_grad_ms"]},
                    "ms_per_apgd_iter": {"sharded": sharded["ms_per_apgd_iter"],
                                         "unsharded": plain["ms_per_apgd_iter"]},
                    "peak_gib": {"sharded": sharded["peak_gib"], "unsharded": plain["peak_gib"]},
                    "held_gib_unsharded": held_gib, "shard_params_s": shard_s,
                    "dtensor_params": sharded_params, "params": n_params,
                    "launches_loss_grad": pick(sharded["launches_loss_grad"]),
                    "launches_apgd": pick(sharded["launches_apgd"]),
                    "launches_apgd_unsharded": pick(plain["launches_apgd"]), "tol": PARALLEL_TOL},
          "engine": {**PARALLEL_ENGINE, "sharded": sharded["engine"], "unsharded": plain["engine"],
                     "vs_unsharded": engine, "unsharded_vs_solo": engine_vs_solo,
                     "equal": sharded["engine"] == plain["engine"],
                     "s": {"sharded": sharded["engine_s"], "unsharded": plain["engine_s"]}},
          "merge": merged, "card": card_line(),
          "phase_s": time.perf_counter() - t_phase, "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise AssertionError(f"parallel checks failed: {checks}")
    return {k: grouped["launches"].get(k, 0) + sharded["launches_apgd"].get(k, 0)
            + sharded["launches_loss_grad"].get(k, 0) for k in launch_keys}


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
    runs["robustbench_breadth"] = phase_robustbench_breadth()
    runs["train_reference"] = phase_train_reference()
    runs["train[fare4]"] = phase_train("fare4")
    runs["train[tecoa2]"] = phase_train("tecoa2")
    runs["llava_reference"] = phase_llava_reference()
    runs["llava"] = phase_llava()
    runs["llava_vqa"] = phase_llava_vqa()
    runs["llava_ensemble[float32 stage]"] = phase_llava_ensemble()
    runs["llava_rob"] = phase_llava_rob()
    runs.update(phase_llava_mpt_reference())
    runs["llava_qualitative"] = phase_llava_qualitative()
    runs["llava_aux"] = phase_llava_aux()
    runs["blip2_reference"] = phase_blip2_reference()
    runs["blip2"] = phase_blip2()
    runs["flamingo_reference"] = phase_flamingo_reference()
    runs["flamingo"] = phase_flamingo()
    runs["flamingo_ensemble[float32 stage]"] = phase_flamingo_ensemble()
    runs["benchmark_reference[ViT-g-14]"] = phase_benchmark_reference()
    runs.update(phase_benchmark())
    runs["serve"], adapter = phase_serve()
    # the rest of serving on the serve phase's 7B build
    runs["serve_continuous"], bf16_kv = phase_serve_continuous(adapter)
    runs["serve_continuous[int8 kv]"], _ = phase_serve_continuous(adapter, quantize_kv=True,
                                                                  bf16_kv=bf16_kv)
    runs["serve_speculate"] = phase_serve_speculate(adapter)
    del adapter
    _free()
    runs["parallel"] = phase_parallel()
    # Each row takes the launches of the run of its path and dtype: the CLIP
    # kernels from the CLI's CLIP runs; flash in bf16 from the LLaVA eval,
    # in float32 from the ensemble's float32 stage (at head dim 64 from the
    # float32 CLIP run's text tower; at the robust tower's length from
    # `llava_rob`; with ALiBi from the OpenFlamingo runs or LLaVA-MPT's cut,
    # named in the row); q4_matmul from serving (a batch-1 step from `serve`,
    # 4 rows from `serve_continuous`, 8 from `serve_speculate`); the ViT
    # kernels at head dim 88 from the benchmark phases' ViT-g-14 runs and at
    # the 336 px tower from `serve_continuous` (named in the row).
    for r in rows:
        kernel = r.pop("counter", r["name"].split("[")[0])
        if "launches_from" in r:
            src = r["launches_from"]
        elif kernel.startswith("q4_matmul"):
            src = "serve"
        elif kernel.startswith("flash"):
            src = "llava" if r["dtype"] == "bfloat16" else "llava_ensemble[float32 stage]"
        else:
            src = f"main[{r['dtype']}]"
        r["launches"] = runs[src].get(kernel, 0)
        r["launches_from"] = src
    emit({"kernels": rows})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
