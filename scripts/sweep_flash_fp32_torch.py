#!/usr/bin/env python3
"""Sweep the float32 flash kernels' block shapes at both head dims on one GPU.

    python3 scripts/sweep_flash_fp32_torch.py [--source-only | --ablate]

The float32 kernels of `robustvlm_tpu_torch/csrc/flash_attention.cu`
(`flash_fwd_tile_kernel`, `flash_bwd_dq_tile_kernel`,
`flash_bwd_dkv_tile_kernel`) take their block shape from six lines,
`F32Tile<head dim, kFwd | kDq | kDkv>`: kRows rows of the block's own side,
kTile rows of the streamed side per shared-memory tile, kThreads threads,
kBufs cp.async buffers. This builds one edited copy of the source per entry
of VARIANTS (an entry names only the lines it changes), all nvcc processes
at once, under `build/sweep/`. The source as it stands is held against the
plain PyTorch version at every float32 case of `chip_smoke.py`; every
variant at the two timed shapes. One JSON line per variant: forward and
backward ms at the LLaVA-1.5-7B LM layer (B*H = 32, N = 665, D = 128,
causal; CUDA events) and at the CLIP text tower (96, 77, 64, causal;
CUDA-graph replay, since the host paces launches this short), each variant
timed twice in turns; the dQ and dK/dV kernels' own device us from
torch.profiler; max abs errors; registers, spills (ptxas) and dynamic shared
memory per kernel. Then the library call's (SDPA's) kernels by name with
their device us, and the card's name and power limit. Needs a GPU.

`--ablate` asks where the forward's time goes instead: it builds copies of
the source with one part of `flash_fwd_tile_kernel` (`csrc/attn_f32_tile.cuh`,
shared with the ViT forward, edited here for this source only) taken out (ABLATIONS;
their outputs are wrong, only their times are read) and prints the forward
ms of each at the LLaVA shape, then the unedited forward's ms and TFLOP/s at
longer sequences, causal and not.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KINDS = {"kFwd": "fwd", "kDq": "bwd_dq", "kDkv": "bwd_dkv"}
SHAPE_LINE = (r"struct F32Tile<(64|128), (kFwd|kDq|kDkv)> \{ static constexpr int kRows = (\d+), "
              r"kTile = (\d+), kThreads = (\d+), kBufs = (\d+); \};")
# {(head dim, kind): (kRows, kTile, kThreads, kBufs)}; {} is the source as it stands
VARIANTS = [
    {},
    {(128, "kFwd"): (64, 32, 128, 2), (128, "kDq"): (64, 32, 256, 2), (128, "kDkv"): (64, 32, 256, 2)},
    {(128, "kFwd"): (64, 56, 128, 1), (128, "kDq"): (64, 64, 128, 2), (128, "kDkv"): (64, 32, 128, 2)},
    {(128, "kFwd"): (64, 64, 256, 2), (128, "kDq"): (128, 32, 256, 2), (128, "kDkv"): (64, 16, 256, 2)},
    {(128, "kFwd"): (64, 64, 128, 2), (128, "kDq"): (64, 64, 256, 1), (128, "kDkv"): (64, 64, 256, 1)},
    {(128, "kFwd"): (64, 32, 128, 1), (128, "kDq"): (32, 32, 64, 2), (128, "kDkv"): (32, 64, 128, 1)},
    {(128, "kFwd"): (128, 32, 256, 2), (128, "kDq"): (64, 32, 128, 2), (128, "kDkv"): (32, 16, 128, 2)},
    {(64, "kFwd"): (64, 32, 128, 2), (64, "kDq"): (64, 64, 128, 2), (64, "kDkv"): (64, 64, 128, 2)},
    {(64, "kFwd"): (64, 64, 128, 2), (64, "kDq"): (64, 32, 128, 2), (64, "kDkv"): (64, 32, 128, 2)},
    {(64, "kFwd"): (32, 64, 64, 1), (64, "kDq"): (64, 32, 256, 2), (64, "kDkv"): (32, 32, 64, 2)},
]
# {what is taken out of the forward kernel: [(text, replacement)]}
_PV = ("tile_ab<R, NC, G, BN, LDP, LD>(acc, ps + gy * LDP, vs + 4 * lx);",
       "acc[0][0] += ps[gy * LDP + lx] + vs[4 * lx];")
_S = ("tile_abt<R, SN, G, DP, LD, LD>(s, qs + gy * LD, ks + lx * LD);",
      "s[0][0] = qs[gy * LD] + ks[lx * LD];")
ABLATIONS = {
    "nothing": [],
    "O += P V": [_PV],
    "S = Q K^T": [_S],
    "both products": [_S, _PV],
    "expf (a subtraction instead)": [("expf(s[i][j] - m_new)", "(s[i][j] - m_new)"),
                                     ("expf(m[i] - m_new)", "(m[i] - m_new + 1.f)")],
    "the K and V copies": [("stage_tile_async<D, BN, T, DP>(bufs +",
                            "if (nq < 0) stage_tile_async<D, BN, T, DP>(bufs +")],
    "the block barriers": [("__syncthreads();", "")],
}
ABLATE_LENGTHS = (640, 1280, 2560)
LLAVA = "llava_lm (32, 665, 128)"
CLIP = "clip_text (96, 77, 64)"


def smem_bytes(d: int, kind: str, rows: int, tile: int, bufs: int) -> int:
    """Dynamic shared memory of a kernel, as `F32<D, Kind>::kSmem` computes it."""
    ld, ldp = d + 4, tile + 8
    stage = 2 * tile * ld + (2 * tile if kind == "kDkv" else 0)
    return 4 * ((1 if kind == "kFwd" else 2) * rows * ld + bufs * stage
                + (2 if kind == "kDkv" else 1) * rows * ldp)


def build(variants):
    from robustvlm_tpu_torch.ops.kernels import _build, flash_attention

    src = (_build.CSRC / "flash_attention.cu").read_text()
    in_source = {(int(m[0]), m[1]): tuple(map(int, m[2:])) for m in re.findall(SHAPE_LINE, src)}
    if len(in_source) != 6:
        raise RuntimeError("the six F32Tile<...> lines were not found in flash_attention.cu")

    def edited(change):
        def line(m):
            rows, tile, threads, bufs = change.get((int(m.group(1)), m.group(2)), m.groups()[2:])
            return (f"struct F32Tile<{m.group(1)}, {m.group(2)}> {{ static constexpr int kRows = {rows}, "
                    f"kTile = {tile}, kThreads = {threads}, kBufs = {bufs}; }};")
        return re.sub(SHAPE_LINE, line, src)

    sources = {i: edited(change) for i, change in enumerate(variants)}
    libs = {}
    for i, (lib, log) in _build.build_variants(sources, ROOT / "build" / "sweep", "fa").items():
        shapes = {**in_source, **variants[i]}
        lines = log.splitlines()
        report = {}
        for n, ln in enumerate(lines):
            m = re.search(r"flash_(fwd|bwd_dq|bwd_dkv)_tile_kernelILi(64|128)E", ln)
            if m and "Compiling entry" in ln:
                text = " ".join(lines[n + 1:n + 4])
                kind = next(k for k, v in KINDS.items() if v == m.group(1))
                rows, tile, threads, bufs = shapes[(int(m.group(2)), kind)]
                regs = re.search(r"Used (\d+) registers", text)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
                report[f"{m.group(1)}<{m.group(2)}>"] = {
                    "shape": [rows, tile, threads, bufs],
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_bytes": [int(spill.group(1)), int(spill.group(2))] if spill else None,
                    "smem_bytes": smem_bytes(int(m.group(2)), kind, rows, tile, bufs)}
        libs[i] = (flash_attention.bind(lib), report)
    return libs


def kernel_us(fn, names, calls: int = 5) -> dict:
    """Device us per call of the kernels whose name holds one of `names`
    (every CUDA kernel when `names` is None), from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        for name in ([e.key] if names is None else [n for n in names if n in e.key]):
            out[name[:160]] = out.get(name[:160], 0.0) + e.self_device_time_total / calls
    return out


def check_source(lib) -> dict:
    """The source's own shapes against the plain version at every float32
    case of chip_smoke.py; returns the largest errors."""
    import torch

    import chip_smoke as C

    worst, failed = {}, []
    for label, bh, nq, nk, d, causal, alibi, extreme in C._flash_cases():
        (q, k, v, do), slopes = C._flash_inputs(bh, nq, nk, d, torch.float32, nq + nk, extreme, alibi)
        kw = dict(causal=causal, slopes=slopes)
        ref = C._flash_plain_all(q, k, v, do, kw)
        got = run(lib, q, k, v, do, causal, slopes)
        again = run(lib, q, k, v, do, causal, slopes)
        res = C._attn_check("float32", got, ref, extreme)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(json.dumps({"case": label, "shape": [bh, nq, nk, d], "causal": causal, "alibi": alibi,
                          "max_abs_err": {n: e for n, (e, _) in res.items()},
                          "within": all(ok for _, ok in res.values()), "bitwise_repeatable": same}),
              flush=True)
        if not (same and all(ok for _, ok in res.values())):
            failed.append(label)
        for n, (e, _) in res.items():
            worst[n] = max(worst.get(n, 0.0), e)
    if failed:
        raise AssertionError(f"flash float32 disagrees or is not repeatable at {failed}")
    return worst


def calls(lib, q, k, v, do, causal, slopes=None):
    """(fwd, bwd, outputs): closures over one variant's library that launch
    on these tensors, the backward on the forward's own O and lse."""
    import torch

    from robustvlm_tpu_torch.ops.kernels import _heads
    from robustvlm_tpu_torch.ops.kernels import flash_attention as F

    o, dq = torch.empty_like(q), torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lse, delta = (torch.empty(q.shape[:2], device="cuda") for _ in range(2))
    dims = F._dims(q, k, causal)
    st = _heads.strides((q, k, v, o, do, dq, dk, dv))
    sl = None if slopes is None else slopes.data_ptr()

    def fwd():
        err = lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                 lse.data_ptr(), sl, *dims, st, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"forward launch failed: cudaError {err}")

    def bwd():
        err = lib.flash_attn_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                 lse.data_ptr(), do.data_ptr(), sl, dq.data_ptr(), dk.data_ptr(),
                                 dv.data_ptr(), delta.data_ptr(), *dims, st,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"backward launch failed: cudaError {err}")

    return fwd, bwd, (o, lse, dq, dk, dv)


def run(lib, q, k, v, do, causal, slopes=None):
    import torch

    fwd, bwd, out = calls(lib, q, k, v, do, causal, slopes)
    fwd()
    bwd()
    torch.cuda.synchronize()
    return tuple(t.clone() for t in out)


def library_kernels() -> dict:
    """SDPA's CUDA kernels by name, device us per forward + backward call."""
    import torch
    import torch.nn.functional as Fn

    out = {}
    for label, (bh, n, d) in ((LLAVA, (32, 665, 128)), (CLIP, (96, 77, 64))):
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(1, bh, n, d, generator=g, device="cuda").mul_(0.5).requires_grad_(True)
                   for _ in range(3))
        do = torch.randn(1, bh, n, d, generator=g, device="cuda")

        def both():
            torch.autograd.grad(Fn.scaled_dot_product_attention(q, k, v, is_causal=True), (q, k, v), do)

        out[label] = kernel_us(both, None)
    return out


def ablate() -> None:
    """Forward ms at the LLaVA shape with one part of the kernel taken out,
    each copy timed twice in turns; then the unedited forward at longer
    sequences."""
    import torch

    import chip_smoke as C
    from robustvlm_tpu_torch.ops.kernels import _build, flash_attention

    # the forward lives in attn_f32_tile.cuh: put the header's text in place
    # of its include, so that an edit of the forward reaches this source only
    header = (_build.CSRC / "attn_f32_tile.cuh").read_text().replace("#pragma once\n", "")
    src = (_build.CSRC / "flash_attention.cu").read_text().replace('#include "attn_f32_tile.cuh"\n', header)
    a, b = src.index("flash_fwd_tile_kernel(const float*"), src.index("flash_bwd_dq_tile_kernel(const float*")
    sources = {}
    for name, edits in ABLATIONS.items():
        fwd = src[a:b]
        for text, replacement in edits:
            if text not in fwd:
                raise RuntimeError(f"ablation {name!r}: {text!r} is not in the forward kernel")
            fwd = fwd.replace(text, replacement)
        sources[name] = src[:a] + fwd + src[b:]
    libs = {name: flash_attention.bind(lib) for name, (lib, _) in
            _build.build_variants(sources, ROOT / "build" / "sweep", "ab").items()}
    bh, n, _, d = C._flash_llava_shape()
    (q, k, v, do), _ = C._flash_inputs(bh, n, n, d, torch.float32, seed=1)
    times = {name: [] for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            times[name].append(C.time_ms(calls(lib, q, k, v, do, True)[0]))
    for name, ms in times.items():
        print(json.dumps({"forward_without": name, "shape": [bh, n, d], "fwd_ms": ms}), flush=True)
    for n in ABLATE_LENGTHS:
        (q, k, v, do), _ = C._flash_inputs(bh, n, n, d, torch.float32, seed=1)
        for causal in (True, False):
            ms = C.time_ms(calls(libs["nothing"], q, k, v, do, causal)[0])
            pairs = bh * n * (n + 1) / 2 if causal else bh * n * n
            print(json.dumps({"shape": [bh, n, d], "causal": causal, "fwd_ms": ms,
                              "tflops": 4 * pairs * d / ms / 1e9}), flush=True)
    print(C.card_line())


def main() -> int:
    import torch

    import chip_smoke as C
    from robustvlm_tpu_torch.device import use_full_fp32

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source-only", action="store_true",
                    help="build, check and time the source's own shapes only")
    ap.add_argument("--ablate", action="store_true",
                    help="time the forward with parts taken out, and at longer sequences")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    use_full_fp32()
    if args.ablate:
        ablate()
        return 0
    variants = VARIANTS[:1] if args.source_only else VARIANTS
    libs = build(variants)
    for i, (_, report) in libs.items():
        print(json.dumps({"variant": i, "change": {f"{d},{k}": s for (d, k), s in variants[i].items()},
                          "ptxas": report}), flush=True)
    worst = check_source(libs[0][0])
    print(json.dumps({"source_max_abs_err": worst}), flush=True)

    bh, n, _, d = C._flash_llava_shape()
    shapes = {LLAVA: (bh, n, d), CLIP: C.CLIP_TEXT_SHAPE}
    data = {}
    for label, (bh, n, d) in shapes.items():
        (q, k, v, do), _ = C._flash_inputs(bh, n, n, d, torch.float32, seed=1)
        data[label] = (q, k, v, do, C._flash_plain_all(q, k, v, do, dict(causal=True, slopes=None)))
    results = {i: {label: {"fwd_ms": [], "bwd_ms": []} for label in shapes} for i in libs}
    for _ in range(2):  # every variant twice, in turns
        for i, (lib, _) in libs.items():
            for label, (q, k, v, do, ref) in data.items():
                fwd, bwd, out = calls(lib, q, k, v, do, True)
                fwd()
                bwd()
                torch.cuda.synchronize()
                r = results[i][label]
                r["max_abs_err"] = max(float((a - b).abs().max()) for a, b in zip(out, ref))
                timer = C.time_ms if label == LLAVA else C.time_graph_ms
                r["fwd_ms"].append(timer(fwd))
                r["bwd_ms"].append(timer(bwd))
                r["bwd_kernel_us"] = kernel_us(bwd, ("bwd_dq_tile", "bwd_dkv_tile"))
    for i, r in results.items():
        print(json.dumps({"variant": i, **r}), flush=True)
    print(json.dumps({"library_kernels_us": library_kernels()}), flush=True)
    print(C.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
