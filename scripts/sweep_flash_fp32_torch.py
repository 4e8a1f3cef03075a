#!/usr/bin/env python3
"""Sweep the float32 attention kernels' block shapes on one GPU, for the
flash attention or (with --vit) the ViT attention.

    python3 scripts/sweep_flash_fp32_torch.py [--source-only | --ablate | --vit [--head_dim 88]]

The float32 kernels of `robustvlm_tpu_torch/csrc/attention.cu`
(`flash_fwd_tile_kernel`, `flash_bwd_dq_tile_kernel`,
`flash_bwd_dkv_tile_kernel`, in `csrc/attn_f32_tile.cuh`) take their block
shape from one line per head dim and kernel of their table set:
`F32Tile<64|128, kFwd | kDq | kDkv>` for the flash launches,
`VitF32Tile<64|80|88, ...>` for the ViT's (--vit). A line holds kRows rows
of the block's own side, kTile rows of the streamed side per shared-memory
tile, kThreads threads, kBufs cp.async buffers. This builds one edited copy
of the source per entry of the target's variants (a flash entry names only
the lines it changes; a ViT entry the kernels whose lines it changes, at
every head dim), all nvcc processes at once, under `build/sweep/`. One JSON
line per variant: registers, spills (ptxas) and dynamic shared memory per
kernel and head dim, max errors, ms. Then the library call's (SDPA's)
kernels or times and the card's name and power limit. Needs a GPU.

Flash: the source as it stands is held against the plain PyTorch version at
every float32 case of `chip_smoke.py`; every variant at the two timed
shapes. Forward and backward ms at the LLaVA-1.5-7B LM layer (B*H = 32,
N = 665, D = 128, causal; CUDA events) and at the CLIP text tower (96, 77,
64, causal; CUDA-graph replay, since the host paces launches this short),
each variant timed twice in turns; the dQ and dK/dV kernels' own device us
from torch.profiler; then SDPA's kernels by name with their device us.

ViT (--vit): every variant is held against the plain PyTorch versions (O,
dQ, dK, dV within 1e-5, lse 1e-5 abs + 1e-6 rel) at N = 50, 129, 257, 577
for head dim 64 and N = 129, 257 for 80 and 88, and its forward and
backward (dQ then dK/dV, one launch) are timed by CUDA-graph replay at the
ViT-L/14 main path's shape (B*H = 128, N = 257, D = 64; `--head_dim 88`:
ViT-g/14's, D = 88), every variant twice in turns. At N = 257 the ragged
tail decides much: 32- or 48-row tiles cover 288 rows, 64-row tiles 320.
Then SDPA's forward and backward at the same shape (by graph replay, as
`chip_smoke.py` times them). Exits 1 if the source as it stands (variant
0) misses a limit.

`--ablate` asks where the flash forward's time goes instead: it builds
copies of the source with one part of `flash_fwd_tile_kernel` (its text in
`csrc/attn_f32_tile.cuh` put in place of the include, then edited) taken
out (ABLATIONS; their outputs are wrong, only their times are read) and
prints the forward ms of each at the LLaVA shape, then the unedited
forward's ms and TFLOP/s at longer sequences, causal and not.
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
VIT_DIMS = (64, 80, 88)
# {(head dim, kind): (kRows, kTile, kThreads, kBufs)}; {} is the source as it stands
TARGETS = {
    "flash": {
        "struct": "F32Tile", "dims": (64, 128), "tables": 0,
        "variants": [
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
        ],
    },
    "vit": {
        "struct": "VitF32Tile", "dims": VIT_DIMS, "tables": 1,
        # each change at every head dim
        "variants": [{(d, kind): shape for kind, shape in change.items() for d in VIT_DIMS} for change in [
            {},
            {"kDq": (32, 32, 64, 2)}, {"kDq": (48, 48, 128, 2)}, {"kDq": (48, 24, 128, 2)},
            {"kDq": (48, 40, 128, 2)}, {"kDq": (48, 32, 128, 1)},
            {"kDkv": (64, 32, 256, 2)}, {"kDkv": (48, 48, 128, 2)}, {"kDkv": (32, 32, 128, 2)},
            {"kDkv": (48, 24, 128, 2)}, {"kDkv": (48, 40, 128, 2)}, {"kDkv": (48, 32, 128, 1)},
        ]],
    },
}
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
VIT_BH, VIT_N = 128, 257
VIT_CASES = [(50, 64), (129, 64), (257, 64), (577, 64), (129, 80), (257, 80), (129, 88), (257, 88)]


def shape_line(target: dict) -> str:
    dims = "|".join(map(str, target["dims"]))
    return (rf"struct {target['struct']}<({dims}), (kFwd|kDq|kDkv)> \{{ static constexpr int kRows = "
            r"(\d+), kTile = (\d+), kThreads = (\d+), kBufs = (\d+); \};")


def smem_bytes(d: int, kind: str, rows: int, tile: int, bufs: int) -> int:
    """Dynamic shared memory of a kernel, as `F32<D, S, Kind>::kSmem` computes it."""
    ld = (d + 31) // 32 * 32 + 4
    stage = 2 * tile * ld + (2 * tile if kind == "kDkv" else 0)
    return 4 * ((1 if kind == "kFwd" else 2) * rows * ld + bufs * stage
                + (2 if kind == "kDkv" else 1) * rows * (tile + 8))


def build(target: dict, variants):
    from robustvlm_tpu_torch.ops.kernels import _build, flash_attention

    struct = target["struct"]
    src = (_build.CSRC / "attention.cu").read_text()
    pat = shape_line(target)
    in_source = {(int(m[0]), m[1]): tuple(map(int, m[2:])) for m in re.findall(pat, src)}
    if len(in_source) != 3 * len(target["dims"]):
        raise RuntimeError(f"the {struct}<...> lines were not found in attention.cu")

    def edited(change):
        def line(m):
            rows, tile, threads, bufs = change.get((int(m.group(1)), m.group(2)), m.groups()[2:])
            return (f"struct {struct}<{m.group(1)}, {m.group(2)}> {{ static constexpr int kRows = {rows}, "
                    f"kTile = {tile}, kThreads = {threads}, kBufs = {bufs}; }};")
        return re.sub(pat, line, src)

    sources = {i: edited(change) for i, change in enumerate(variants)}
    libs = {}
    # this table set's kernels at its swept head dims, not the other set's
    kernel = rf"flash_(fwd|bwd_dq|bwd_dkv)_tile_kernelILi({'|'.join(map(str, target['dims']))})E"
    mangled = f"{len(struct)}{struct}ILi"
    for i, (lib, log) in _build.build_variants(sources, ROOT / "build" / "sweep", "fa").items():
        shapes = {**in_source, **variants[i]}
        lines = log.splitlines()
        report = {}
        for n, ln in enumerate(lines):
            m = re.search(kernel, ln)
            if m and "Compiling entry" in ln and mangled in ln:
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


def calls(lib, q, k, v, do, causal, slopes=None, tables=0):
    """(fwd, bwd, outputs): closures over one variant's library that launch
    on these tensors with a table set's shapes, the backward on the
    forward's own O and lse."""
    import torch

    from robustvlm_tpu_torch.ops.kernels import _heads
    from robustvlm_tpu_torch.ops.kernels import flash_attention as F

    o, dq = torch.empty_like(q), torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lse, delta = (torch.empty(q.shape[:2], device="cuda") for _ in range(2))
    dims = F._dims(q, k, causal, tables)
    st = _heads.strides((q, k, v, o, do, dq, dk, dv))
    sl = None if slopes is None else slopes.data_ptr()

    def stream():  # read at each launch: a graph capture runs on a stream of its own
        return torch.cuda.current_stream().cuda_stream

    def fwd():
        err = lib.attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                           sl, *dims, st, stream())
        if err:
            raise RuntimeError(f"forward launch failed: cudaError {err}")

    def bwd():
        err = lib.attn_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                           do.data_ptr(), sl, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                           delta.data_ptr(), *dims, st, stream())
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
    # of its include, so that an edit of the forward reaches this copy only
    header = (_build.CSRC / "attn_f32_tile.cuh").read_text().replace("#pragma once\n", "")
    src = (_build.CSRC / "attention.cu").read_text().replace('#include "attn_f32_tile.cuh"\n', header)
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


def sweep_vit(d_timed: int) -> int:
    """The ViT target: every variant checked at VIT_CASES and timed at
    (VIT_BH, VIT_N, d_timed); 1 if the source as it stands misses a limit."""
    import torch
    import torch.nn.functional as Fn

    import chip_smoke as C
    from robustvlm_tpu_torch.ops.kernels import vit_attention as A

    target = TARGETS["vit"]
    libs = build(target, target["variants"])
    data = {}
    for n, d in VIT_CASES:
        q, k, v, do = C._qkv(n, torch.float32, seed=n + d, d=d)
        o, lse = A.attention_fwd_plain(q, k, v)
        data[(n, d)] = (q, k, v, do, (o, lse, *A.attention_bwd_plain(q, k, v, o, lse, do)))
    results = {}
    for i, (lib, report) in libs.items():
        errs, within = {}, True
        for (n, d), (q, k, v, do, ref) in data.items():
            fwd, bwd, out = calls(lib, q, k, v, do, False, tables=target["tables"])
            fwd()
            bwd()
            torch.cuda.synchronize()
            res = C._attn_check("float32", out, ref, False)
            errs[f"{n},{d}"] = {name: e for name, (e, _) in res.items()}
            within &= all(ok for _, ok in res.values())
        results[i] = {"ptxas": report, "max_abs_err": errs, "within": within, "fwd_ms": [], "bwd_ms": []}
    q, k, v, do, _ = data[(VIT_N, d_timed)]
    for _ in range(2):  # every variant twice, in turns
        for i, (lib, _) in libs.items():
            fwd, bwd, _ = calls(lib, q, k, v, do, False, tables=target["tables"])
            fwd()
            results[i]["fwd_ms"].append(C.time_graph_ms(fwd))
            results[i]["bwd_ms"].append(C.time_graph_ms(bwd))
    for i, r in results.items():
        change = {f"{d},{k}": s for (d, k), s in target["variants"][i].items()}
        print(json.dumps({"variant": i, "change": change or "source", **r}), flush=True)
    q4, k4, v4, do4 = (t.view(8, VIT_BH // 8, VIT_N, d_timed) for t in (q, k, v, do))
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
    print(json.dumps({"library": "scaled_dot_product_attention", "shape": [VIT_BH, VIT_N, d_timed],
                      "fwd_ms": C.time_graph_ms(lambda: Fn.scaled_dot_product_attention(q4, k4, v4)),
                      "bwd": C.time_graph_fwd_bwd_ms(Fn.scaled_dot_product_attention, (ql, kl, vl), do4)}))
    print(C.card_line())
    return 0 if results[0]["within"] else 1


def main() -> int:
    import torch

    import chip_smoke as C
    from robustvlm_tpu_torch.device import use_full_fp32

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--source-only", action="store_true",
                      help="build, check and time the flash source's own shapes only")
    mode.add_argument("--ablate", action="store_true",
                      help="time the flash forward with parts taken out, and at longer sequences")
    mode.add_argument("--vit", action="store_true", help="sweep the ViT's VitF32Tile lines")
    ap.add_argument("--head_dim", type=int, choices=VIT_DIMS,
                    help="with --vit: the head dim of the timed shape (B*H = 128, N = 257; default 64)")
    args = ap.parse_args()
    if args.head_dim is not None and not args.vit:
        ap.error("--head_dim goes with --vit")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    use_full_fp32()
    if args.vit:
        return sweep_vit(args.head_dim or VIT_DIMS[0])
    if args.ablate:
        ablate()
        return 0
    target = TARGETS["flash"]
    variants = target["variants"][:1] if args.source_only else target["variants"]
    libs = build(target, variants)
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
