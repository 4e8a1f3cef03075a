#!/usr/bin/env python3
"""Time the attention kernels of this checkout against another checkout's
(an older commit unpacked by `git archive`), on one GPU, in one process.

    python3 scripts/compare_attention_torch.py OTHER_ROOT

Each checkout's `attention.cu` is compiled with that checkout's own headers
(copied beside the source, which quoted includes find first) under
`build/compare/<side>/`. Every row below is held
against this checkout's plain version (the limits of `chip_smoke.py`; a
backward against the plain backward of the same O and lse) and timed by
CUDA-graph replay in turns: other, this, this, other; beside it, the host
us of a launch from Python (the median of 5 bursts of 200 launches, short
enough that the launch queue never fills). Rows: the ViT
attention forward and backward at ViT-L/14 (B*H = 128, N = 257, D = 64),
in float32 and bf16; the flash forward (bf16) and backward (float32 and
bf16) at the LLaVA-1.5-7B LM layer (32, 665, 128, causal). One JSON line
per side and row, then the card's name and power limit. Exits 1 if either
side disagrees. Needs a GPU. Both checkouts must share the one source and
its C interface, `attn_fwd`/`attn_bwd` with the table set: checkouts from
the merge of the ViT and flash launch paths on (older ones build two
sources, `vit_attention.cu` and `flash_attention.cu`).
"""

from __future__ import annotations

import json
import shutil
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

def build(side: str, root: Path):
    """The bound library built from `root`'s csrc/attention.cu."""
    from robustvlm_tpu_torch.ops.kernels import _build, flash_attention

    csrc = root / "robustvlm_tpu_torch" / "csrc"
    out = ROOT / "build" / "compare" / side
    out.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    (lib, _), = _build.build_variants({0: (csrc / "attention.cu").read_text()}, out, "k").values()
    return flash_attention.bind(lib)


def libraries(other: Path) -> dict:
    """{"other": ..., "this": ...}: each side's library, as `build` makes it."""
    return {"other": build("other", other), "this": build("this", ROOT)}


def bind(libs: dict, side: str) -> None:
    """Point both attention entry points at `side`'s library (the shared
    CUDA front's `_lib` rebound: the package has no switch)."""
    from robustvlm_tpu_torch.ops.kernels import flash_attention

    flash_attention._lib = lambda lib=libs[side]: lib


def in_turns(libs: dict, pairs: int, measure) -> dict:
    """measure(side, label) -> a number, with either side's library bound:
    once a side as a warm-up, then in pairs (other-this, this-other, ...).
    The numbers per side, their means and the per-pair difference other -
    this with its standard deviation."""
    for side in ("other", "this"):
        bind(libs, side)
        measure(side, "warm-up")
    values = {"other": [], "this": []}
    diffs = []
    for i in range(pairs):
        pair = {}
        for side in ("other", "this") if i % 2 == 0 else ("this", "other"):
            bind(libs, side)
            pair[side] = measure(side, f"pair {i}")
            values[side].append(pair[side])
        diffs.append(pair["other"] - pair["this"])
    return {"values": values, "mean": {side: statistics.mean(v) for side, v in values.items()},
            "other_minus_this": {"per_pair": diffs, "mean": statistics.mean(diffs),
                                 "stdev": statistics.stdev(diffs) if len(diffs) > 1 else None}}


def main() -> int:
    import torch

    import chip_smoke as C
    from robustvlm_tpu_torch.device import use_full_fp32
    from robustvlm_tpu_torch.ops.kernels import _heads as H
    from robustvlm_tpu_torch.ops.kernels import flash_attention as F
    from robustvlm_tpu_torch.ops.kernels import vit_attention as A

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    use_full_fp32()
    libs = {"other": build("other", Path(sys.argv[1]).resolve()), "this": build("this", ROOT)}

    def stream():  # read at each launch: a graph capture runs on a stream of its own
        return torch.cuda.current_stream().cuda_stream

    def ptrs(*ts):
        return [t.data_ptr() for t in ts]

    # inputs, residuals from this checkout's plain forward, and references
    vit, flash = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = C._qkv(257, dtype, seed=1)
        o, lse = A.attention_fwd_plain(q, k, v)
        vit[dtype] = (q, k, v, do, o, lse, (o, lse), A.attention_bwd_plain(q, k, v, o, lse, do))
        (fq, fk, fv, fdo), _ = C._flash_inputs(*C._flash_llava_shape(), dtype, seed=1)
        fo, flse = F.flash_fwd_plain(fq, fk, fv, causal=True)
        flash[dtype] = (fq, fk, fv, fdo, fo, flse, (fo, flse),
                        F.flash_bwd_plain(fq, fk, fv, fo, flse, fdo, causal=True))

    def rows_of(lib, entry, data, causal, fwd_dtypes):
        """{row name: (launch, outputs, reference, dtype name)} of one entry
        point: its forward in fwd_dtypes, its backward in both."""
        rows = {}
        for dtype, (q, k, v, do, o, lse, fwd_ref, bwd_ref) in data.items():
            dname = str(dtype).split(".")[-1]
            dims = F._dims(q, k, causal, entry.tables)
            st = H.strides((q, k, v, q, q, q, k, v))  # contiguous: o, dO, dQ as q; dK, dV as k
            if dtype in fwd_dtypes:
                out = (torch.empty_like(q), torch.empty(q.shape[:2], device="cuda"))
                rows[f"{entry.name}_fwd[{dname}]"] = (
                    lambda q=q, k=k, v=v, out=out, dims=dims, st=st:
                    lib.attn_fwd(*ptrs(q, k, v, *out), None, *dims, st, stream()),
                    out, fwd_ref, dname)
            grads = tuple(torch.empty_like(t) for t in (q, k, v))
            delta = torch.empty(q.shape[:2], device="cuda")
            rows[f"{entry.name}_bwd[{dname}]"] = (
                lambda q=q, k=k, v=v, o=o, lse=lse, do=do, grads=grads, delta=delta, dims=dims,
                st=st:
                lib.attn_bwd(*ptrs(q, k, v, o, lse, do), None, *ptrs(*grads, delta), *dims,
                             st, stream()),
                grads, bwd_ref, dname)
        return rows

    runs = {side: {**rows_of(lib, A.VIT, vit, False, (torch.float32, torch.bfloat16)),
                   **rows_of(lib, F.FLASH, flash, True, (torch.bfloat16,))}
            for side, lib in libs.items()}
    rows, ok = {}, True
    for side, kernels in runs.items():
        for name, (fn, out, ref, dname) in kernels.items():
            if fn():
                raise RuntimeError(f"{side} {name}: launch failed")
            torch.cuda.synchronize()
            names = C.ATTN_OUTPUTS[:2] if len(out) == 2 else C.ATTN_OUTPUTS[2:]
            res = C._attn_check(dname, out, ref, False, names)
            within = all(w for _, w in res.values())
            ok &= within
            rows[(side, name)] = {"side": side, "kernel": name, "within": within, "ms": [],
                                  "max_abs_err": {o: e for o, (e, _) in res.items()}}
    def host_us(fn) -> float:
        bursts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            bursts.append((time.perf_counter() - t0) * 1e6 / 200)
        torch.cuda.synchronize()
        return statistics.median(bursts)

    for side in ("other", "this", "this", "other"):
        for name, (fn, _, _, _) in runs[side].items():
            rows[(side, name)]["ms"].append(C.time_graph_ms(fn))
            rows[(side, name)].setdefault("host_us_per_launch", []).append(host_us(fn))
    for row in rows.values():
        print(json.dumps(row), flush=True)
    print(C.card_line())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
