#!/usr/bin/env python3
"""Time the q4_matmul kernel of this checkout against another checkout's (an
older commit unpacked by `git archive`), on one GPU, in one process.

    python3 scripts/compare_q4_matmul_torch.py OTHER_ROOT

Each checkout's `q4_matmul.cu` is compiled with that checkout's own headers
(copied beside the source, which quoted includes find first) under
`build/compare/<side>/`. Both are held against this checkout's plain version
at every LLaVA-1.5-7B decode shape at batches 1 and 4, both bodies (the
limits of `chip_smoke.py`; two calls bitwise equal), then timed by
CUDA-graph replay in turns: other, this, this, other, each launch reading
its weight from device memory. Then each side's host cost of a launch: the
host microseconds of 2000 back-to-back calls from Python (the wrapper's
allocation, the ctypes call and the launch; batch 1, 4096x4096), in the
same turns. One JSON line per side and body: the batch-1 and batch-4 decode
steps' 225 launches summed (one entry a turn), each shape's ms, the host us
a launch, and the batch-1 byte bound; then the card's name and power limit.
Exits 1 if either side disagrees. Needs a GPU.
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

BATCHES = (1, 4)


def build(side: str, root: Path):
    """This side's q4_matmul library, bound, built from `root`'s csrc/."""
    from robustvlm_tpu_torch.ops.kernels import _build, q4_matmul

    csrc = root / "robustvlm_tpu_torch" / "csrc"
    out = ROOT / "build" / "compare" / side
    out.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    (lib, _), = _build.build_variants({"q4": (csrc / "q4_matmul.cu").read_text()}, out, "q4").values()
    return q4_matmul.bind(lib)


def main() -> int:
    import torch

    import chip_smoke as S
    import sweep_q4_matmul_torch as W
    from robustvlm_tpu_torch.ops.kernels import q4_matmul as Q

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    libs = {"other": build("other", Path(sys.argv[1]).resolve()), "this": build("this", ROOT)}
    weights, xs = W.weights_and_inputs()
    bound = W.step_bound_ms(weights, S.peaks_for(torch.cuda.get_device_name(0)))
    rows, ok = {}, True
    for side, lib in libs.items():
        for group in (True, False):
            within = True
            for (k, n), copies in weights.items():
                p, s = copies[0]
                for b in BATCHES:
                    got = W.call(lib, xs[b, k], p, s, group)
                    within &= torch.equal(got, W.call(lib, xs[b, k], p, s, group))
                    within &= S._q4_within(got, Q.q4_matmul_reference(xs[b, k], p, s, group=group),
                                           "bfloat16")[1]
            ok &= within
            rows[side, group] = {"side": side, "body": "group" if group else "shift",
                                 "within_and_repeatable": within, "turns": []}
    for side in ("other", "this", "this", "other"):
        for group in (True, False):
            rows[side, group]["turns"].append(W.time_shapes(libs[side], weights, xs, group, BATCHES))
    p, s = weights[4096, 4096][0]
    for side in ("other", "this", "this", "other"):
        for group in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                W.call(libs[side], xs[1, 4096], p, s, group)
            host_us = (time.perf_counter() - t0) * 1e6 / 2000
            torch.cuda.synchronize()
            rows[side, group].setdefault("host_us_per_launch", []).append(host_us)
    for row in rows.values():
        turns = row.pop("turns")
        row.update({"step_ms_b1": [W.step_ms(m, 1) for m in turns],
                    "step_ms_b4": [W.step_ms(m, 4) for m in turns],
                    "step_bound_ms_b1": bound, "ms_per_shape": turns})
        print(json.dumps(row), flush=True)
    print(S.card_line())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
