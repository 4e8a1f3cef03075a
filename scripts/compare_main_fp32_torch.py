#!/usr/bin/env python3
"""Time the CLI's float32 APGD-CE attack at CLIP ViT-L/14 with the ViT
attention kernels of another checkout and of this one bound in turn, in
alternating pairs, in one process on one GPU.

    python3 scripts/compare_main_fp32_torch.py OTHER_ROOT [--pairs N]

Both checkouts' `vit_attention.cu` are built as `compare_attention_torch.py`
builds them (each with its own headers, under `build/compare/<side>/`).
Each run is `robustbench.main` (the CLI entry point) as `chip_smoke.py`'s
`main[float32]` drives it, but with APGD-CE alone: ViT-L/14 full width,
random weights, 8 synthetic images, eps 2/255, 100 iterations, float32;
the ViT attention wrapper's library is the side's for that run (the
module's `_lib` is rebound here; the package has no switch). One warm-up
run, then N pairs (default 5), other-this and this-other in turn. One JSON
line per run (the CLI's attack seconds, the wall seconds, the ViT kernels'
launches), then the means and the per-pair difference other - this with its
standard deviation, and the card's name and power limit. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def main() -> int:
    import torch

    import chip_smoke as C
    import compare_attention_torch as CA
    from robustvlm_tpu_torch.device import use_full_fp32
    from robustvlm_tpu_torch.eval import robustbench
    from robustvlm_tpu_torch.ops.kernels import vit_attention as A

    ap = argparse.ArgumentParser()
    ap.add_argument("other_root")
    ap.add_argument("--pairs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    use_full_fp32()
    libs = {"other": CA.build("other", Path(args.other_root).resolve())["vit_attention"],
            "this": CA.build("this", ROOT)["vit_attention"]}
    out_dir = ROOT / "chiprun_out" / "compare_main_fp32"
    argv = ["--device", "cuda", "--clip_model_name", "ViT-L-14", "--template", "std",
            "--dataset", "synthetic", "--n_ex", "8", "--attack_batch", "8", "--batch_size", "8",
            "--eps", str(C.MAIN_EPS), "--attacks", "apgd-ce", "--n_iter", "100",
            "--compute_dtype", "float32", "--labels", "predicted", "--output_dir", str(out_dir)]

    def run(side: str, label: str) -> float:
        A._lib = lambda lib=libs[side]: lib
        before = dict(A.LAUNCHES)
        t0 = time.perf_counter()
        result = robustbench.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: A.LAUNCHES[k] - before[k] for k in before}
        print(json.dumps({"run": label, "side": side, "attack_s": result["wall_s"], "wall_s": wall,
                          "vit_launches": launches, "robust_acc": result["robust_acc"]}), flush=True)
        return result["wall_s"]

    run("this", "warm-up")
    times = {"other": [], "this": []}
    diffs = []
    for i in range(args.pairs):
        order = ("other", "this") if i % 2 == 0 else ("this", "other")
        pair = {side: run(side, f"pair {i}") for side in order}
        for side, s in pair.items():
            times[side].append(s)
        diffs.append(pair["other"] - pair["this"])
    print(json.dumps({
        "attack_s": times,
        "mean": {side: statistics.mean(v) for side, v in times.items()},
        "other_minus_this": {"per_pair": diffs, "mean": statistics.mean(diffs),
                             "stdev": statistics.stdev(diffs) if len(diffs) > 1 else None},
    }))
    print(C.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
