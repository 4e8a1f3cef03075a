#!/usr/bin/env python3
"""Time the CLI's APGD attack at CLIP ViT-L/14 with the attention kernels of
another checkout and of this one bound in turn, in alternating pairs, in one
process on one GPU.

    python3 scripts/compare_main_fp32_torch.py OTHER_ROOT [--pairs N]
        [--compute_dtype float32|bfloat16]

Both checkouts' `attention.cu` is built as `compare_attention_torch.py`
builds it (each with its own headers, under `build/compare/<side>/`), so
both checkouts must have that one source (from the merge of the ViT and
flash launch paths on; older ones build two sources). Each run is
`robustbench.main` (the CLI entry point) at ViT-L/14 full width, random
weights, 8 synthetic images, eps 2/255, 100 iterations: in float32 (the default) with APGD-CE alone (of
`chip_smoke.py`'s `main[float32]`, which runs APGD-CE then APGD-T), in
bfloat16 with APGD-T as `main[bfloat16]` runs it. Both attention entry
points launch the side's library for that run (the shared CUDA front's
`_lib` is rebound here; the package has no switch). One warm-up
run a side, then N pairs (default 5), other-this and this-other in turn. One JSON
line per run (the CLI's attack seconds, the wall seconds, the ViT kernels'
launches), then the means and the per-pair difference other - this with its
standard deviation, and the card's name and power limit. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
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
    ap.add_argument("--compute_dtype", choices=("float32", "bfloat16"), default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    use_full_fp32()
    libs = CA.libraries(Path(args.other_root).resolve())
    attacks = "apgd-ce" if args.compute_dtype == "float32" else "apgd-t"
    out_dir = ROOT / "chiprun_out" / f"compare_main_{args.compute_dtype}"
    argv = ["--device", "cuda", "--clip_model_name", "ViT-L-14", "--template", "std",
            "--dataset", "synthetic", "--n_ex", "8", "--attack_batch", "8", "--batch_size", "8",
            "--eps", str(C.MAIN_EPS), "--attacks", attacks, "--n_iter", "100",
            "--compute_dtype", args.compute_dtype, "--labels", "predicted",
            "--output_dir", str(out_dir)]

    def run(side: str, label: str) -> float:
        before = dict(A.LAUNCHES)
        t0 = time.perf_counter()
        result = robustbench.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: A.LAUNCHES[k] - before[k] for k in before}
        print(json.dumps({"run": label, "side": side, "attack_s": result["wall_s"], "wall_s": wall,
                          "vit_launches": launches, "robust_acc": result["robust_acc"]}), flush=True)
        return result["wall_s"]

    turns = CA.in_turns(libs, args.pairs, run)
    print(json.dumps({"compute_dtype": args.compute_dtype, "attacks": attacks,
                      "attack_s": turns.pop("values"), **turns}))
    print(C.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
