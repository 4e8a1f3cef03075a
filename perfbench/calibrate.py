#!/usr/bin/env python3
"""The readings the correctness limits are set from, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11 12 13 [--control] [--faults a b]

For each seed, in one process: the cell's set-up, then one unit of the
timed path as the window runs it, and the cell's compared numbers for the
program (a sound run: the lower readings); with `--control`, the same
numbers with the plain reference computed in fp8 (the step below the
configuration's bfloat16) put in the program's place; with `--faults`, one
more unit under each named fault that the cell's entry declares (its
`FAULTS`) and its numbers.
One JSON line per reading, also appended to chiprun_out/calibrate.jsonl.
The benchmark's own runs never run this.
"""

import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import core, faults, registry  # noqa: E402


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", nargs="*", default=[])
    args = p.parse_args(argv)
    core.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(registry.ROOT))
    device = torch.device("cuda", 0)
    wl = registry.workload(args.workload)
    planted = faults.declared(registry.entry(wl["entry"]))
    unknown = set(args.faults) - set(planted)
    if unknown:
        print(f"calibrate: {args.workload} declares no fault {sorted(unknown)}; it has {sorted(planted)}",
              file=sys.stderr)
        return 2
    out = registry.ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        with open(out / "calibrate.jsonl", "a") as f:
            f.write(line + "\n")

    emit(dict(core.card(torch.cuda.device_count()), workload=args.workload))
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = core.Run(wl, registry.config(wl["config"]), registry.traffic(wl["traffic"]),
                       seed, device, False)
        cell = registry.entry(wl["entry"]).Cell(run)
        cell.setup()
        emit({"seed": seed, "kind": "setup", "seconds": time.perf_counter() - t0})
        t1 = time.perf_counter()
        cell.unit(0)
        cell.freeze()
        emit({"seed": seed, "kind": "sound", "unit_s": time.perf_counter() - t1, "readings": cell.readings()})
        if args.control:
            emit({"seed": seed, "kind": "control", "readings": cell.readings(candidate=cell.control())})
        for name in args.faults:
            with planted[name]():
                cell.fresh()
                cell.unit(0)
                cell.freeze()
            emit({"seed": seed, "kind": name, "readings": cell.readings()})
        del cell, run
        gc.collect()  # the cell and its runner hold each other
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
