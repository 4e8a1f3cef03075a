#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the machine it is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the card on an earlier line and, as
its last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device` (and `breakdown` when traced),
then `checks`, each number compared with the plain reference beside its
limit. Exits non-zero with no result line when the cell's CUDA devices are
missing, when the port cannot be imported, or when JAX is loaded.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
