"""The harness's own tests: `python -m pytest perfbench/tests`. They import
the harness as `run.py` does (perfbench/ and the checkout's root on the
path). Tests marked `cuda` need the card and skip without one."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
