"""Everything the harness runs is found by name, one file each.

- a cell: `workloads/<cell>.json` (its configuration, traffic, entry, chips and limits);
- a configuration: `configs/<config>.json`, its counts `counts/<config>.py`;
- a traffic mix: `traffic/<traffic>.json`;
- an entry (the code that drives the program for a kind of job): `entries/<entry>.py`;
- a per-layer metric: `metrics/<metric>.py`, whose `read(ctx)` returns a number or None.

Python files are loaded by path, so a name may hold dots and dashes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

_MODULES: dict = {}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def load_module(path: Path) -> ModuleType:
    key = str(path)
    mod = _MODULES.get(key)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError(f"no such file: {path.relative_to(BENCH.parent)}")
        spec = importlib.util.spec_from_file_location(f"perfbench_{path.parent.name}_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return mod


def entry(name: str) -> ModuleType:
    return load_module(BENCH / "entries" / f"{name}.py")


def counts(config_name: str) -> ModuleType:
    return load_module(BENCH / "counts" / f"{config_name}.py")


def metric(name: str) -> ModuleType:
    return load_module(BENCH / "metrics" / f"{name}.py")


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(end-to-end names, per-layer names) that `bench` asks of `cell`: a
    metric with a `workloads` list is reported in those cells, one without
    it in every cell."""
    def wanted(m):
        return "workloads" not in m or cell in m["workloads"]

    return ([m["name"] for m in bench["end_to_end"] if wanted(m)],
            [m["name"] for m in bench["per_layer"] if wanted(m)])
