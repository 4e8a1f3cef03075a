"""Each cell's whole run at a small size on the CPU: set-up, window,
release, check and result line; then the same run with the timed path
broken underneath by each fault the cell's entry declares, which the check
must catch (`correct` false) through a number the fault names, and the
control (the reference in fp8 in the program's place), which must read
above a sound run."""

import time

import pytest
import torch

import tiny
from harness import core, faults, registry

BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _execute(cell, trace=False):
    return core.execute(cell, 2 ** 31 + 21, 0.2, trace, torch.device("cpu"), time.perf_counter(),
                        cfg=tiny.config(cell), tr=tiny.traffic(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_the_contract_line(cell):
    line = _execute(cell)
    assert list(line)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(line)[-1] == "checks"
    e2e, _ = registry.cell_metrics(BENCH, cell)
    assert set(line["metrics"]) == set(e2e)
    assert line["attempted"] > 0 and line["failed"] == 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def _faults(cell) -> dict:
    return faults.declared(registry.entry(registry.workload(cell)["entry"]))


def _cases():
    return [(c, f) for c in CELLS for f in _faults(c)]


@pytest.mark.parametrize("cell,fault", _cases())
def test_a_fault_underneath_makes_the_run_incorrect(cell, fault):
    planted = _faults(cell)[fault]
    with planted():
        line = _execute(cell)
    assert line["correct"] is False
    assert any(line["checks"][n]["value"] > line["checks"][n]["limit"]
               for n in planted.caught_by if n in line["checks"]), line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_above_a_sound_run(cell):
    wl = registry.workload(cell)
    run = core.Run(wl, tiny.config(cell), tiny.traffic(cell), 9, torch.device("cpu"), False)
    obj = registry.entry(wl["entry"]).Cell(run)
    obj.setup()
    obj.unit(0)
    obj.freeze()
    sound = obj.readings()
    control = obj.readings(candidate=obj.control())
    assert any(control[k] > 3 * sound[k] for k in ("logit_gap", "grad_gap", "loss_gap") if k in sound), \
        (sound, control)
