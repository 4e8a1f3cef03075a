"""On the card, at each cell's own size: the control (the plain reference in
fp8, the step below the configurations' bfloat16, put in the program's
place) fails the cell's check on three seeds, and a sound unit passes it.
Needs a CUDA device; skips without one:

    python -m pytest perfbench/tests/test_card.py -m cuda -p no:cacheprovider -n 0
"""

import pytest
import torch

from harness import core, registry

BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = (2147483961, 2147483962, 2147483963)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    core.cache_env()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes_at_the_cells_size(cell, device):
    wl = registry.workload(cell)
    limits = wl["limits"]
    for seed in SEEDS:
        run = core.Run(wl, registry.config(wl["config"]), registry.traffic(wl["traffic"]), seed,
                       device, False)
        obj = registry.entry(wl["entry"]).Cell(run)
        obj.setup()
        obj.unit(0)
        obj.freeze()
        sound = obj.readings()
        control = obj.readings(candidate=obj.control())
        assert all(sound[k] <= limits[k] for k in limits), (seed, sound)
        assert any(control[k] > limits[k] for k in limits), (seed, control)
        del obj, run
        torch.cuda.empty_cache()
