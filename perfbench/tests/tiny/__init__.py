"""Small configurations and traffic for the CPU tests: the cells' own
files with every size cut, so a run takes seconds. Found by name, one
file each, beside this one:

- a configuration's small sizes: `configs/<config>.json`, the whole
  configuration as the small run takes it;
- a traffic mix's own cut, where it has keys the cut below does not know:
  `traffic/<traffic>.json`, merged over the cut (nested objects key by key).
"""

import copy
from pathlib import Path

from harness import registry

HERE = Path(__file__).resolve().parent


def small_config(name: str) -> dict:
    return registry.load_json(HERE / "configs" / f"{name}.json")


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def traffic(cell: str) -> dict:
    name = registry.workload(cell)["traffic"]
    tr = copy.deepcopy(registry.traffic(name))
    tr["images"] = dict(tr["images"], batch=4, size=32)
    if "attack" in tr:
        tr["attack"] = dict(tr["attack"], n_iter=8, eps_255=16.0)
    if "generate" in tr:
        tr["generate"] = dict(tr["generate"], max_new_tokens=5)
        tr["check"] = dict(tr["check"], sample_items=3)
    if "train" in tr:
        tr["train"] = dict(tr["train"], iterations_adv=3)
    tr["trace"] = {"first_call": 1, "calls": 2, "steps": 1}
    own = HERE / "traffic" / f"{name}.json"
    return _merge(tr, registry.load_json(own)) if own.is_file() else tr


def config(cell: str) -> dict:
    return small_config(registry.workload(cell)["config"])


CLIP = small_config("clip-vit-l-14")
FLAMINGO = small_config("openflamingo-9b")
