"""A new configuration joins the benchmark as new files alone. In a copy of
perfbench/ and BENCHMARK.json, a cell of a new configuration is added
through a new entry: copies of `openflamingo-9b`'s files and of
`entries/caption_attack.py` (with a fault of its own, declared there) under
new names, the configuration's small sizes, and the new cell's name added
to the `workloads` lists of the metrics it reports. No file that was there
is otherwise changed, and the copy's own tests run the new cell: its result
line, each fault its entry declares caught, the control above a sound run.
The copy's harness is found from its own files, so it runs in a process of
its own."""

import copy
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import tiny
from harness import registry

LIKE_CELL, LIKE_CONFIG, LIKE_ENTRY = "of9b.apgd-caption.b64", "openflamingo-9b", "caption_attack"
CONFIG, ENTRY, CELL = "flamingocopy", "caption_copy", "flamingocopy.apgd-caption.b64"
OWN_FAULT = '''

@faults.fault("ball_excess")
def first_image_moved():
    """This entry's own fault: one adversarial image moved off its ball."""
    with faults.answer_altered():
        yield


FAULTS = FAULTS + (first_image_moved,)
'''


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _add_cell(root: Path) -> None:
    bench = root / "perfbench"
    for sub, suffix in (("configs", ".json"), ("counts", ".py"), ("tests/tiny/configs", ".json")):
        shutil.copyfile(bench / sub / f"{LIKE_CONFIG}{suffix}", bench / sub / f"{CONFIG}{suffix}")
    (bench / "entries" / f"{ENTRY}.py").write_text(
        (bench / "entries" / f"{LIKE_ENTRY}.py").read_text() + OWN_FAULT)
    wl = registry.load_json(bench / "workloads" / f"{LIKE_CELL}.json")
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(dict(wl, config=CONFIG, entry=ENTRY), indent=2))
    spec = registry.load_json(root / "BENCHMARK.json")
    like = next(c for c in spec["configs"] if c["name"] == LIKE_CONFIG)
    spec["configs"].append(dict(like, name=CONFIG, file=f"perfbench/configs/{CONFIG}.json"))
    like = next(w for w in spec["workloads"] if w["name"] == LIKE_CELL)
    spec["workloads"].append(dict(like, name=CELL, config=CONFIG))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if LIKE_CELL in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))


def _without_cell(spec: dict) -> dict:
    spec = copy.deepcopy(spec)
    spec["configs"] = [c for c in spec["configs"] if c["name"] != CONFIG]
    spec["workloads"] = [w for w in spec["workloads"] if w["name"] != CELL]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != CELL]
    return spec


def test_a_new_configuration_and_entry_join_as_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(registry.BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc", ".pytest_cache"))
    shutil.copyfile(registry.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root)
    _add_cell(root)
    after = _digests(root)
    changed = sorted(p for p, d in before.items() if after[p] != d)
    assert changed == ["BENCHMARK.json"], changed
    assert _without_cell(registry.load_json(root / "BENCHMARK.json")) == registry.benchmark()

    # one thread: the suite's own workers hold the other cores
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (str(registry.ROOT), os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider", "-p", "no:randomly", "-o", "addopts=",
         "perfbench/tests/test_benchmark_file.py", "perfbench/tests/test_cells.py", "-k",
         f"test_benchmark_file or {CONFIG}"],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    passed = set(re.findall(r"test_cells\.py::(\S+) PASSED", res.stdout))
    faults = ("step_unchanged", "half_batch", "answer_altered", "caption_altered", "first_image_moved")
    assert passed == {f"test_a_run_prints_the_contract_line[{CELL}]",
                      f"test_the_control_reads_above_a_sound_run[{CELL}]",
                      *(f"test_a_fault_underneath_makes_the_run_incorrect[{CELL}-{f}]" for f in faults)}, passed
    assert f"test_cell_files_are_found_by_name[{CELL}] PASSED" in res.stdout


def test_a_traffic_brings_its_own_cut_by_name(tmp_path, monkeypatch):
    name = registry.workload(LIKE_CELL)["traffic"]
    plain = tiny.traffic(LIKE_CELL)
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / f"{name}.json").write_text(
        json.dumps({"generate": {"max_new_tokens": 2}, "extra": {"rounds": 1}}))
    monkeypatch.setattr(tiny, "HERE", tmp_path)
    own = tiny.traffic(LIKE_CELL)
    assert own["generate"] == dict(plain["generate"], max_new_tokens=2)
    assert own["extra"] == {"rounds": 1}
    assert {k: v for k, v in own.items() if k not in ("generate", "extra")} == \
        {k: v for k, v in plain.items() if k != "generate"}
