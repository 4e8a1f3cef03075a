"""BENCHMARK.json against the benchmark's contract: its keys, the
character rules for names and units, and every name found as a file."""

import json
import re

import pytest

from harness import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics_have_units_sources_and_direction(kind):
    for m in BENCH[kind]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        for w in m.get("workloads", []):
            assert w in CELLS, (m["name"], w)
    allowed = {"name", "unit", "better", "source", "workloads"} | (
        {"bound"} if kind == "end_to_end" else {"layer", "moves"})
    for m in BENCH[kind]:
        assert set(m) <= allowed and set(m) >= allowed - {"workloads"}, m


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e, layer = registry.cell_metrics(BENCH, cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert layer


def test_configs_and_cells():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert (registry.ROOT / c["file"]).is_file()
        assert _line(c["why"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = registry.workload(cell)
    assert wl["config"] == entry["config"] and wl["traffic"] == entry["traffic"]
    assert int(wl["chips"]) == entry["chips"]
    registry.config(wl["config"])
    registry.traffic(wl["traffic"])
    registry.counts(wl["config"])
    assert hasattr(registry.entry(wl["entry"]), "Cell")
    _, layer = registry.cell_metrics(BENCH, cell)
    for name in layer:
        assert callable(registry.metric(name).read)


def test_run_length_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
