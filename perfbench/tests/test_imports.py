"""What the benchmark runs imports, walked from perfbench/run.py through the
harness, every entry, reader, count and reference file, and the port's
modules they reach: no JAX, no JAX package, no repo script; and the plain
references import nothing of the program. Names are compared whole, by
their top-level part: `robustvlm_tpu_torch` is the port, `robustvlm_tpu`
the JAX package."""

import ast
from pathlib import Path

import pytest

from harness import registry

BENCH = registry.BENCH
ROOT = registry.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "robustvlm_tpu", "scripts", "bench", "chip_smoke"}


def _imports(path: Path):
    """(top-level name, dotted name) of every import in a file, relative
    imports resolved against the file's package."""
    tree = ast.parse(path.read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                pkg = path.parent
                for _ in range(node.level - 1):
                    pkg = pkg.parent
                base = ".".join(pkg.relative_to(ROOT).parts)
                mod = f"{base}.{node.module}" if node.module else base
            else:
                mod = node.module
            out.append((mod.split(".")[0], mod))
            out += [(mod.split(".")[0], f"{mod}.{a.name}") for a in node.names]
    return out


def _file_of(dotted: str):
    """The file a dotted module name loads from: the harness and reference
    packages under perfbench/, the port under the checkout."""
    for base in (BENCH, ROOT):
        p = base.joinpath(*dotted.split("."))
        if p.with_suffix(".py").is_file():
            return p.with_suffix(".py")
        if (p / "__init__.py").is_file():
            return p / "__init__.py"
    return None


def _closure(starts):
    seen, todo, tops = set(), list(starts), {}
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for top, dotted in _imports(f):
            tops.setdefault(top, set()).add(str(f.relative_to(ROOT)))
            if top in ("harness", "reference", "robustvlm_tpu_torch"):
                parts = dotted.split(".")
                for k in range(1, len(parts) + 1):
                    target = _file_of(".".join(parts[:k]))
                    if target is not None and target not in seen:
                        todo.append(target)
    return seen, tops


def _harness_files():
    files = [BENCH / "run.py", BENCH / "calibrate.py"]
    for sub in ("harness", "entries", "metrics", "counts", "reference"):
        files += sorted((BENCH / sub).glob("*.py"))
    return files


def test_nothing_the_benchmark_runs_imports_jax_or_a_script():
    seen, tops = _closure(_harness_files())
    bad = {t: sorted(f) for t, f in tops.items() if t in FORBIDDEN}
    assert not bad, bad
    assert any("robustvlm_tpu_torch" in str(f) for f in seen)  # the port is walked too


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    _, tops = _closure([path])
    assert set(tops) <= {"__future__", "math", "re", "zlib", "typing", "torch", "numpy", "reference"}, tops


def test_whole_names_are_compared():
    from harness.core import loaded_forbidden
    import sys

    sys.modules.setdefault("robustvlm_tpu_torch_probe_name", sys)
    try:
        assert "robustvlm_tpu" not in loaded_forbidden()
    finally:
        del sys.modules["robustvlm_tpu_torch_probe_name"]
