"""Every JAX run recipe (`scripts/*.sh`, `examples/*.sh`) has a `_torch`
twin that calls the port's CLI with the JAX recipe's flags, unchanged, plus
`--device`, and the twin's argv parses with the port CLI's own parser."""

import re
import shlex
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_RECIPES = sorted(p for d in ("scripts", "examples") for p in (ROOT / d).glob("*.sh")
                     if not p.name.endswith("_torch.sh"))


def _parser(module: str):
    from robustvlm_tpu_torch.eval import robustbench
    from robustvlm_tpu_torch.train import driver
    from robustvlm_tpu_torch.vlm_eval import pope, run_evaluation, run_evaluation_qualitative

    return {
        "robustvlm_tpu_torch.eval.robustbench": robustbench.build_parser,
        "robustvlm_tpu_torch.train.driver": driver.build_parser,
        "robustvlm_tpu_torch.vlm_eval.run_evaluation": run_evaluation.build_parser,
        "robustvlm_tpu_torch.vlm_eval.run_evaluation_qualitative": run_evaluation_qualitative.build_parser,
        "robustvlm_tpu_torch.vlm_eval.pope": pope.build_parser,
    }[module]()


def _command(path: Path) -> list:
    """The recipe's `python -m ...` command as argv, with every
    `${VAR:?...}` placeholder filled and "$@" dropped."""
    text = path.read_text()
    lines = [ln for ln in text.splitlines() if not ln.lstrip().startswith("#")]
    joined = "\n".join(lines).replace("\\\n", " ")
    cmd = next(ln for ln in joined.splitlines() if ln.strip().startswith("python -m"))
    cmd = re.sub(r"\$\{IMAGES:\?[^}]*\}", "a.jpg b.jpg", cmd)
    cmd = re.sub(r"\$\{(\w+):\?[^}]*\}", lambda m: f"/data/{m.group(1).lower()}", cmd)
    argv = [a for a in shlex.split(cmd) if a != "$@"]
    assert argv[:2] == ["python", "-m"]
    return argv[2:]


def test_every_jax_recipe_has_a_twin():
    assert len(JAX_RECIPES) == 11
    for p in JAX_RECIPES:
        assert p.with_name(p.stem + "_torch.sh").is_file(), p


@pytest.mark.parametrize("path", JAX_RECIPES, ids=lambda p: str(p.relative_to(ROOT)))
def test_twin_parses_with_the_port_cli_and_keeps_the_jax_flags(path):
    twin = path.with_name(path.stem + "_torch.sh")
    jax_cmd, port_cmd = _command(path), _command(twin)
    assert jax_cmd[0].startswith("robustvlm_tpu.")
    assert port_cmd[0] == "robustvlm_tpu_torch." + jax_cmd[0].removeprefix("robustvlm_tpu.")
    i = port_cmd.index("--device")
    assert port_cmd[i + 1] == "cuda"
    assert port_cmd[1:i] + port_cmd[i + 2:] == jax_cmd[1:]
    args = _parser(port_cmd[0]).parse_args(port_cmd[1:])
    assert args.device == "cuda"
    # "$@" comes after --device, so a caller's --device overrides it
    text = twin.read_text()
    if '"$@"' in text:
        assert text.index("--device cuda") < text.index('"$@"')
