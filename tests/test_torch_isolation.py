"""The PyTorch/CUDA port stands alone: it imports neither JAX nor the JAX
package, and its entry points never carry on on the CPU by themselves."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from robustvlm_tpu_torch import device as port_device

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "robustvlm_tpu")
PORT_FILES = sorted((ROOT / "robustvlm_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", *sorted((ROOT / "scripts").glob("*_torch.py")),
    ROOT / "tests" / "_torch_parallel_workers.py",  # what the parallel tests' spawned ranks import
]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "robustvlm_tpu_torch").rglob("*.py")
    )
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'robustvlm_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_resolve_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device("cuda")
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        port_device.resolve_device("mps")


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers check before they launch; the checks run on any
    tensor, so they are exercised here."""
    from robustvlm_tpu_torch.ops.kernels import attack_step, vit_attention

    x = torch.zeros(2, 8)
    with pytest.raises(TypeError):
        attack_step._check_cuda([x.double(), x, x, x], torch.zeros(2))
    with pytest.raises(ValueError):
        attack_step._check_cuda([x, x, x, torch.zeros(2, 9)], torch.zeros(2))
    with pytest.raises(ValueError):
        attack_step._check_cuda([x, x, x, x], torch.zeros(3))
    q = torch.zeros(4, 10, 64)
    with pytest.raises(ValueError, match="head dim"):
        vit_attention._check_cuda(torch.zeros(4, 10, 16))
    with pytest.raises(TypeError):
        vit_attention._check_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        vit_attention._check_cuda(q, q.transpose(1, 2).contiguous().transpose(1, 2), q)
    with pytest.raises(ValueError, match="aligned"):  # 16-byte vector loads
        vit_attention._check_cuda(q, torch.zeros(q.numel() + 1)[1:].view(q.shape), q)
    vit_attention._check_cuda(q, q, q)

    from robustvlm_tpu_torch.ops.kernels import flash_attention

    kv = torch.zeros(4, 30, 128)
    qf = torch.zeros(4, 10, 128)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention._check_cuda(torch.zeros(4, 10, 80), torch.zeros(4, 30, 80), torch.zeros(4, 30, 80))
    with pytest.raises(TypeError):
        flash_attention._check_cuda(qf.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="disagree"):
        flash_attention._check_cuda(qf, torch.zeros(3, 30, 128), torch.zeros(3, 30, 128))
    with pytest.raises(ValueError, match="one shape"):
        flash_attention._check_cuda(qf, kv, torch.zeros(4, 31, 128))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention._check_cuda(qf, kv, kv.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="slopes"):
        flash_attention._check_cuda(qf, kv, kv, slopes=torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="empty"):
        flash_attention._check_cuda(torch.zeros(4, 0, 128), kv, kv)
    flash_attention._check_cuda(qf, kv, kv, qf, qf, slopes=torch.zeros(4))


def test_chip_smoke_fails_without_cuda_or_package(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a GPU, and
    alone in a directory without the package."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    scripts = [alone]
    if not torch.cuda.is_available():  # with a GPU the full script would run
        scripts.append(ROOT / "chip_smoke.py")
    for script in scripts:
        out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
