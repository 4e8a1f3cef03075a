"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`build/kernels/<name>-<hash>.so` at the repository root, at first use. The
hash covers the source, the headers of `csrc/` it may include and the
flags, so an edited kernel or header is rebuilt and a built one is reused.
`build_all` starts one nvcc per source, all at once; `build_variants` does
the same for edited copies of a source (the tuning sweeps).

Nothing here runs at import time: the CPU tests import every module, and
the CPU has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
KERNELS = ("attack_step", "vit_attention", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills, kept in BUILD_LOGS
)

BUILD_LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, one nvcc process per
    source, all started together. Returns the wall seconds per source
    (0.0 for one already built). Raises with nvcc's output on failure."""
    started = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[name] = (proc, tmp, out)
    secs = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in started.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return secs


def build_variants(sources: Dict[object, str], out_dir: Path, prefix: str) -> Dict[object, tuple]:
    """Compile edited copies of a `csrc/` source, one nvcc process each, all
    started together, into `out_dir/<prefix>_<i>.so`; `csrc/` is on the
    include path, so the copies find its headers. Returns {key: (loaded
    library, nvcc's output)}. Raises with nvcc's output on failure."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (key, src) in enumerate(sources.items()):
        cu, so = out_dir / f"{prefix}_{i}.cu", out_dir / f"{prefix}_{i}.so"
        cu.write_text(src)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(so), str(cu)]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), so)
    built = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {key}:\n{log}")
        built[key] = (ctypes.CDLL(str(so)), log)
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def check_launch(err: int, what: str) -> None:
    """Raise on a non-zero cudaGetLastError() code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
