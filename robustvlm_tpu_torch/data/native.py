"""ctypes bindings of the host-side C++ image transform (csrc/image_ops.cpp).

Counterpart of `robustvlm_tpu/data/native.py`: PIL-convention antialiased
bicubic resize (a = -0.5), shorter-side resize plus center crop, and uint8
HWC -> float32 CHW [0,1], each row-parallel over `n_threads` threads. The
library is built at first use with g++ and the flags of the JAX package's
`native/Makefile` into `build/native/` at the repository root (the file
name carries a hash of the source, the flags and the host CPU's features,
which `-march=native` compiles for), so the two packages give the same
bits. `available()` is False where no compiler or library can be
had; `native_image_transform` then returns None and the loaders take PIL.
Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "image_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# native/Makefile's CXXFLAGS, then its link line
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
LDFLAGS = ("-lpthread",)

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_LOCK = threading.Lock()
BUILD_LOG = ""


def _cpu_features() -> str:
    """The host CPU's feature flags: `-march=native` builds for them, so a
    library built on one machine is not loaded on another."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith(("flags", "Features"))), "")
    except OSError:
        return platform.machine() + platform.processor()


def library_path() -> Path:
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS + LDFLAGS).encode())
    h.update(_cpu_features().encode())
    return BUILD_DIR / f"librobustvlm_image-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    global BUILD_LOG
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build the image transform")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(_SOURCE), *LDFLAGS],
                          capture_output=True, text=True, timeout=300)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SOURCE.name}:\n{BUILD_LOG}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _LOCK:
        if _lib is not None or _load_failed:
            return _lib
        path = library_path()
        try:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            _load_failed = True
            return None
        u8 = ctypes.POINTER(ctypes.c_uint8)
        f32 = ctypes.POINTER(ctypes.c_float)
        i = ctypes.c_int
        lib.resize_bicubic_u8_chw.argtypes = [u8, i, i, i, f32, i, i, i]
        lib.u8_hwc_to_f32_chw.argtypes = [u8, i, i, i, f32, i]
        lib.resize_center_crop_u8_chw.argtypes = [u8, i, i, i, f32, i, i]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _as_u8_hwc(img: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(img)
    if arr.dtype != np.uint8 or arr.ndim != 3:
        raise ValueError(f"need a uint8 HWC array, got {arr.dtype} {arr.shape}")
    return arr


def _ptrs(src: np.ndarray, out: np.ndarray):
    return (src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the image transform library could not be built:\n{BUILD_LOG}")
    return lib


def resize_bicubic(img: np.ndarray, dh: int, dw: int, n_threads: int = 4) -> np.ndarray:
    """uint8 HWC -> float32 CHW [0,1], PIL-style antialiased bicubic."""
    lib = _require()
    arr = _as_u8_hwc(img)
    h, w, c = arr.shape
    out = np.empty((c, dh, dw), np.float32)
    src, dst = _ptrs(arr, out)
    lib.resize_bicubic_u8_chw(src, h, w, c, dst, dh, dw, n_threads)
    return out


def resize_center_crop(img: np.ndarray, size: int, n_threads: int = 4) -> np.ndarray:
    """Shorter-side resize to `size`, then the center crop: float32 CHW
    [0,1] (the CLIP preprocessing without Normalize)."""
    lib = _require()
    arr = _as_u8_hwc(img)
    h, w, c = arr.shape
    out = np.empty((c, size, size), np.float32)
    src, dst = _ptrs(arr, out)
    lib.resize_center_crop_u8_chw(src, h, w, c, dst, size, n_threads)
    return out


def to_chw_f32(img: np.ndarray, n_threads: int = 4) -> np.ndarray:
    """uint8 HWC -> float32 CHW [0,1], no resize."""
    lib = _require()
    arr = _as_u8_hwc(img)
    h, w, c = arr.shape
    out = np.empty((c, h, w), np.float32)
    src, dst = _ptrs(arr, out)
    lib.u8_hwc_to_f32_chw(src, h, w, c, dst, n_threads)
    return out


def native_image_transform(size: int = 224, n_threads: int = 4):
    """PIL image -> float32 CHW [0,1] through the C++ transform, the drop-in
    for `data.loaders.default_image_transform`; None when the library is
    not available."""
    if not available():
        return None

    def tf(img) -> np.ndarray:
        if img.mode != "RGB":
            img = img.convert("RGB")
        return resize_center_crop(np.asarray(img), size, n_threads)

    tf.native = True
    return tf
