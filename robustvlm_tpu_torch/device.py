"""Device resolution for the port's entry points.

Entry points run on `cuda` unless the caller asks for `cpu`. With no GPU and
no explicit `cpu` they raise: the port never carries on on the CPU by itself.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`cuda` by default; `cpu` only when asked for. Raises when CUDA is
    requested (explicitly or by default) and no GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    return dev


def use_full_fp32() -> None:
    """Turn TF32 off for float32 matmuls and convolutions. The JAX reference
    runs float32 at full precision; TF32 keeps about three decimal digits,
    which would move attack trajectories (sign() amplifies last-bit
    differences)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_line() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them. Raises
    `OSError` or `subprocess.SubprocessError` where nvidia-smi is absent or
    fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]
