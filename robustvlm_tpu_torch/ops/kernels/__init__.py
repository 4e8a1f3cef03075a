"""The port's hand-written CUDA kernels and their launch counters."""

from __future__ import annotations

from typing import Dict


def _counters() -> list:
    from . import attack_step, block_ops, flash_attention, q4_matmul, vit_attention

    return [attack_step.LAUNCHES, vit_attention.LAUNCHES, flash_attention.LAUNCHES, q4_matmul.LAUNCHES,
            q4_matmul.LAUNCHES_BY_ROWS, block_ops.LAUNCHES]


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def launches() -> Dict[str, int]:
    """Every kernel wrapper's launch count since the last reset, by name."""
    return {k: v for counts in _counters() for k, v in counts.items()}
