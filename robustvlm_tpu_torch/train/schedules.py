"""Learning-rate schedules.

Counterpart of `robustvlm_tpu/train/schedules.py`: open_clip's
`cosine_lr`, a linear warmup (step + 1) / warmup, then a cosine decay to 0
over the remaining steps. Computed in float32, as the JAX schedule is.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def cosine_warmup_lr(base_lr: float, warmup: int, total_steps: int) -> Callable[[int], float]:
    """Returns schedule(step) -> lr, a Python float of the float32 value."""
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        if s < f32(warmup):
            return float(f32(base_lr) * (s + f32(1.0)) / f32(max(warmup, 1)))
        progress = (s - f32(warmup)) / f32(max(total_steps - warmup, 1))
        return float(f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * progress)) * f32(base_lr))

    return schedule
