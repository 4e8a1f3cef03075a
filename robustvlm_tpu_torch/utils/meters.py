"""Running-average meters (counterpart of `robustvlm_tpu/utils/meters.py`)."""

from __future__ import annotations


class AverageMeter:
    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        if val is None:
            return
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def __repr__(self):
        return f"{self.name}: {self.val:.4f} (avg {self.avg:.4f})"
