"""Resumable AutoAttack evaluation state.

The port's own copy of `robustvlm_tpu/eval/state.py`: a JSON record of
which attacks have run, per-example robust flags and clean accuracy, with
throttled disk writes so long evaluations survive preemption.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional, Set

import numpy as np

_WRITE_INTERVAL_S = 60.0


class EvaluationState:
    def __init__(self, attacks_to_run: Set[str], path: Optional[Path] = None):
        self.attacks_to_run = set(attacks_to_run)
        self.path = Path(path) if path is not None else None
        self.run_attacks: Set[str] = set()
        self.robust_flags: Optional[np.ndarray] = None
        self.clean_accuracy: Optional[float] = None
        self._last_write = 0.0

    # ------------------------------------------------------------- persistence
    def to_disk(self, force: bool = False) -> None:
        if self.path is None:
            return
        now = time.time()
        if not force and now - self._last_write < _WRITE_INTERVAL_S:
            return
        payload = {
            "attacks_to_run": sorted(self.attacks_to_run),
            "run_attacks": sorted(self.run_attacks),
            "robust_flags": (
                self.robust_flags.astype(int).tolist()
                if self.robust_flags is not None
                else None
            ),
            "clean_accuracy": self.clean_accuracy,
        }
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload))
        tmp.replace(self.path)
        self._last_write = now

    @classmethod
    def from_disk(cls, path) -> "EvaluationState":
        payload = json.loads(Path(path).read_text())
        st = cls(set(payload["attacks_to_run"]), path=path)
        st.run_attacks = set(payload["run_attacks"])
        if payload["robust_flags"] is not None:
            st.robust_flags = np.asarray(payload["robust_flags"], dtype=bool)
        st.clean_accuracy = payload["clean_accuracy"]
        return st

    def add_run_attack(self, attack: str) -> None:
        self.run_attacks.add(attack)
        self.to_disk(force=True)
