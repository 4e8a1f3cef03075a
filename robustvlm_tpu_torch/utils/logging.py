"""Metric logging: an append-only JSONL file, and wandb when it is importable
and asked for.

Counterpart of `MetricLogger` and `Logger` in `robustvlm_tpu/utils/logging.py`:
the JSONL file `<output_dir>/metrics.jsonl` is the primary sink; `use_wandb`
tries `wandb.init` up to 5 times and falls back to the file alone. `Logger`
is the tee of AutoAttack's logs: stdout and, when given, a file.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


class MetricLogger:
    def __init__(self, output_dir: Optional[str] = None, project: str = "robustvlm_tpu",
                 run_name: str = "run", use_wandb: bool = False, config: Optional[dict] = None):
        self.path = None
        if output_dir is not None:
            Path(output_dir).mkdir(parents=True, exist_ok=True)
            self.path = Path(output_dir) / "metrics.jsonl"
        self._wandb = self._init_wandb(project, run_name, config) if use_wandb else None

    @staticmethod
    def _init_wandb(project, run_name, config, retries: int = 5):
        try:
            import wandb
        except ImportError:
            print("[logger] wandb not installed; JSONL only", file=sys.stderr)
            return None
        for i in range(retries):
            try:
                return wandb.init(project=project, name=run_name, config=config)
            except Exception as e:  # noqa: BLE001 - a tracker's connection errors
                print(f"[logger] wandb init failed ({e}); retry {i + 1}", file=sys.stderr)
                time.sleep(1)
        return None

    def log(self, metrics: Dict, step: Optional[int] = None):
        rec = {k: _to_py(v) for k, v in metrics.items()}
        if step is not None:
            rec["step"] = step
        rec["time"] = time.time()
        if self.path is not None:
            with self.path.open("a") as f:
                f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(rec, step=step)

    def summary(self, metrics: Dict):
        self.log({f"summary/{k}": v for k, v in metrics.items()})
        if self._wandb is not None:
            for k, v in metrics.items():
                self._wandb.summary[k] = _to_py(v)


class Logger:
    """Print each message and append it to `log_path` when one is given."""

    def __init__(self, log_path: Optional[str] = None):
        self.log_path = log_path

    def log(self, msg: str) -> None:
        print(msg)
        if self.log_path is not None:
            with open(self.log_path, "a") as f:
                f.write(msg + "\n")
