"""Checkpointing as `torch.save` state dicts, with a torch-layout export.

Counterpart of `robustvlm_tpu/utils/checkpoint.py`, with the same policy:
`n_snapshots` evenly spaced snapshots (`step_<s>`), a rolling
`fallback_<s>` every `fallback_every` steps (older fallbacks removed), a
`final` checkpoint, and `restore` by name. Each checkpoint is a directory
`<name>/` holding the model's state dict (`params.pt`), and `<name>_opt/`
the optimizer's (`opt.pt`). `export_torch_visual` writes the visual tower
in the torch layout (`conv1.weight`, ...) that `visual_from_openai` and the
upstream eval stack read.
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path

import torch

from robustvlm_tpu_torch.models.clip.convert import export_visual_state_dict


def _save(path: Path, name: str, state) -> None:
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    torch.save(state, path / name)


class CheckpointManager:
    def __init__(self, output_dir: str, total_steps: int, n_snapshots: int = 10,
                 fallback_every: int = 200):
        self.dir = Path(output_dir) / "checkpoints"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.total_steps = total_steps
        self.snapshot_every = max(total_steps // n_snapshots, 1)
        self.fallback_every = fallback_every

    def save(self, name: str, model, optimizer) -> None:
        _save(self.dir / name, "params.pt", model.state_dict())
        _save(self.dir / f"{name}_opt", "opt.pt", optimizer.state_dict())

    def maybe_save(self, step: int, model, optimizer) -> None:
        if step % self.snapshot_every == 0:
            self.save(f"step_{step}", model, optimizer)
        if step % self.fallback_every == 0:
            self.save(f"fallback_{step}", model, optimizer)
            for p in self.dir.glob("fallback_*"):
                m = re.match(r"fallback_(\d+)", p.name)
                if m and int(m.group(1)) != step:
                    shutil.rmtree(p, ignore_errors=True)

    def save_final(self, model, optimizer) -> None:
        self.save("final", model, optimizer)

    def restore(self, name: str, model, optimizer=None) -> bool:
        """Load `name` into the model, and into the optimizer when its
        `_opt` directory exists; returns whether the optimizer was restored."""
        dev = next(model.parameters()).device
        model.load_state_dict(torch.load(self.dir / name / "params.pt", map_location=dev))
        opt_path = self.dir / f"{name}_opt" / "opt.pt"
        if optimizer is None or not opt_path.exists():
            return False
        optimizer.load_state_dict(torch.load(opt_path, map_location=dev))
        return True

    def export_torch_visual(self, model, clip_cfg, name: str = "final.pt") -> Path:
        """Write the visual tower as a torch-layout state dict .pt."""
        out = self.dir / name
        torch.save(export_visual_state_dict(model.state_dict(), clip_cfg), out)
        return out
