"""The one generator of the benchmark's inputs, read from a traffic file.

Every input comes from the run's `--seed`: a unit (an attack chunk, a
caption group, a training step) draws from `fold(seed, unit)`, so the same
seed gives the same inputs and every seed gives inputs of the same sizes.
Images are drawn on the device; captions on the host, from the traffic
file's vocabulary, with a fixed word count, so every group's prompts have
the same token length.
"""

from __future__ import annotations

import random
from typing import Dict, List

import torch

_MASK64 = (1 << 64) - 1


def fold(seed: int, data: int) -> int:
    """A child seed from (seed, data), splitmix64-mixed; any integer seed
    (the driver's pass 32 bits) gives a seed `torch.Generator` takes."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def images(spec: Dict, seed: int, unit: int, device) -> torch.Tensor:
    """(batch, 3, size, size) float32 pixels in [0, 1) for `unit`."""
    if spec.get("pixels", "uniform") != "uniform":
        raise ValueError(f"unknown pixel distribution {spec['pixels']!r}")
    b, s = int(spec["batch"]), int(spec["size"])
    return torch.rand((b, 3, s, s), generator=generator(fold(seed, 2 * unit), device), device=device)


def captions(spec: Dict, seed: int, unit: int, n_images: int) -> List[Dict]:
    """Per image of `unit`: `per_image` reference captions and `demos` demo
    captions, each `words` words drawn from the vocabulary."""
    rng = random.Random(fold(seed, 2 * unit + 1))
    vocab, w = list(spec["vocabulary"]), int(spec["words"])

    def caption() -> str:
        return " ".join(rng.choice(vocab) for _ in range(w))

    return [{"all_captions": [caption() for _ in range(int(spec["per_image"]))],
             "demos": [{"caption": caption()} for _ in range(int(spec["demos"]))]}
            for _ in range(n_images)]
