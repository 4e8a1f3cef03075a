"""Multi-process evaluation: each process's slice of a dataset, and the
merge of per-process results.

Counterpart of `robustvlm_tpu/parallel/multihost.py`: each process owns a
contiguous slice of the dataset chosen by its rank, computes its results,
and the merge is an all-gather of JSON payloads over the process group
(`dist.all_gather_object`; the reference's DDP eval merge). The rank and
world size come from `torch.distributed` when a process group is
initialized, else 0 and 1, so a single process sees the identity.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

import numpy as np
import torch.distributed as dist


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    return dist.get_rank() if _grouped() else 0


def _world() -> int:
    return dist.get_world_size() if _grouped() else 1


def process_shard_bounds(n: int, process_index: int | None = None,
                         process_count: int | None = None) -> tuple:
    """[start, stop) of this process's contiguous dataset slice. The first
    `n % P` processes take one extra example: every example is covered
    exactly once."""
    p = _world() if process_count is None else process_count
    i = _rank() if process_index is None else process_index
    if not 0 <= i < p:
        raise ValueError(f"process_index {i} not in [0, {p})")
    base, extra = divmod(n, p)
    start = i * base + min(i, extra)
    stop = start + base + (1 if i < extra else 0)
    return start, stop


def process_shard_indices(n: int, process_index: int | None = None,
                          process_count: int | None = None) -> np.ndarray:
    start, stop = process_shard_bounds(n, process_index, process_count)
    return np.arange(start, stop)


def all_gather_results(local: Dict) -> List[Dict]:
    """Every process's result dict, in rank order, on every process. Values
    must be JSON-like host data; numpy arrays become lists. One process
    goes through the same JSON round trip, so callers see one value shape
    at any world size; under a process group (even of one process) the
    payloads go through `all_gather_object`."""

    def clean(v):
        if isinstance(v, (np.ndarray, np.generic)):
            return np.asarray(v).tolist()
        return v

    payload = json.dumps({k: clean(v) for k, v in local.items()})
    if not _grouped():
        return [json.loads(payload)]
    gathered: List = [None] * _world()
    dist.all_gather_object(gathered, payload)
    return [json.loads(p) for p in gathered]


def merge_metric_means(locals_: Sequence[Dict[str, float]],
                       counts: Sequence[int]) -> Dict[str, float]:
    """Count-weighted mean of per-process metric dicts."""
    total = sum(counts)
    out: Dict[str, float] = {}
    for key in locals_[0]:
        out[key] = float(sum(d[key] * c for d, c in zip(locals_, counts)) / max(total, 1))
    return out
