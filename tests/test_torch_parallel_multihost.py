"""The port's multi-process eval helpers (robustvlm_tpu_torch.parallel.
multihost) against the JAX package's (the counterpart of
tests/test_parallel.py's TestMultihost): the shard bounds' coverage and
balance, the single-process identity, a 3-rank gloo gather of payloads of
different lengths (exact), and scripts/multihost_smoke_torch.py under 2
gloo ranks, each in a FileStore group with a 60 s collective timeout, the
parent killing its children on expiry."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from robustvlm_tpu.parallel import multihost as JH
from robustvlm_tpu_torch.parallel import multihost as H

from _torch_parallel_workers import run_world

ROOT = Path(__file__).resolve().parents[1]


def test_shard_bounds_cover_exactly_and_match_jax():
    for n in (0, 1, 7, 16, 100):
        for p in (1, 2, 3, 8):
            all_idx = np.concatenate([H.process_shard_indices(n, i, p) for i in range(p)])
            np.testing.assert_array_equal(all_idx, np.arange(n))
            sizes = [H.process_shard_bounds(n, i, p)[1] - H.process_shard_bounds(n, i, p)[0] for i in range(p)]
            assert max(sizes) - min(sizes) <= 1
            for i in range(p):
                assert H.process_shard_bounds(n, i, p) == JH.process_shard_bounds(n, i, p)
    with pytest.raises(ValueError):
        H.process_shard_bounds(4, 2, 2)


def test_single_process_gather_identity():
    local = {"acc": 0.5, "ids": np.asarray([1, 2])}
    assert H.all_gather_results(local) == [{"acc": 0.5, "ids": [1, 2]}] == JH.all_gather_results(local)
    assert H.process_shard_bounds(5) == (0, 5)
    m = H.merge_metric_means([{"acc": 0.25}, {"acc": 0.75}], [1, 3])
    assert m["acc"] == pytest.approx(0.625)
    assert m == JH.merge_metric_means([{"acc": 0.25}, {"acc": 0.75}], [1, 3])


def test_three_rank_gather_of_uneven_payloads_is_exact(tmp_path):
    sizes = [3, 70, 1]
    ranks = run_world(tmp_path, 3, "gather_world", sizes=sizes)
    n = sum(sizes)
    want = [{"rank": r, "ids": list(range(*JH.process_shard_bounds(n, r, 3))), "text": "x" * sizes[r],
             "acc": r / 2} for r in range(3)]
    counts = [len(w["ids"]) for w in want]
    for r, got in enumerate(ranks):
        assert got["merged"] == want
        assert got["indices"] == want[r]["ids"]
        assert got["means"] == JH.merge_metric_means([{"acc": w["acc"]} for w in want], counts)


def test_multihost_smoke_script_passes_on_two_gloo_ranks(tmp_path):
    env = {**os.environ, "WORLD_SIZE": "2", "PYTHONPATH": str(ROOT)}
    cmd = [sys.executable, str(ROOT / "scripts" / "multihost_smoke_torch.py"), "--device", "cpu",
           "--store", str(tmp_path / "store"), "--timeout_s", "60"]
    procs = [subprocess.Popen(cmd, env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], outs
    for r, out in enumerate(outs):
        assert f"[smoke] process {r}: PASS" in out, out
        assert "FAIL" not in out
