"""The training CLI (`robustvlm_tpu_torch.train.driver.main`) under a
2-rank gloo process group on the CPU, 2 steps of TeCoA (PGD-2, grad_accum
2, the APGD-50 eval at step 1), against the same argv in one process, and
rank 0 alone writing (the other rank is given another output directory,
which must stay absent).

Tolerances: the global metrics within 1e-6 relative; every parameter
within 2 * lr a step (JAX's bound for one data-parallel step, whose Adam
update is about lr * sign(g), applied to each of the 2 steps); and every
element but the attention key biases within 1e-2 * lr. The key bias has an
exactly-zero gradient in exact arithmetic (softmax ignores a constant
added to every key's score), so Adam steps it by about +-lr on float noise
in either run."""

import json

import numpy as np
import pytest
import torch

from robustvlm_tpu_torch.train import driver

from _torch_parallel_workers import run_world

torch.set_num_threads(1)
LR = 1e-3
STEPS = 2


def _argv(out):
    return ["--device", "cpu", "--clip_model_name", "test-tiny", "--dataset", "synthetic",
            "--batch_size", "8", "--grad_accum", "2", "--steps", str(STEPS), "--warmup", "1", "--lr", str(LR),
            "--loss", "ce", "--inner_loss", "ce", "--attack", "pgd", "--iterations_adv", "2",
            "--output_dir", str(out)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("driver")
    single = driver.main(_argv(root / "single"))
    ranks = run_world(root, 2, "driver_world", argv_by_rank=[_argv(root / f"rank{r}") for r in range(2)])
    return root, single, ranks


def test_dp_driver_matches_single_process(runs):
    root, single, ranks = runs
    ref = {n: p.detach().numpy() for n, p in single.model.named_parameters()}
    for r in ranks:
        assert r["steps"] == STEPS
        for n, v in r["params"].items():
            d = np.abs(v - ref[n])
            assert d.max() < STEPS * 2 * LR, n
            if n.endswith("attn.qkv_b"):
                w = d.shape[0] // 3
                d = np.concatenate([d[:w], d[2 * w:]])  # q and v biases; k is noise-driven
            assert d.max() <= 1e-2 * LR, n
            assert np.array_equal(v, ranks[0]["params"][n]), n  # replicas stay equal
        for k in ("loss", "loss_total", "cos_sim"):
            assert r["metrics"][k] == pytest.approx(single.metrics[k], rel=1e-6), k


def test_dp_driver_writes_from_rank_0_only(runs):
    root, _, _ = runs
    assert not (root / "rank1").exists()
    out = root / "rank0"
    assert json.loads((out / "args.json").read_text())["steps"] == 2
    recs = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2]
    assert sum("eval/racc" in r for r in recs) == 1
    assert (out / "checkpoints" / "final" / "params.pt").exists()
    assert (out / "checkpoints" / "final.pt").exists()
