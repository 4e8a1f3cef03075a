"""The port's AutoAttack versions and stages, the robustbench CLI's flags and
the model zoo against the JAX package.

- The `standard`, `plus` and `rand` versions give JAX's attack lists and
  presets (restarts, target classes, EOT draws, decr-eps) in each norm.
- A cascade with every stage runs on the CPU on a tiny linear classifier in
  each norm: robust accuracy never rises along it, x_adv stays in the ball
  and in [0,1], and every example counted as fooled is fooled when re-run.
- `robustbench.main` with the new flags gives JAX `main`'s result keys (and
  three the port adds: `labels`, `compute_dtype`, `device`).
- `model_zoo.run_zoo` and `format_table` give JAX's results and table on a
  directory holding one written test-tiny checkpoint; a ConvNeXt row with a
  checkpoint runs.
"""

import json
import logging
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from robustvlm_tpu.eval import model_zoo as jzoo
from robustvlm_tpu.eval import robustbench as jrb
from robustvlm_tpu.eval.autoattack import AutoAttackTPU
from robustvlm_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS
from robustvlm_tpu.models.clip import init_clip_params
from robustvlm_tpu_torch.eval import model_zoo as tzoo
from robustvlm_tpu_torch.eval import robustbench as trb
from robustvlm_tpu_torch.eval.autoattack import AutoAttack
from robustvlm_tpu_torch.eval.classifier import accuracy
from robustvlm_tpu_torch.ops.projections import l1_norm, l2_norm, linf_norm

from test_torch_robustbench_dtype import openai_state_dict

torch.set_num_threads(1)

PRESETS = ("attacks_to_run", "n_restarts", "n_target_classes", "eot_iter", "use_largereps")


@pytest.mark.parametrize("version", ["standard", "plus", "rand"])
@pytest.mark.parametrize("norm", ["linf", "l2", "l1"])
def test_versions_match_jax(version, norm):
    def fn(x):
        return x
    ja = AutoAttackTPU(fn, norm=norm, eps=0.1, version=version, eot_iter=3)
    ta = AutoAttack(fn, norm=norm, eps=0.1, version=version, eot_iter=3, device="cpu")
    assert {k: getattr(ta, k) for k in PRESETS} == {k: getattr(ja, k) for k in PRESETS}
    with pytest.raises(ValueError):
        AutoAttack(fn, eps=0.1, version=version, attacks_to_run=["apgd-ce"], device="cpu")


def test_rand_version_warns_without_a_random_model(caplog):
    with caplog.at_level(logging.WARNING, logger="robustvlm_tpu_torch.autoattack"):
        AutoAttack(lambda x: x, eps=0.1, version="rand", device="cpu")
    assert any("EOT" in r.getMessage() for r in caplog.records)


def _linear(seed=0, n=6, n_cls=10, size=16):
    r = np.random.RandomState(seed)
    x = (r.rand(n, 3, size, size) * 0.6 + 0.2).astype(np.float32)
    w = torch.from_numpy((r.randn(3 * size * size, n_cls) * 0.05).astype(np.float32))

    def fn(a):
        return a.reshape(a.shape[0], -1) @ w
    y = fn(torch.from_numpy(x)).argmax(-1).numpy()
    return x, y, fn


NORMS = {"linf": (1 / 255, linf_norm), "l2": (0.1, l2_norm), "l1": (0.5, l1_norm)}
ALL_STAGES = ["apgd-ce", "apgd-dlr", "fab", "square", "apgd-t", "fab-t"]


@pytest.mark.parametrize("norm", ["linf", "l2", "l1"])
def test_every_stage_runs_in_a_cpu_cascade(norm):
    eps, size = NORMS[norm]
    x, y, fn = _linear()
    aa = AutoAttack(fn, norm=norm, eps=eps, attacks_to_run=ALL_STAGES, n_iter=5, n_target_classes=3,
                    square_n_queries=30, verbose=False, device="cpu")
    x_adv, y_adv = aa.run_standard_evaluation(x, y, bs=4, return_labels=True)
    racc = aa.robust_accuracy_dict
    assert list(racc)[0] == "clean" and racc["clean"] == 1.0
    vals = list(racc.values())
    assert all(b <= a for a, b in zip(vals, vals[1:]))
    assert list(racc)[1:] == ALL_STAGES[: len(racc) - 1]
    d = x_adv - torch.from_numpy(x)
    tol = 1e-6 if norm == "linf" else eps * 1e-5
    assert bool((size(d) <= eps + tol).all())
    assert float(x_adv.min()) >= -1e-6 and float(x_adv.max()) <= 1 + 1e-6
    fooled = fn(x_adv).argmax(-1).numpy() != y
    assert np.array_equal(fooled, y_adv.numpy() != y)
    assert np.isclose(1.0 - fooled.mean(), min(vals))
    assert accuracy(fn, x_adv, torch.from_numpy(y), batch_size=4) == pytest.approx(1.0 - fooled.mean())


def _rb_args(out, *extra):
    return ["--dataset", "synthetic", "--clip_model_name", "test-tiny", "--template", "std", "--n_ex", "4",
            "--attack_batch", "4", "--batch_size", "4", "--n_iter", "2", "--output_dir", str(out), *extra]


@pytest.mark.parametrize("extra", [
    ["--norm", "l2", "--eps", "127.5", "--full_benchmark", "--remat", "dots", "--host_loop",
     "--experiment_name", "breadth"],
    ["--norm", "l1", "--eps", "3060", "--attacks", "apgd-ce,square", "--remat", "full"],
])
def test_robustbench_new_flags_give_the_jax_result_keys(tmp_path, extra):
    ref = jrb.main(_rb_args(tmp_path / "jax", *extra))
    got = trb.main(_rb_args(tmp_path / "port", *extra, "--device", "cpu"))
    assert set(got) == set(ref) | {"labels", "compute_dtype", "device"}
    for k in ("model", "dataset", "n_ex", "eps", "norm"):
        assert got[k] == ref[k]
    summary = [json.loads(line) for line in (tmp_path / "port" / "metrics.jsonl").read_text().splitlines()]
    assert summary[-1]["summary/robust_acc"] == got["robust_acc"]


def test_robustbench_full_benchmark_runs_the_standard_cascade(tmp_path):
    res = trb.main(_rb_args(tmp_path, "--device", "cpu", "--labels", "predicted", "--full_benchmark",
                            "--eps", "0.5", "--norm", "linf"))
    stages = [k for k in res["cascade"] if k != "clean"]
    assert stages == ["apgd-ce", "apgd-t", "fab-t", "square"][: len(stages)] and stages


def test_robustbench_reads_an_imagenet_folder(tmp_path):
    root = tmp_path / "imagenet"
    r = np.random.RandomState(0)
    for c in ("n01", "n02"):
        (root / "val" / c).mkdir(parents=True)
        for i in range(2):
            Image.fromarray((r.rand(40, 48, 3) * 255).astype(np.uint8)).save(root / "val" / c / f"{i}.png")
    args = trb.build_parser().parse_args(_rb_args(tmp_path / "o", "--dataset", "imagenet", "--imagenet_root",
                                                  str(root), "--n_ex", "3", "--batch_size", "2"))
    x, y = trb.load_data(args, 32)
    assert x.shape == (3, 3, 32, 32) and y.tolist() == [0, 0, 1]
    res = trb.main(_rb_args(tmp_path / "o", "--device", "cpu", "--dataset", "imagenet", "--imagenet_root",
                            str(root), "--n_ex", "3"))
    assert res["n_ex"] == 3 and "rb/acc-img" in res


def _zoo_entry(mod):
    return mod.ZooEntry("fare4-tiny", "test-tiny", "openai", (48.6, 40.6, 33.7, 21.9))


def test_model_zoo_matches_jax(tmp_path, monkeypatch):
    cfg = JAX_CONFIGS["test-tiny"]
    tree = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(3), cfg))
    ckpts = tmp_path / "ckpts"
    ckpts.mkdir()
    torch.save(openai_state_dict(tree, cfg), ckpts / "fare4-tiny.pt")
    monkeypatch.setattr(jzoo, "ZOO", [_zoo_entry(jzoo)] + jzoo.ZOO)
    monkeypatch.setattr(tzoo, "ZOO", [_zoo_entry(tzoo)] + tzoo.ZOO)
    argv = ["--ckpt_dir", str(ckpts), "--dataset", "synthetic", "--n_ex", "4", "--batch_size", "4",
            "--n_iter", "2", "--eps", "2"]
    ref = jzoo.run_zoo(jzoo.build_parser().parse_args(argv + ["--output_dir", str(tmp_path / "j")]))
    got = tzoo.run_zoo(tzoo.build_parser().parse_args(argv + ["--output_dir", str(tmp_path / "t"),
                                                              "--device", "cpu"]))
    assert list(got) == list(ref) == ["fare4-tiny"]
    for k in ("clean_acc", "robust_acc", "cascade"):
        assert got["fare4-tiny"][k] == ref["fare4-tiny"][k]
    assert tzoo.format_table(got, 2.0) == jzoo.format_table(ref, 2.0)
    assert [(e.name, e.backbone, e.published) for e in tzoo.ZOO] == [(e.name, e.backbone, e.published)
                                                                     for e in jzoo.ZOO]


def test_model_zoo_convnext_row_raises(tmp_path, monkeypatch):
    """A ConvNeXt row with a written checkpoint runs (the tower is ported;
    the row no longer raises): at tiny size the entry's backbone is
    test-tiny-convnext, its checkpoint an open_clip TimmModel-layout state
    dict written from a JAX tree."""
    cfg = JAX_CONFIGS["test-tiny-convnext"]
    tree = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(5), cfg))
    torch.save(openai_state_dict(tree, cfg), tmp_path / "tecoa4-convnextb-laion2b.pt")
    row = next(e for e in tzoo.ZOO if e.name == "tecoa4-convnextb-laion2b")
    assert row.backbone == "convnext_base_w"
    monkeypatch.setattr(tzoo, "ZOO", [tzoo.ZooEntry(row.name, "test-tiny-convnext", row.pretrain,
                                                    row.published)])
    args = tzoo.build_parser().parse_args(
        ["--ckpt_dir", str(tmp_path), "--device", "cpu", "--dataset", "synthetic", "--n_ex", "4",
         "--batch_size", "4", "--n_iter", "2", "--eps", "2", "--output_dir", str(tmp_path / "out")])
    res = tzoo.run_zoo(args)["tecoa4-convnextb-laion2b"]
    assert 0.0 <= res["robust_acc"] <= res["clean_acc"] <= 1.0
    assert "tecoa4-convnextb-laion2b" in tzoo.format_table({row.name: res}, 2.0)
    assert tzoo.run_zoo(tzoo.build_parser().parse_args(["--ckpt_dir", str(tmp_path / "none")])) == {}
