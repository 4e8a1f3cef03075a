"""The port's bench runner (`scripts/bench_torch.py`) on the CPU at
test-tiny size: the headline and FARE stages' JSON lines, the LLaVA attack
stage, a failing stage's null line (the later stages still run, the run
exits 1), the watchdog, the memory release between stages, and
`scripts/perf_sweep_torch.py`'s configs."""

import gc
import json
import subprocess
import sys
import weakref
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import bench_torch  # noqa: E402

torch.set_num_threads(2)


def _lines(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_headline_stage_line_and_eps_ball(capsys):
    line = bench_torch.main("cpu", batch=2, n_iter=4, model_name="test-tiny", runs=2)
    printed = _lines(capsys.readouterr().out)
    assert printed == [json.loads(json.dumps(line))]
    assert line["metric"] == "apgd_attack_steps_per_sec_per_chip_vitl14"
    assert line["unit"] == "example-steps/s/chip"
    assert line["value"] == pytest.approx(2 * 5 / min(line["run_s"]))
    assert line["vs_baseline"] == pytest.approx(line["value"] / 80.0)
    assert len(line["run_s"]) == 2 and line["n_iter"] == 4 and line["batch"] == 2
    assert 0.0 < line["linf_max"] <= 2.0 / 255.0 + 1e-6
    assert line["layout"].startswith("cast_matrices_")
    # on the CPU: no card, no calibration, the kernels' plain versions
    assert line["card"] is None and "matmul_calibration_tf_s" not in line
    assert line["launches"] == {}


def test_headline_with_folded_normalization(capsys):
    line = bench_torch.main("cpu", batch=2, n_iter=2, model_name="test-tiny", runs=1, fold_norm=True)
    capsys.readouterr()
    assert line["fold_norm"] and line["value"] > 0
    assert line["linf_max"] <= 2.0 / 255.0 + 1e-6


def test_fare_train_stage_line(capsys):
    line = bench_torch.main_train("cpu", batch=4, accum=2, n_steps=1, model_name="test-tiny")
    capsys.readouterr()
    assert line["metric"] == "fare_train_imgs_per_sec_per_chip_vitl14"
    assert line["unit"] == "imgs/s/chip"
    assert line["value"] == pytest.approx(4 / line["s_per_step"])
    assert line["vs_baseline"] == pytest.approx(line["value"] / 6.7)
    assert line["grad_accum"] == 2 and line["steps"] == 1
    assert line["loss"] >= 0.0


def test_llava_attack_stage_line(capsys):
    import bench_llava7b_torch

    line = bench_llava7b_torch.main(batch=1, n_iter=2, device="cpu", config="test-tiny",
                                    compute_dtype=torch.float32)
    capsys.readouterr()
    assert line["metric"] == "apgd_attack_steps_per_sec_llava7b_b1"
    assert line["value"] == pytest.approx(3 / min(line["run_s"]))
    assert line["vs_baseline"] == pytest.approx(line["example_steps_per_sec"] / 1.4)
    assert line["linf_max"] <= 2.0 / 255.0 + 1e-6
    assert line["executed_matmul_tflop_per_step"] > line["model_tflop_per_step"] > 0  # remat's replay
    assert line["serial_chain_at_lm_mlp_shape_tf_s"] > 0


def test_failing_stage_prints_null_and_the_run_exits_1(monkeypatch, capsys):
    ran = []

    def ok(name):
        def fn(*a, **k):
            ran.append(name)
            print(json.dumps({"metric": name, "value": 1.0}))
        return fn

    def boom(*a, **k):
        ran.append("llava")
        raise RuntimeError("out of memory, simulated")

    monkeypatch.setattr(bench_torch, "main_llava", boom)
    monkeypatch.setattr(bench_torch, "main_train", ok("train"))
    monkeypatch.setattr(bench_torch, "main_decode", ok("decode"))
    monkeypatch.setattr(bench_torch, "main", ok(bench_torch.HEADLINE))
    monkeypatch.delenv("BENCH_TRAIN", raising=False)
    monkeypatch.delenv("BENCH_ATTACK_ONLY", raising=False)
    monkeypatch.setenv("BENCH_LLAVA", "1")
    monkeypatch.setenv("BENCH_DECODE", "1")
    assert bench_torch.run_all("cpu") == 1
    lines = _lines(capsys.readouterr().out)
    assert ran == ["llava", "train", "decode", "decode", "decode", bench_torch.HEADLINE]
    assert lines[0] == {"metric": "apgd_attack_steps_per_sec_llava7b_b1", "value": None, "unit": None,
                        "error": "stage failed: RuntimeError: out of memory, simulated"}
    assert lines[-1]["metric"] == bench_torch.HEADLINE and lines[-1]["value"] == 1.0
    assert bench_torch.FAILED == ["apgd_attack_steps_per_sec_llava7b_b1"]

    # every stage passing: exit 0, headline last
    monkeypatch.setattr(bench_torch, "main_llava", ok("llava"))
    assert bench_torch.run_all("cpu") == 0
    assert _lines(capsys.readouterr().out)[-1]["metric"] == bench_torch.HEADLINE


def test_cli_without_gpu_raises_before_any_stage(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench_torch, "run_all", lambda device: pytest.fail("a stage ran"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.cli([])


def test_watchdog_prints_and_exits_nonzero():
    code = (f"import sys, time; sys.path.insert(0, {str(ROOT / 'scripts')!r}); import bench_torch; "
            "bench_torch._watchdog(0.2); time.sleep(30)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 3
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == bench_torch.HEADLINE and line["value"] is None
    assert "no measurement within 0s" in line["error"]


def test_stage_releases_the_stage_model():
    """A stage's model kept alive only by a reference cycle (as autograd
    graphs and closures make them) is gone once `_stage` returns."""
    from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS

    refs = []

    def stage():
        model = CLIP(CLIP_CONFIGS["test-tiny"])
        model.cycle = [model]  # a reference cycle: refcounting alone does not free it
        refs.append(weakref.ref(model))

    gc.disable()
    try:
        bench_torch._stage("m", stage)
        assert refs[0]() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("name", ["b8", "b8_remat", "b8_fwdonly", "b8_foldnorm", "b8_noattn"])
def test_perf_sweep_configs_run_at_test_tiny(name, capsys):
    import perf_sweep_torch

    batch, knobs = perf_sweep_torch.CONFIGS[name]
    line = perf_sweep_torch.run_one(name, 2, dict(knobs), "cpu", k=2, model_name="test-tiny")
    assert _lines(capsys.readouterr().out) == [json.loads(json.dumps(line))]
    assert line["config"] == name and line["k"] == 2 and line["knobs"] == knobs
    assert line["example_steps_per_sec"] == pytest.approx(2 * 2 / (line["ms_per_eval"] * 2 / 1e3))
    # the ablation restores the model's attention
    import robustvlm_tpu_torch.models.clip.model as M
    from robustvlm_tpu_torch.ops.kernels.vit_attention import vit_attention_qkv

    assert M.vit_attention_qkv is vit_attention_qkv
