"""The port's AutoAttack cascade and robustbench CLI against the JAX package.

APGD-CE + APGD-T on tiny CLIP (same weights both sides, use_rs=False, labels
from the clean predictions): the robust-accuracy dict and the per-example
robust flags must equal JAX `AutoAttackTPU`'s. The eps values give mixed
outcomes (some examples fooled, some not).
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.attacks import apgd as japgd
from robustvlm_tpu.eval.autoattack import AutoAttackTPU
from robustvlm_tpu.eval.classifier import build_text_classifier as jax_build_text_classifier
from robustvlm_tpu.eval.classifier import make_zero_shot_classifier as jax_zero_shot
from robustvlm_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS
from robustvlm_tpu.models.clip import init_clip_params
from robustvlm_tpu.models.clip.tokenizer import HashTokenizer as JaxHashTokenizer
from robustvlm_tpu.ops.losses import ce_loss as jax_ce_loss
from robustvlm_tpu.ops.losses import dlr_loss as jax_dlr_loss
from robustvlm_tpu_torch.attacks import apgd as tapgd
from robustvlm_tpu_torch.eval import checks, robustbench
from robustvlm_tpu_torch.eval.autoattack import AutoAttack
from robustvlm_tpu_torch.eval.classifier import build_text_classifier, make_zero_shot_classifier
from robustvlm_tpu_torch.eval.state import EvaluationState
from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, params_from_jax
from robustvlm_tpu_torch.models.clip.tokenizer import HashTokenizer
from robustvlm_tpu_torch.ops.losses import ce_loss, dlr_loss

torch.set_num_threads(1)

CLASSES = ["airplane", "automobile", "bird", "cat", "deer", "dog", "frog", "horse", "ship", "truck"]


@pytest.fixture(scope="module")
def pair():
    """The same tiny zero-shot classifier in both frameworks, 8 images and
    their clean predictions as labels."""
    cfg = JAX_CONFIGS["test-tiny"]
    jp = init_clip_params(jax.random.PRNGKey(0), cfg)
    model = CLIP(CLIP_CONFIGS["test-tiny"])
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
    jt, tt = JaxHashTokenizer(512, 16), HashTokenizer(512, 16)
    jtemb = jax_build_text_classifier(jp, cfg, lambda t: jnp.asarray(jt(t)), CLASSES)
    ttemb = build_text_classifier(model, lambda t: torch.from_numpy(tt(t)).long(), CLASSES)
    np.testing.assert_allclose(ttemb.numpy(), np.asarray(jtemb), atol=1e-5, rtol=1e-5)
    jfn = jax_zero_shot(jp, cfg, jtemb)
    tfn = make_zero_shot_classifier(model, ttemb)
    x = np.random.RandomState(0).rand(8, 3, 32, 32).astype(np.float32)
    y = np.asarray(jnp.argmax(jfn(jnp.asarray(x)), -1))
    assert np.array_equal(tfn(torch.from_numpy(x)).argmax(-1).numpy(), y)
    return jfn, tfn, x, y


@pytest.mark.parametrize("eps", [1.2, 1.5])
def test_apgd_ce_t_cascade_matches_jax(pair, eps):
    jfn, tfn, x, y = pair
    kw = dict(eps=eps / 255, attacks_to_run=["apgd-ce", "apgd-t"], n_iter=10,
              use_rs=False, verbose=False)
    ja = AutoAttackTPU(jfn, **kw)
    jx, jy = ja.run_standard_evaluation(jnp.asarray(x), jnp.asarray(y), bs=8, return_labels=True)
    ta = AutoAttack(tfn, device="cpu", **kw)
    tx, ty = ta.run_standard_evaluation(x, y, bs=8, return_labels=True)
    assert ta.robust_accuracy_dict == ja.robust_accuracy_dict
    assert 0.0 < ta.robust_accuracy_dict["apgd-t"] < 1.0  # a mixed outcome
    assert np.array_equal(ty.numpy() != y, np.asarray(jy) != y)
    assert float((tx - torch.from_numpy(x)).abs().max()) <= eps / 255 + 1e-6


@pytest.mark.parametrize("loss", ["ce", "dlr"])
def test_apgd_on_tiny_clip_matches_jax_outcomes(pair, loss):
    """Through a model, sign() turns last-bit gradient differences into
    different valid trajectories, so outcomes are compared: the robust
    flags exactly and loss_best at 1e-4."""
    jfn, tfn, x, y = pair
    jcrit = {"ce": lambda o, yy: jax_ce_loss(o, yy, reduction="none"), "dlr": jax_dlr_loss}[loss]
    tcrit = {"ce": lambda o, yy: ce_loss(o, yy, reduction="none"), "dlr": dlr_loss}[loss]
    kw = dict(eps=1.5 / 255, n_iter=10, norm="linf")
    ref = japgd.apgd_attack(jfn, jnp.asarray(x), jnp.asarray(y), criterion=jcrit, **kw)
    got = tapgd.apgd_attack(tfn, torch.from_numpy(x), torch.tensor(y), criterion=tcrit, **kw)
    assert np.array_equal(got.acc.numpy(), np.asarray(ref.acc))
    assert 0 < int(got.acc.sum()) < 8  # a mixed outcome
    np.testing.assert_allclose(got.loss_best.numpy(), np.asarray(ref.loss_best), atol=1e-4, rtol=1e-4)


def test_state_resume_skips_finished_attack(pair, tmp_path):
    _, tfn, x, y = pair
    sp = tmp_path / "state.json"
    kw = dict(eps=1.5 / 255, attacks_to_run=["apgd-ce"], n_iter=3, verbose=False, device="cpu")
    AutoAttack(tfn, **kw).run_standard_evaluation(x, y, bs=8, state_path=sp)
    st = EvaluationState.from_disk(sp)
    assert st.run_attacks == {"apgd-ce"}
    flags = st.robust_flags.copy()
    AutoAttack(tfn, **kw).run_standard_evaluation(x, y, bs=8, state_path=sp)
    assert np.array_equal(EvaluationState.from_disk(sp).robust_flags, flags)
    EvaluationState({"apgd-t"}, path=sp).to_disk(force=True)
    with pytest.raises(ValueError):
        AutoAttack(tfn, **kw).run_standard_evaluation(x, y, bs=8, state_path=sp)


@pytest.mark.parametrize("attack", ["square", "fab", "fab-t"])
def test_not_ported_attacks_raise_with_queue_item(pair, attack):
    """The name is kept from when Square, FAB and FAB-T raised; they are
    ported now (test_torch_square.py, test_torch_fab.py), so a cascade takes
    them and only an unknown attack is refused."""
    aa = AutoAttack(pair[1], eps=0.01, attacks_to_run=["apgd-ce", attack], device="cpu")
    assert aa.attacks_to_run == ["apgd-ce", attack]
    with pytest.raises(ValueError):
        AutoAttack(pair[1], eps=0.01, attacks_to_run=["pgd"], device="cpu")


def test_default_device_is_cuda_and_raises_without_a_gpu(pair):
    """Like every entry point of the port, AutoAttack runs on the card
    unless asked for the CPU: with no device and no GPU it raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default resolves to cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AutoAttack(pair[1], eps=0.01, attacks_to_run=["apgd-ce"])
    assert AutoAttack(pair[1], eps=0.01, attacks_to_run=["apgd-ce"], device="cpu").device.type == "cpu"


def test_check_dynamic_static_port_model_does_not_warn(pair, caplog):
    """An eager model repeats its Python work on every call; a static one
    gives equal call counts and must not be flagged."""
    _, tfn, x, _ = pair
    with caplog.at_level(logging.WARNING, logger="robustvlm_tpu_torch.autoattack"):
        assert not checks.check_dynamic(tfn, torch.from_numpy(x[:2]))
    assert not caplog.records


def test_check_dynamic_flags_growing_host_work():
    calls = {"n": 0}

    def helper(v):
        return v

    def dynamic(x):
        calls["n"] += 1
        for _ in range(400 * calls["n"]):  # per-call host work that grows
            helper(x)
        return x.reshape(x.shape[0], -1)[:, :4]

    assert checks.check_dynamic(dynamic, torch.ones(2, 3, 4, 4), verbose=False)


def _cli_args(tmp_path, *extra):
    return [
        "--device", "cpu", "--dataset", "synthetic", "--clip_model_name", "test-tiny",
        "--template", "std", "--n_ex", "4", "--attack_batch", "4", "--batch_size", "4",
        "--n_iter", "3", "--eps", "2", "--output_dir", str(tmp_path), *extra,
    ]


def test_robustbench_cli_runs_end_to_end(tmp_path):
    res = robustbench.main(_cli_args(tmp_path, "--labels", "predicted", "--save_adv"))
    written = json.loads((tmp_path / "result.json").read_text())
    assert written["robust_acc"] == res["robust_acc"]
    assert res["clean_acc"] == 1.0  # labels are the clean predictions
    assert 0.0 <= res["robust_acc"] <= 1.0 and res["device"] == "cpu"
    x_adv = np.load(tmp_path / "x_adv.npy")
    assert x_adv.shape == (4, 3, 32, 32) and np.isfinite(x_adv).all()


def test_robustbench_raises_without_gpu_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _cli_args(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        robustbench.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        robustbench.main(argv + ["--device", "cuda"])
