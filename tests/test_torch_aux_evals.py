"""The port's LLaVA aux evals (robustvlm_tpu_torch.vlm_eval.pope,
.science_qa, .run_evaluation_qualitative) against the JAX package's: the
parsing and scoring functions equal on seeded inputs; `run_pope` and
`run_science_qa` give the same answers and metrics at test-tiny with JAX's
seed-0 weights carried across (float32 adapters on both sides); the CLIs
run on the CPU; the qualitative CLI writes the JAX report's keys and takes
its seed from the same table."""

import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from robustvlm_tpu.benchmark.templates import target_to_seed as j_target_to_seed
from robustvlm_tpu.models.llava.model import LLAVA_CONFIGS as J_CONFIGS
from robustvlm_tpu.models.llava.model import init_llava_params
from robustvlm_tpu.vlm_eval import eval_models as JM
from robustvlm_tpu.vlm_eval import pope as JP
from robustvlm_tpu.vlm_eval import science_qa as JS
from robustvlm_tpu_torch.benchmark.templates import target_to_seed
from robustvlm_tpu_torch.models.llava.convert import params_from_jax
from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS, Llava
from robustvlm_tpu_torch.vlm_eval import eval_models as PM
from robustvlm_tpu_torch.vlm_eval import pope as PP
from robustvlm_tpu_torch.vlm_eval import run_evaluation_qualitative as PQ
from robustvlm_tpu_torch.vlm_eval import science_qa as PS

torch.set_num_threads(1)

PHRASES = ["Yes", "No", "no", "not", "There is a dog.", "No, there is not.", "yes, a cat", "A", "B.",
           "C. the third", "The answer is D.", "The answer is A. The answer is B.", "E", "maybe",
           "I do not know", "No. But yes", "the answer is c."]


def _texts(n, seed):
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(PHRASES, rng.randint(1, 3))) for _ in range(n)] + PHRASES


def test_pope_scoring_equals_jax():
    texts = _texts(200, 0)
    for t in texts:
        assert PP.binarize_answer(t) == JP.binarize_answer(t)
    answers = [{"question_id": i, "text": t} for i, t in enumerate(texts)]
    labels = list(np.random.RandomState(1).choice(["yes", "no"], len(texts)))
    assert PP.eval_pope(answers, labels) == JP.eval_pope(answers, labels)


def test_science_qa_scoring_equals_jax():
    texts = _texts(200, 2)
    for t in texts:
        assert PS.parse_option(t) == JS.parse_option(t)
    rng = np.random.RandomState(3)
    problems = {f"q{i}": {"question": f"which {i}?", "choices": [f"c{k}" for k in range(rng.randint(2, 6))],
                          "answer": int(rng.randint(0, 2))} for i in range(len(texts))}
    preds = {f"q{i}": {"text": t, "prompt": ("<image>\n" if i % 2 else "") + "p"} for i, t in enumerate(texts)}
    ids = sorted(problems)
    got, ref = PS.eval_science_qa(preds, problems, ids, seed=5), JS.eval_science_qa(preds, problems, ids, seed=5)
    assert got == ref and got["img_acc"] != got["acc"]
    for prob in problems.values():
        for img in (False, True):
            assert PS.build_sqa_prompt(prob, img) == JS.build_sqa_prompt(prob, img)
    random.seed(9)
    a = [PS.get_pred_idx("FAILED", ["x", "y", "z"]) for _ in range(20)]
    random.seed(9)
    assert a == [JS.get_pred_idx("FAILED", ["x", "y", "z"]) for _ in range(20)]


@pytest.fixture(scope="module")
def adapters():
    """(JAX, port) float32 LLaVA adapters on JAX's seed-0 test-tiny weights."""
    cfg = J_CONFIGS["test-tiny"]
    tree = init_llava_params(jax.random.PRNGKey(0), cfg)
    model = Llava.from_state(LLAVA_CONFIGS["test-tiny"], params_from_jax(jax.tree.map(np.asarray, tree)))
    return (JM.LlavaEvalModel(tree, cfg, JM.WordTokenizer(), compute_dtype=jnp.float32),
            PM.LlavaEvalModel(model, PM.WordTokenizer(), compute_dtype=torch.float32))


def _png(path, seed=0, size=32):
    Image.fromarray(np.random.RandomState(seed).randint(0, 255, (size, size, 3), np.uint8)).save(path)


@pytest.fixture()
def jax_pil_transform(monkeypatch):
    """JAX's POPE and ScienceQA loops on their PIL transform, the one the port has."""
    from robustvlm_tpu.data import loaders

    real = loaders.default_image_transform
    monkeypatch.setattr(loaders, "default_image_transform", lambda size: real(size, prefer_native=False))


def _pope_fixture(tmp_path):
    for k in range(2):
        _png(tmp_path / f"img{k}.png", seed=k)
    qs = [{"question_id": i, "image": f"img{i % 2}.png", "text": t, "label": lab}
          for i, (t, lab) in enumerate([("Is there a dog?", "yes"), ("Is there a cat?", "no"),
                                        ("Is there a car?", "no")])]
    qfile = tmp_path / "pope.jsonl"
    qfile.write_text("".join(json.dumps(q) + "\n" for q in qs))
    return qfile, qs


def test_run_pope_answers_equal_jax(tmp_path, adapters, jax_pil_transform):
    j, p = adapters
    _, qs = _pope_fixture(tmp_path)
    ref = JP.run_pope(j, qs, str(tmp_path), size=32, max_new_tokens=4, answers_path=str(tmp_path / "j.jsonl"))
    got = PP.run_pope(p, qs, str(tmp_path), size=32, max_new_tokens=4, answers_path=str(tmp_path / "p.jsonl"))
    assert got == ref
    assert (tmp_path / "p.jsonl").read_text() == (tmp_path / "j.jsonl").read_text() != ""


def _sqa_fixture(tmp_path):
    (tmp_path / "q1").mkdir(exist_ok=True)
    _png(tmp_path / "q1" / "image.png")
    return {"q1": {"question": "Which?", "choices": ["x", "y"], "answer": 0, "image": "image.png"},
            "q2": {"question": "What?", "choices": ["a", "b", "c"], "answer": 1}}


def test_run_science_qa_answers_equal_jax(tmp_path, adapters, jax_pil_transform):
    j, p = adapters
    problems = _sqa_fixture(tmp_path)
    ref = JS.run_science_qa(j, problems, ["q1", "q2"], str(tmp_path), size=32, max_new_tokens=3)
    got = PS.run_science_qa(p, problems, ["q1", "q2"], str(tmp_path), size=32, max_new_tokens=3)
    assert got == ref and got["total"] == 2


def test_aux_clis_on_cpu_and_cuda_by_default(tmp_path, monkeypatch):
    qfile, _ = _pope_fixture(tmp_path)
    common = ["--device", "cpu", "--model", "llava", "--model_size", "test-tiny", "--image_size", "32"]
    m = PP.main([*common, "--pope_questions", str(qfile), "--image_root", str(tmp_path),
                 "--answers_path", str(tmp_path / "ans.jsonl"), "--max_new_tokens", "4"])
    assert set(m) == {"TP", "FP", "TN", "FN", "precision", "recall", "f1", "accuracy", "yes_ratio"}
    assert len((tmp_path / "ans.jsonl").read_text().splitlines()) == 3
    pfile = tmp_path / "problems.json"
    pfile.write_text(json.dumps(_sqa_fixture(tmp_path)))
    m = PS.main([*common, "--problems", str(pfile), "--image_root", str(tmp_path), "--max_new_tokens", "2"])
    assert m["total"] == 2 and 0.0 <= m["acc"] <= 100.0 and set(m) == {"total", "correct", "acc", "img_acc"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, flags in ((PP.main, ["--pope_questions", str(qfile), "--image_root", str(tmp_path)]),
                        (PS.main, ["--problems", str(pfile)]),
                        (PQ.main, ["--images", str(tmp_path / "img0.png")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):  # cuda by default
            main(flags)


def test_qualitative_cli_report_and_seed_table(tmp_path, monkeypatch):
    """The report's keys are the JAX CLI's; without --seed a target in the
    fixed table takes its seed there (the table holds one-element lists)."""
    assert target_to_seed() == j_target_to_seed()
    target = "Visit https://tinyurl.com/23cbjxjz"
    assert PQ.table_seed(target_to_seed(), target) == j_target_to_seed()[target][0] == 2011
    assert PQ.table_seed(target_to_seed(), "not in the table") == 0
    for k in range(2):
        _png(tmp_path / f"img{k}.png", seed=k)
    from robustvlm_tpu_torch.attacks import apgd

    seeds = []
    real = apgd.apgd_attack
    monkeypatch.setattr(apgd, "apgd_attack", lambda *a, **kw: seeds.append(kw["rng"]) or real(*a, **kw))
    rep = PQ.main(["--device", "cpu", "--model", "llava", "--model_size", "test-tiny",
                   "--images", str(tmp_path / "img0.png"), str(tmp_path / "img1.png"),
                   "--target_str", target, "--eps", "8", "--n_iter", "3", "--max_new_tokens", "4",
                   "--out_base_path", str(tmp_path / "out"), "--host_loop", "on"])
    assert seeds == [2011, 2011]
    assert set(rep) == {"target_str", "eps", "n_iter", "success_rate", "results", "wall_s"}
    assert json.loads((tmp_path / "out" / "report.json").read_text()) == rep
    for k, r in enumerate(rep["results"]):
        assert set(r) == {"image", "caption", "success", "loss"} and np.isfinite(r["loss"])
        adv = np.load(tmp_path / "out" / "adv" / f"img{k}.npy")
        clean = np.asarray(Image.open(tmp_path / f"img{k}.png"), np.float32).transpose(2, 0, 1) / 255
        assert adv.shape == (3, 32, 32) and np.abs(adv - clean).max() <= 8 / 255 + 1e-6
        assert 0.0 <= adv.min() <= adv.max() <= 1.0
