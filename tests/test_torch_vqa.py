"""The port's VQA evals (robustvlm_tpu_torch.vlm_eval: the VQA metrics,
`VQADataset`, `vqa_layout_for_dir`, `evaluate_vqa` and the CLI's VQA
branches, `--tokenizer_path`) against the JAX package's.

Strings go through both metric modules exactly (the OK-VQA stemmer on both
of its branches); dataset items are equal with images bit-equal;
`evaluate_vqa` at test-tiny, with JAX's seed-0 weights carried across and
float32 adapters on both sides, gives the same answers and accuracy under
`--attack none`; the ensemble runs all 9 VQA stages."""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from robustvlm_tpu.models.llava.model import LLAVA_CONFIGS as J_CONFIGS
from robustvlm_tpu.models.llava.model import init_llava_params
from robustvlm_tpu.vlm_eval import datasets as JD
from robustvlm_tpu.vlm_eval import eval_models as JM
from robustvlm_tpu.vlm_eval import run_evaluation as JR
from robustvlm_tpu.vlm_eval.metrics import ok_vqa as JOK
from robustvlm_tpu.vlm_eval.metrics import vqa_accuracy as JA
from robustvlm_tpu_torch.models.llava.convert import params_from_jax
from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS, Llava
from robustvlm_tpu_torch.vlm_eval import datasets as PD
from robustvlm_tpu_torch.vlm_eval import eval_models as PM
from robustvlm_tpu_torch.vlm_eval import run_evaluation as PR
from robustvlm_tpu_torch.vlm_eval.metrics import ok_vqa as POK
from robustvlm_tpu_torch.vlm_eval.metrics import vqa_accuracy as PA

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def jax_pil_transform(monkeypatch):
    """Both packages' datasets on their PIL transforms (the same code):
    these tests hold answers and images of the two equal whether or not
    a C++ compiler is at hand (tests/test_torch_native_image.py holds the
    C++ transforms equal)."""
    from robustvlm_tpu.data.loaders import default_image_transform
    from robustvlm_tpu_torch.data import loaders as port_loaders
    from robustvlm_tpu_torch.vlm_eval import datasets as port_datasets

    monkeypatch.setattr(JD, "default_image_transform",
                        lambda size: default_image_transform(size, prefer_native=False))
    port_pil = port_loaders.default_image_transform
    monkeypatch.setattr(port_datasets, "default_image_transform",
                        lambda size: port_pil(size, prefer_native=False))

WORDS = ["a", "an", "the", "two", "Ten", "none", "dont", "cant", "isnt", "Im", "dog's", "3,000", "1.5",
         "yes.", "no!", "U.S.", "red-ish", "(blue)", "cats;", "running", "jumped", "boxes", "it's",
         "hello/world", "@home", "x_y", "50%", "ok?", "Question", "Answer", "Short answer", "\n"]


def _strings(n, seed):
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(WORDS, rng.randint(1, 5))) for _ in range(n)]


def test_vqa_metric_functions_equal_jax():
    preds = _strings(200, 0)
    gts = [_strings(10, 1 + i) for i in range(200)]
    for p, g in zip(preds, gts):
        assert PA.normalize_answer(p) == JA.normalize_answer(p)
        assert PA.postprocess_vqa_generation(p) == JA.postprocess_vqa_generation(p)
        assert PA.vqa_accuracy(p, g) == JA.vqa_accuracy(p, g)
    # some predictions must score: take an annotator's answer as the prediction
    results = [{"question_id": i, "answer": g[i % 3] if i % 2 else p}
               for i, (p, g) in enumerate(zip(preds, gts))]
    anns = dict(enumerate(gts))
    got = PA.compute_vqa_accuracy(results, anns, return_individual_scores=True)
    assert got == JA.compute_vqa_accuracy(results, anns, return_individual_scores=True)
    assert got[0] > 0


def _fallback_stem(path, name, monkeypatch):
    """The module's `_stem` as it is defined when nltk does not import."""
    monkeypatch.setitem(sys.modules, "nltk", None)
    monkeypatch.setitem(sys.modules, "nltk.stem", None)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.delitem(sys.modules, "nltk")
    monkeypatch.delitem(sys.modules, "nltk.stem")
    return mod._stem


@pytest.mark.parametrize("branch", ["nltk", "fallback"])
def test_ok_vqa_postprocess_equal_jax(branch, monkeypatch):
    if branch == "fallback":
        jstem = _fallback_stem(ROOT / "robustvlm_tpu/vlm_eval/metrics/ok_vqa.py", "_jax_okvqa", monkeypatch)
        pstem = _fallback_stem(ROOT / "robustvlm_tpu_torch/vlm_eval/metrics/ok_vqa.py", "_port_okvqa",
                               monkeypatch)
        assert jstem("running") == pstem("running") == "runn"  # the suffix stripper, not Porter
        monkeypatch.setattr(JOK, "_stem", jstem)
        monkeypatch.setattr(POK, "_stem", pstem)
    else:
        pytest.importorskip("nltk", reason="the nltk branch needs nltk")
        assert POK._stem("running") == JOK._stem("running") == "run"
    for s in _strings(300, 7):
        assert POK.postprocess_ok_vqa_generation(s) == JOK.postprocess_ok_vqa_generation(s)


def _vqa_fixture(root: Path, layout: str = "vqav2"):
    """3 questions on 2 images (2 on the first), 10 annotator answers each;
    COCO-style names for vqav2 (the second image without its prefix, read
    by the bare-name fallback), bare ids for textvqa."""
    img_dir = root / ("val2014" if layout == "vqav2" else "images")
    img_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    for k, iid in enumerate((7, 11)):
        name = (f"COCO_val2014_{iid:012d}.jpg" if k == 0 else f"{iid:012d}.jpg") if layout == "vqav2" \
            else f"{iid}.jpg"
        Image.fromarray(rng.randint(0, 255, (40, 48, 3), np.uint8)).save(img_dir / name)
    qs = [{"question_id": 70, "image_id": 7, "question": "what color is the sky?"},
          {"question_id": 71, "image_id": 7, "question": "how many dogs?"},
          {"question_id": 110, "image_id": 11, "question": "is it raining?"}]
    answers = {70: ["blue"] * 6 + ["gray"] * 3 + ["white"], 71: ["2", "two", "2", "3"] + ["2"] * 6,
               110: ["no"] * 5 + ["yes"] * 5}
    qf, af = root / "questions.json", root / "annotations.json"
    qf.write_text(json.dumps({"questions": qs}))
    af.write_text(json.dumps({"annotations": [
        {"question_id": q, "answers": [{"answer": a} for a in ans]} for q, ans in answers.items()]}))
    return img_dir, qf, af


@pytest.mark.parametrize("which_gt", [0, 1, {"70": 2, "110": 1}])
def test_vqa_dataset_items_equal_jax(tmp_path, which_gt):
    img_dir, qf, af = _vqa_fixture(tmp_path)
    kw = dict(size=32, which_gt=which_gt, **PR.vqa_layout_for_dir("vqav2", str(img_dir)))
    p, j = PD.VQADataset(str(img_dir), str(qf), str(af), **kw), JD.VQADataset(str(img_dir), str(qf), str(af), **kw)
    assert len(p) == len(j) == 3
    for i in range(3):
        a, b = p[i], j[i]
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["image"], b["image"])
        assert {k: v for k, v in a.items() if k != "image"} == {k: v for k, v in b.items() if k != "image"}


@pytest.mark.parametrize("name, image_dir", [
    ("vqav2", "/d/val2014"), ("vqav2", "/d/train2014"), ("ok_vqa", "/d/test2015"), ("vqav2", "/d/imgs"),
    ("textvqa", "/d/train_images"), ("vizwiz", "/d/val2014")])
def test_vqa_layout_for_dir_equals_jax(name, image_dir):
    assert PR.vqa_layout_for_dir(name, image_dir) == JR.vqa_layout_for_dir(name, image_dir)
    assert PR.VQA_LAYOUTS == JR.VQA_LAYOUTS


def _argv(img_dir, qf, af, out, *flags, dataset="vqav2"):
    return ["--model", "llava", "--model_size", "test-tiny", f"--eval_{dataset}",
            f"--{dataset}_image_dir", str(img_dir), f"--{dataset}_questions", str(qf),
            f"--{dataset}_annotations", str(af), "--max_new_tokens", "3", "--out_base_path", str(out),
            *flags]


@pytest.fixture(scope="module")
def tiny():
    """JAX's seed-0 test-tiny tree and the port model holding the same weights."""
    tree = init_llava_params(jax.random.PRNGKey(0), J_CONFIGS["test-tiny"])
    return tree, Llava.from_state(LLAVA_CONFIGS["test-tiny"], params_from_jax(jax.tree.map(np.asarray, tree)))


def _float32_adapters(monkeypatch, tiny, tokenizer=None):
    """Both CLIs' adapters in float32 over the same weights, whatever the
    precision: every stage of either side computes the same function."""
    tree, model = tiny
    monkeypatch.setattr(JR, "build_eval_model", lambda args, prec: JM.LlavaEvalModel(
        tree, J_CONFIGS["test-tiny"], tokenizer or JR._tokenizer(args), compute_dtype=jnp.float32))
    monkeypatch.setattr(PR, "build_eval_model", lambda args, prec, models=None: PM.LlavaEvalModel(
        model, tokenizer or PR._tokenizer(args), compute_dtype=torch.float32))


def _answers(out_dir):
    state = json.loads((out_dir / "ensemble_state.json").read_text())
    return state["best_outputs"], state["best_scores"]


@pytest.mark.parametrize("dataset", ["vqav2", "ok_vqa"])
def test_evaluate_vqa_clean_equals_jax(tmp_path, monkeypatch, tiny, dataset):
    """--attack none: the same answers, per-question scores and accuracy.
    One question's annotators give the model's own clean answer, so the
    accuracy is not 0."""
    img_dir, qf, af = _vqa_fixture(tmp_path)
    _float32_adapters(monkeypatch, tiny)
    p_args = PR.build_parser().parse_args(
        ["--device", "cpu", *_argv(img_dir, qf, af, tmp_path / "port", "--attack", "none", dataset=dataset)])
    first = PD.VQADataset(str(img_dir), str(qf), str(af), size=32,
                          **PR.vqa_layout_for_dir(dataset, str(img_dir)))[0]
    adapter = PR.build_eval_model(p_args, "half")
    clean = adapter.get_outputs(torch.from_numpy(first["image"][None]),
                                [adapter.get_vqa_prompt(first["question"])], max_new_tokens=3)[0]
    anns = json.loads(af.read_text())
    anns["annotations"][0]["answers"][:4] = [{"answer": clean}] * 4
    af.write_text(json.dumps(anns))

    got = PR.evaluate_vqa(p_args, dataset, models={})
    j_args = JR.build_parser().parse_args(_argv(img_dir, qf, af, tmp_path / "jax", "--attack", "none",
                                                dataset=dataset))
    ref = JR.evaluate_vqa(j_args, dataset)
    p_out, p_scores = _answers(tmp_path / "port" / dataset)
    j_out, j_scores = _answers(tmp_path / "jax" / dataset)
    assert p_out == j_out and set(p_out) == {"70", "71", "110"}
    assert p_scores == j_scores
    assert got["vqa_accuracy"] == ref["vqa_accuracy"] > 0
    assert got["attack_iters"] == 0


def test_evaluate_vqa_ensemble_runs_every_stage(tmp_path, tiny):
    """--attack ensemble --targeted at threshold -inf: the clean pass, 5 gt
    stages, 'maybe', 'Word' and the float32 prev-best stage, on the CLI's own
    two models; every question under its own id."""
    img_dir, qf, af = _vqa_fixture(tmp_path)
    args = PR.build_parser().parse_args(
        ["--device", "cpu", *_argv(img_dir, qf, af, tmp_path / "out", "--attack", "ensemble", "--n_iter",
                                   "2", "--targeted", "--target_str", "maybe", "--num_samples", "2")])
    schedule = PR.attack_schedule(args, "vqa")
    assert [(s.kind, s.precision, s.targeted, s.target_str) for s in schedule][5:] == [
        ("apgd", "half", True, "maybe"), ("apgd", "half", True, "maybe"), ("apgd", "half", True, "Word"),
        ("apgd", "full", True, "maybe")]
    models = PR.build_llava_models(args, {s.precision for s in schedule}, torch.device("cpu"))
    res = PR.evaluate_vqa(args, "vqav2", models=models, threshold=-float("inf"))
    state = json.loads((tmp_path / "out" / "vqav2" / "ensemble_state.json").read_text())
    assert state["stages_done"] == len(schedule) == 9
    assert len(state["ids"]) == 2 and set(state["best_outputs"]) == set(state["ids"]) <= {"70", "71", "110"}
    assert res["attack_iters"] == 8 * 2 * 2
    assert 0.0 <= res["success_rate"] <= 1.0 and np.isfinite(res["vqa_accuracy"])
    for qid in state["ids"]:
        adv = np.load(tmp_path / "out" / "vqav2" / "adv" / f"{qid}.npy")
        assert adv.shape == (3, 32, 32) and 0.0 <= adv.min() <= adv.max() <= 1.0


def test_cli_trials_means_over_vqa_keys(tmp_path):
    img_dir, qf, af = _vqa_fixture(tmp_path, "textvqa")
    res = PR.main(["--device", "cpu", *_argv(img_dir, qf, af, tmp_path / "out", "--attack", "none",
                                             "--num_trials", "2", "--num_samples", "2",
                                             dataset="textvqa")])
    trials = [res[f"textvqa_shots0_trial{t}"] for t in (0, 1)]
    mean = res["textvqa_shots0_mean"]
    assert set(mean) == {"vqa_accuracy", "wall_s", "attack_s", "attack_iters"}
    assert mean["vqa_accuracy"] == float(np.nanmean([t["vqa_accuracy"] for t in trials]))
    assert json.loads((tmp_path / "out" / "results.json").read_text())["textvqa_shots0_mean"] == mean


def test_cli_open_flamingo_vqa_two_shots(tmp_path):
    """OpenFlamingo VQA with 2 demo images a question: without train files
    the demos come from the eval files, warned; a demo pool without
    annotator answers is refused."""
    img_dir, qf, af = _vqa_fixture(tmp_path)
    argv = _argv(img_dir, qf, af, tmp_path / "out", "--attack", "apgd", "--n_iter", "1", "--shots", "2",
                 "--num_samples", "2")
    argv[argv.index("llava")] = "open_flamingo"
    with pytest.warns(UserWarning, match="few-shot demos are drawn from the EVAL files"):
        res = PR.main(["--device", "cpu", *argv])
    assert res["vqav2_shots2"]["attack_iters"] == 2 and np.isfinite(res["vqav2_shots2"]["vqa_accuracy"])
    adv = np.load(next((tmp_path / "out" / "vqav2_shots2" / "adv").glob("*.npy")))
    assert adv.shape == (3, 1, 3, 32, 32)  # 2 demo frames + the query
    empty = tmp_path / "no_answers.json"
    empty.write_text(json.dumps({"annotations": []}))
    with pytest.raises(ValueError, match="no annotator answers"):
        PR.main(["--device", "cpu", *argv, "--vqav2_train_questions", str(qf),
                 "--vqav2_train_annotations", str(empty)])


def _word_tokenizer_dir(root: Path, with_pad: bool = True) -> Path:
    """A word-level HF tokenizer saved with `save_pretrained`, made on the
    spot from the prompts' words."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    text = (PM.get_vqa_prompt("what color is the sky? how many dogs? is it raining?", "blue")
            + " two 2 no yes gray white red")
    vocab = {"[PAD]": 0, "<s>": 1, "</s>": 2, "[UNK]": 3}
    for w, _ in pre_tokenizers.Whitespace().pre_tokenize_str(text):
        vocab.setdefault(w, len(vocab))
    tk = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    kw = dict(bos_token="<s>", eos_token="</s>", unk_token="[UNK]")
    if with_pad:
        kw["pad_token"] = "[PAD]"
    out = root / ("tok" if with_pad else "tok_nopad")
    PreTrainedTokenizerFast(tokenizer_object=tk, **kw).save_pretrained(str(out))
    return out


def test_tokenizer_path_equals_jax(tmp_path, monkeypatch, tiny):
    """The same ids from both CLIs' tokenizers, the pad falling back to EOS,
    and the same VQA result with the tokenizer in place of the hash one."""
    pytest.importorskip("transformers", reason="--tokenizer_path needs transformers")
    tok_dir = _word_tokenizer_dir(tmp_path)
    img_dir, qf, af = _vqa_fixture(tmp_path)
    flags = ["--attack", "none", "--tokenizer_path", str(tok_dir)]
    p_args = PR.build_parser().parse_args(["--device", "cpu", *_argv(img_dir, qf, af, tmp_path / "port", *flags)])
    j_args = JR.build_parser().parse_args(_argv(img_dir, qf, af, tmp_path / "jax", *flags))
    ptok, jtok = PR._tokenizer(p_args), JR._tokenizer(j_args)
    text = PM.get_vqa_prompt("how many dogs?", "2")
    assert ptok.encode(text, add_special_tokens=False) == jtok.encode(text, add_special_tokens=False)
    assert (ptok.bos_token_id, ptok.eos_token_id, ptok.pad_token_id) == \
        (jtok.bos_token_id, jtok.eos_token_id, jtok.pad_token_id) == (1, 2, 0)
    p_args.tokenizer_path = j_args.tokenizer_path = str(_word_tokenizer_dir(tmp_path, with_pad=False))
    assert PR._tokenizer(p_args).pad_token_id == JR._tokenizer(j_args).pad_token_id == 2
    p_args.tokenizer_path = j_args.tokenizer_path = str(tok_dir)

    _float32_adapters(monkeypatch, tiny)
    got, ref = PR.evaluate_vqa(p_args, "vqav2", models={}), JR.evaluate_vqa(j_args, "vqav2")
    p_out, _ = _answers(tmp_path / "port" / "vqav2")
    assert p_out == _answers(tmp_path / "jax" / "vqav2")[0]
    assert all(not o.startswith("tok") for o in p_out.values())  # decoded words, not hash tokens
    assert got["vqa_accuracy"] == ref["vqa_accuracy"]


def test_tokenizer_path_without_transformers_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    args = PR.build_parser().parse_args(["--tokenizer_path", "some/dir"])
    with pytest.raises(ImportError, match="transformers"):
        PR._tokenizer(args)
