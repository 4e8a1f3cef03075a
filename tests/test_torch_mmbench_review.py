"""The port's MMBench eval and pairwise review (robustvlm_tpu_torch.vlm_eval.
mmbench, .gpt_review) against the JAX package's on the same fixtures: the
TSV rows, options, rotations, prompts (English and Chinese), parsed
choices, the answer records and the circular scores of scripted models;
review rows, their JSONL and the summary with the heuristic judge and with a
scripted one; `mmbench.main` end to end at test-tiny on the CPU."""

import base64
import csv
import io
import json

import numpy as np
import pytest
from PIL import Image

from robustvlm_tpu.vlm_eval import gpt_review as JR
from robustvlm_tpu.vlm_eval import mmbench as JM
from robustvlm_tpu_torch.vlm_eval import gpt_review as PR
from robustvlm_tpu_torch.vlm_eval import mmbench as PM

ROWS = [
    {"index": "1", "question": "What color is the sky?", "hint": "", "answer": "B", "A": "green",
     "B": "blue", "C": "red", "D": ""},
    {"index": "2", "question": "How many legs has a cat?", "hint": "Count them.", "answer": "D",
     "A": "two", "B": "three", "C": "zero", "D": "four"},
]


def _tsv(tmp_path):
    rng = np.random.RandomState(0)
    rows = []
    for r in ROWS:
        buf = io.BytesIO()
        Image.fromarray(rng.randint(0, 255, (20, 24, 3), np.uint8)).save(buf, format="PNG")
        rows.append({**r, "image": base64.b64encode(buf.getvalue()).decode()})
    p = tmp_path / "mmbench.tsv"
    with open(p, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t")
        w.writeheader()
        w.writerows(rows)
    return p


def test_rows_options_prompts_equal_jax(tmp_path):
    p = _tsv(tmp_path)
    rows = PM.load_mmbench_tsv(str(p))
    assert rows == JM.load_mmbench_tsv(str(p))
    for row in rows:
        opts = PM.get_options(row)
        assert opts == JM.get_options(row)
        for r in range(len(opts) + 1):
            assert PM.rotate(opts, r) == JM.rotate(opts, r)
            for lang in ("en", "cn"):
                args = (row["question"], PM.rotate(opts, r), row["hint"])
                assert PM.build_prompt(*args, lang=lang) == JM.build_prompt(*args, lang=lang)
    assert PM.get_options(rows[0]) == ["green", "blue", "red"]


@pytest.mark.parametrize("text", ["B", "The answer is (C).", "D", "no idea", "a, b. c", "**A**", ""])
@pytest.mark.parametrize("n", [3, 4])
def test_parse_choice_equals_jax(text, n):
    assert PM.parse_choice(text, n) == JM.parse_choice(text, n)


class _Scripted:
    """Answers the letter of `pick(options in the prompt)`; `device` None."""

    def __init__(self, pick):
        self.pick = pick

    def get_vqa_prompt(self, q, a=None):
        return f"<image>{q}"

    def get_outputs(self, x, prompts, max_new_tokens=8):
        assert x.shape[0] == 1
        opts = [ln.split(". ", 1) for ln in prompts[0].splitlines() if ln[:1] in "ABCD" and ln[1:3] == ". "]
        return [self.pick(opts)]


ORACLE = _Scripted(lambda opts: next(c for c, t in opts if t in ("blue", "four")))
ALWAYS_A = _Scripted(lambda opts: "A")


@pytest.mark.parametrize("model", [ORACLE, ALWAYS_A], ids=["oracle", "always_a"])
@pytest.mark.parametrize("all_rounds", [True, False])
def test_records_and_circular_scores_equal_jax(tmp_path, model, all_rounds):
    rows = PM.load_mmbench_tsv(str(_tsv(tmp_path)))
    decode = lambda b64, size: PM.decode_image(b64, size)  # noqa: E731 (the same pixels both sides)
    kw = dict(size=16, all_rounds=all_rounds, image_decode=decode)
    got = PM.run_mmbench(model, rows, answers_file=str(tmp_path / "p.jsonl"), **kw)
    ref = JM.run_mmbench(model, rows, answers_file=str(tmp_path / "j.jsonl"), **kw)
    assert got == ref
    assert (tmp_path / "p.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    assert PM.eval_mmbench(got) == JM.eval_mmbench(ref)
    if model is ORACLE:
        assert PM.eval_mmbench(got)["circular_accuracy"] == 100.0
    assert len(got) == (7 if all_rounds else 2)


def test_reads_an_image_field_past_the_csv_default_limit(tmp_path):
    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(1).randint(0, 255, (300, 300, 3), np.uint8)).save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    assert len(b64) > 131072
    p = tmp_path / "big.tsv"
    p.write_text("index\tquestion\timage\n0\tq\t" + b64 + "\n")
    assert PM.load_mmbench_tsv(str(p))[0]["image"] == b64


def test_decode_image_is_the_port_transform(tmp_path):
    from robustvlm_tpu_torch.data.loaders import default_image_transform

    row = PM.load_mmbench_tsv(str(_tsv(tmp_path)))[0]
    x = PM.decode_image(row["image"], 16)
    img = Image.open(io.BytesIO(base64.b64decode(row["image"])))
    assert x.shape == (3, 16, 16) and x.dtype == np.float32
    np.testing.assert_array_equal(x, default_image_transform(16)(img))


def test_mmbench_cli_on_cpu(tmp_path):
    p = _tsv(tmp_path)
    ans = tmp_path / "out" / "answers.jsonl"
    m = PM.main(["--device", "cpu", "--model", "llava", "--model_size", "test-tiny", "--mmbench_tsv", str(p),
                 "--answers_file", str(ans), "--image_size", "32", "--max_new_tokens", "4"])
    assert set(m) == {"accuracy", "circular_accuracy", "n_questions"} and m["n_questions"] == 2
    assert len(ans.read_text().splitlines()) == 7


QUESTIONS = [{"question_id": 1, "text": "describe the red apple", "category": "default"},
             {"question_id": 2, "text": "what is on the table", "category": "detail"},
             {"question_id": 3, "text": "is it raining", "category": "default"}]
ANS1 = [{"question_id": 1, "text": "the red apple is round"}, {"question_id": 2, "text": "a cup"},
        {"question_id": 3, "text": ""}]
ANS2 = [{"question_id": 1, "text": "banana"}, {"question_id": 2, "text": "on the table a cup is"}]


@pytest.mark.parametrize("judge", ["heuristic", "scripted"])
def test_review_and_summary_equal_jax(tmp_path, judge):
    def scripted(system, content):
        return "7, 9\nscripted" if "apple" in content else "garbage"

    kw = {} if judge == "heuristic" else {"judge_fn": scripted}
    got = PR.review_answers(QUESTIONS, ANS1, ANS2, contexts={2: "a kitchen"},
                            output_path=str(tmp_path / "p" / "review.jsonl"), **kw)
    ref = JR.review_answers(QUESTIONS, ANS1, ANS2, contexts={2: "a kitchen"},
                            output_path=str(tmp_path / "j" / "review.jsonl"), **kw)
    assert got == ref and len(got) == 2  # question 3 has one answer: no row
    assert (tmp_path / "p" / "review.jsonl").read_text() == (tmp_path / "j" / "review.jsonl").read_text()
    assert PR.summarize_reviews(got) == JR.summarize_reviews(ref)
    if judge == "heuristic":
        assert got[0]["tuple"][0] > got[0]["tuple"][1]


@pytest.mark.parametrize("review", ["7 9\nreason", "8.5, 3\n", "garbage", "", "10 -1 extra"])
def test_parse_score_and_judge_equal_jax(review):
    assert PR.parse_score(review) == JR.parse_score(review)
    content = f"[Question]\nq a\n\n[Assistant 1]\n{review}\n[End of Assistant 1]\n\n" \
              "[Assistant 2]\nq\n[End of Assistant 2]\n"
    assert PR.heuristic_judge("s", content) == JR.heuristic_judge("s", content)
