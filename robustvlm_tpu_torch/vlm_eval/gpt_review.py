"""Pairwise answer review (an LLM judge), with a pluggable judge.

Counterpart of `robustvlm_tpu/vlm_eval/gpt_review.py` (the reference's
llava/eval/eval_gpt_review_visual.py and summarize_gpt_review.py): two
assistants' answers to the same visual question are judged against a
per-category rule prompt; each review row records `tuple` = (score_1,
score_2) on a 1-10 scale and the judge's text, and the summary reports the
score-2 / score-1 ratio and the mean scores per category. The judge is
`judge_fn(system_prompt, user_content) -> str`: an API client in
production, `heuristic_judge` (a deterministic local stand-in scoring by
word overlap with the question) offline. The artifacts (review JSONL with
question_id / category / tuple / content, the summary table) keep the
reference's formats. No torch: this module is plain Python and numpy.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

DEFAULT_RULES = {
    # reference rule file (llava/eval/table/rule.json) shape: per-category
    # judging instructions; trimmed to the categories the harness emits
    "default": {
        "role": "Assistant",
        "prompt": (
            "We would like to request your feedback on the performance of "
            "two AI assistants in response to the user question displayed "
            "above. Please rate the helpfulness, relevance, accuracy, level "
            "of details of their responses. Each assistant receives an "
            "overall score on a scale of 1 to 10. Please first output a "
            "single line containing only two values indicating the scores "
            "for Assistant 1 and 2, respectively."
        ),
    },
}


def parse_score(review: str) -> List[float]:
    """First line '<s1> <s2>' -> [s1, s2]; [-1, -1] when unparsable
    (reference eval_gpt_review_visual.parse_score)."""
    try:
        line = review.split("\n")[0].replace(",", " ")
        nums = re.findall(r"-?\d+(?:\.\d+)?", line)
        if len(nums) >= 2:
            return [float(nums[0]), float(nums[1])]
    except Exception:
        pass
    return [-1.0, -1.0]


def heuristic_judge(system_prompt: str, content: str) -> str:
    """Deterministic offline stand-in: scores by token overlap with the
    question plus a brevity-balanced length prior. NOT a quality metric —
    it exists to exercise the pipeline without API access."""
    del system_prompt
    m = re.search(
        r"\[Question\]\n(.*?)\n.*?"
        r"\[Assistant 1\]\n(.*?)\n\[End of Assistant 1\].*?"
        r"\[Assistant 2\]\n(.*?)\n\[End of Assistant 2\]",
        content, re.S,
    )
    if not m:
        return "-1 -1\nunparsable content"
    q, a1, a2 = (set(s.lower().split()) for s in m.groups())

    def score(a):
        if not a:
            return 1.0
        overlap = len(q & a) / max(len(q), 1)
        return round(min(10.0, 1.0 + 9.0 * overlap), 1)

    return f"{score(a1)} {score(a2)}\nheuristic offline judge"


def review_answers(
    questions: Sequence[Dict],
    answers1: Sequence[Dict],
    answers2: Sequence[Dict],
    *,
    contexts: Optional[Dict] = None,
    rules: Optional[Dict] = None,
    judge_fn: Callable[[str, str], str] = heuristic_judge,
    output_path: Optional[str] = None,
) -> List[Dict]:
    """One review row per question (reference :66-113): builds the
    [Context]/[Question]/[Assistant k] content, calls the judge, parses the
    score tuple."""
    rules = rules or DEFAULT_RULES
    rows = []
    by_id1 = {a["question_id"]: a for a in answers1}
    by_id2 = {a["question_id"]: a for a in answers2}
    for q in questions:
        qid = q["question_id"]
        a1, a2 = by_id1.get(qid), by_id2.get(qid)
        if a1 is None or a2 is None:
            continue
        category = q.get("category", "default")
        rule = rules.get(category, rules["default"])
        ctx = (contexts or {}).get(qid, "")
        content = (
            f"[Context]\n{ctx}\n\n"
            f"[Question]\n{q['text']}\n\n"
            f"[Assistant 1]\n{a1['text']}\n[End of Assistant 1]\n\n"
            f"[Assistant 2]\n{a2['text']}\n[End of Assistant 2]\n\n"
            f"[System]\n{rule['prompt']}\n"
        )
        review = judge_fn(
            f"You are a helpful and precise assistant for checking the "
            f"quality of the answer. {rule.get('role', '')}",
            content,
        )
        rows.append({
            "question_id": qid,
            "category": category,
            "content": review,
            "tuple": parse_score(review),
        })
    if output_path:
        Path(output_path).parent.mkdir(parents=True, exist_ok=True)
        with open(output_path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


def summarize_reviews(rows: Sequence[Dict]) -> Dict[str, Dict[str, float]]:
    """Per-category relative score (reference summarize_gpt_review.py:55-58:
    ratio = mean(score2)/mean(score1) x100, plus the x10 mean scores)."""
    scores = defaultdict(list)
    for r in rows:
        t = r.get("tuple", [-1, -1])
        if t[0] < 0:
            continue
        scores[r.get("category", "all")].append(t)
        scores["all"].append(t)
    out = {}
    for k, v in scores.items():
        m = np.asarray(v).mean(0)
        out[k] = {
            "relative": round(float(m[1] / m[0] * 100), 1),
            "score1": round(float(m[0] * 10), 1),
            "score2": round(float(m[1] * 10), 1),
            "n": len(v),
        }
    return out
