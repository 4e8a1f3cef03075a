"""ScienceQA multiple-choice evaluation (generation loop and scorer), on the card.

Counterpart of `robustvlm_tpu/vlm_eval/science_qa.py`: an answer is parsed
as an option letter (the bare letter, an 'X. ...' prefix, or 'The answer is
X.'), mapped to a choice index (a failed parse picks a seeded pseudo-random
choice), and scored as overall and image-question accuracy.

  python -m robustvlm_tpu_torch.vlm_eval.science_qa --model llava \\
      --problems problems.json --split_file pid_splits.json --image_root test/
"""

from __future__ import annotations

import json
import random
import re
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

OPTIONS = ["A", "B", "C", "D", "E"]
_ANSWER_PATTERN = re.compile(r"The answer is ([A-E]).")


def parse_option(pred_text: str, options: Sequence[str] = OPTIONS) -> str:
    if pred_text in options:
        return pred_text
    if len(pred_text) >= 3 and pred_text[0] in options and pred_text[1:3] == ". ":
        return pred_text[0]
    res = _ANSWER_PATTERN.findall(pred_text)
    if len(res) == 1:
        return res[0]
    return "FAILED"


def get_pred_idx(answer: str, choices: Sequence, options: Sequence[str] = OPTIONS) -> int:
    """Option letter -> choice index; a failed parse picks from the global
    `random` stream, which `eval_science_qa` seeds."""
    if answer in options[: len(choices)]:
        return options.index(answer)
    return random.choice(range(len(choices)))


def eval_science_qa(predictions: Dict[str, Dict], problems: Dict[str, Dict],
                    split_ids: Sequence[str], seed: int = 0) -> Dict[str, float]:
    """predictions: {question_id: {'text', 'prompt'}}; problems:
    {question_id: {'choices', 'answer'}}."""
    random.seed(seed)
    correct = incorrect = 0
    mm_correct = mm_total = 0
    per_question = {}
    for qid in split_ids:
        prob = problems[qid]
        pred = predictions.get(qid, {"text": "FAILED", "prompt": ""})
        idx = get_pred_idx(parse_option(pred["text"]), prob["choices"])
        ok = idx == prob["answer"]
        per_question[qid] = idx
        correct += int(ok)
        incorrect += int(not ok)
        if "<image>" in pred.get("prompt", ""):
            mm_total += 1
            mm_correct += int(ok)
    total = correct + incorrect
    return {
        "total": total,
        "correct": correct,
        "acc": 100.0 * correct / max(total, 1),
        "img_acc": 100.0 * mm_correct / max(mm_total, 1),
        "results": per_question,
    }


def build_sqa_prompt(problem: Dict, include_image: bool) -> str:
    """Question, lettered choices and the answer instruction."""
    lines = [problem.get("question", "")] + [
        f"{OPTIONS[i]}. {c}" for i, c in enumerate(problem.get("choices", []))]
    prompt = "\n".join(lines) + "\nAnswer with the option's letter from the given choices directly."
    return "<image>\n" + prompt if include_image else prompt


def run_science_qa(model, problems: Dict[str, Dict], split_ids: Sequence[str],
                   image_root: Optional[str] = None, *, size: int = 224,
                   max_new_tokens: int = 8) -> Dict[str, float]:
    """Generate an answer per question and score them. A problem with an
    `image` loads `<image_root>/<qid>/<image>`; a text-only one runs on a
    zero image (the adapter always takes pixels)."""
    from PIL import Image

    from robustvlm_tpu_torch.data.loaders import default_image_transform

    predictions = {}
    for qid in split_ids:
        prob = problems[qid]
        has_image = bool(prob.get("image")) and image_root is not None
        if has_image:
            with Image.open(Path(image_root) / str(qid) / prob["image"]) as img:
                x = torch.from_numpy(default_image_transform(size)(img))[None]
        else:
            x = torch.zeros(1, 3, size, size)
        prompt_q = build_sqa_prompt(prob, include_image=has_image)
        text = model.get_outputs(
            x.to(model.device), [model.get_vqa_prompt(prompt_q.replace("<image>\n", ""), None)],
            max_new_tokens=max_new_tokens)[0]
        predictions[qid] = {"text": text, "prompt": prompt_q}
    return eval_science_qa(predictions, problems, split_ids)


def main(argv=None):
    """Answer and score one split with the float32 adapter `run_evaluation`
    builds."""
    import argparse

    from robustvlm_tpu_torch.device import resolve_device, use_full_fp32
    from robustvlm_tpu_torch.vlm_eval.run_evaluation import add_model_args, build_eval_model

    p = argparse.ArgumentParser(description="ScienceQA eval (PyTorch/CUDA)")
    add_model_args(p)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--problems", required=True, help="problems.json")
    p.add_argument("--split_file", default="", help="pid_splits.json")
    p.add_argument("--split", default="test")
    p.add_argument("--image_root", default="")
    p.add_argument("--max_new_tokens", type=int, default=8)
    p.add_argument("--image_size", type=int, default=224)
    args = p.parse_args(argv)
    resolve_device(args.device)
    use_full_fp32()

    problems = json.loads(Path(args.problems).read_text())
    split_ids = (json.loads(Path(args.split_file).read_text())[args.split] if args.split_file
                 else list(problems))
    model = build_eval_model(args, "full")
    metrics = run_science_qa(model, problems, split_ids, args.image_root or None,
                             size=args.image_size, max_new_tokens=args.max_new_tokens)
    metrics = {k: v for k, v in metrics.items() if k != "results"}
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
