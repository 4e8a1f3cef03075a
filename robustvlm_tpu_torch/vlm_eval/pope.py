"""POPE hallucination evaluation (generation loop and scorer), on the card.

Counterpart of `robustvlm_tpu/vlm_eval/pope.py`: answers are binarized (any
of no / not / No in the first sentence gives 'no', else 'yes') and scored as
precision, recall, F1, accuracy and the yes-ratio, per POPE category file.

  python -m robustvlm_tpu_torch.vlm_eval.pope --model llava \\
      --pope_questions coco_pope_random.jsonl --image_root /data/coco/val2014
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import torch


def binarize_answer(text: str) -> str:
    if "." in text:
        text = text.split(".")[0]
    words = text.replace(",", "").split(" ")
    return "no" if ("No" in words or "not" in words or "no" in words) else "yes"


def eval_pope(answers: List[Dict], labels: List[str]) -> Dict[str, float]:
    """answers: [{'question_id', 'text'}] aligned to labels ('yes'/'no')."""
    pred = [1 if binarize_answer(a["text"]) == "yes" else 0 for a in answers]
    gold = [0 if lab == "no" else 1 for lab in labels]
    tp = sum(1 for p, g in zip(pred, gold) if p == 1 and g == 1)
    fp = sum(1 for p, g in zip(pred, gold) if p == 1 and g == 0)
    tn = sum(1 for p, g in zip(pred, gold) if p == 0 and g == 0)
    fn = sum(1 for p, g in zip(pred, gold) if p == 0 and g == 1)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return {
        "TP": tp, "FP": fp, "TN": tn, "FN": fn,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "accuracy": (tp + tn) / max(len(pred), 1),
        "yes_ratio": sum(pred) / max(len(pred), 1),
    }


def load_pope_questions(path: str) -> List[Dict]:
    """POPE question jsonl: {'question_id', 'image', 'text', 'label'?}."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def run_pope(eval_model, questions: List[Dict], image_root: str, *, size: int = 224,
             max_new_tokens: int = 16, attack_fn=None,
             answers_path: Optional[str] = None) -> Dict[str, float]:
    """Generate an answer per question and score them; `attack_fn(model, x,
    question) -> x_adv` runs the threat model before generation."""
    from PIL import Image

    from robustvlm_tpu_torch.data.loaders import default_image_transform

    tf = default_image_transform(size)
    answers = []
    for q in questions:
        with Image.open(Path(image_root) / q["image"]) as img:
            x = torch.from_numpy(tf(img))[None].to(eval_model.device)
        prompt = eval_model.get_vqa_prompt(q["text"], None)
        if attack_fn is not None:
            x = attack_fn(eval_model, x, q)
        text = eval_model.get_outputs(x, [prompt], max_new_tokens=max_new_tokens)[0]
        answers.append({"question_id": q["question_id"], "text": text})
    if answers_path:
        with open(answers_path, "w") as f:
            for a in answers:
                f.write(json.dumps(a) + "\n")
    return eval_pope(answers, [q.get("label", "yes") for q in questions])


def main(argv=None):
    """Generate answers and score precision / recall / F1 / yes-ratio in one
    pass, with the float32 adapter `run_evaluation` builds."""
    import argparse

    from robustvlm_tpu_torch.device import resolve_device, use_full_fp32
    from robustvlm_tpu_torch.vlm_eval.run_evaluation import add_model_args, build_eval_model

    p = argparse.ArgumentParser(description="POPE hallucination eval (PyTorch/CUDA)")
    add_model_args(p)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--pope_questions", required=True,
                   help="POPE questions jsonl (question_id/image/text/label)")
    p.add_argument("--image_root", required=True)
    p.add_argument("--answers_path", default="")
    p.add_argument("--max_new_tokens", type=int, default=16)
    p.add_argument("--image_size", type=int, default=224)
    args = p.parse_args(argv)
    resolve_device(args.device)
    use_full_fp32()

    model = build_eval_model(args, "full")
    metrics = run_pope(model, load_pope_questions(args.pope_questions), args.image_root,
                       size=args.image_size, max_new_tokens=args.max_new_tokens,
                       answers_path=args.answers_path or None)
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
