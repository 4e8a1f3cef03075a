"""MMBench multiple-choice evaluation, on the card.

Counterpart of `robustvlm_tpu/vlm_eval/mmbench.py` (the reference's
llava/eval/model_vqa_mmbench.py): TSV rows carry a base64 image, a
question, an optional hint and options A..D; the prompt lists the options
and ends with the answer-with-the-letter instruction (English or Chinese).
`all_rounds` asks once per cyclic rotation of the options (circular
evaluation); scoring is offline: a question is circular-correct when every
round picks the letter the ground-truth option moved to.

  python -m robustvlm_tpu_torch.vlm_eval.mmbench --model llava \\
      --mmbench_tsv mmbench_dev_en.tsv --answers_file answers.jsonl
"""

from __future__ import annotations

import base64
import csv
import io
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

ALL_OPTIONS = ["A", "B", "C", "D"]
_EN_SUFFIX = "Answer with the option's letter from the given choices directly."
_CN_SUFFIX = "请直接回答选项字母。"


def _is_none(v) -> bool:
    return v is None or str(v).strip().lower() in ("", "none", "nan")


def load_mmbench_tsv(path: str) -> List[Dict]:
    """Rows with keys index / question / hint / answer / A..D / image (base64).
    The csv module's field limit is raised first: an image's base64 field
    passes its default 128 KiB (the JAX reader stops there)."""
    csv.field_size_limit(max(csv.field_size_limit(), 2**31 - 1))
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def decode_image(b64: str, size: int) -> np.ndarray:
    """A base64 image -> float32 (3, size, size) in [0, 1]."""
    from PIL import Image

    from robustvlm_tpu_torch.data.loaders import default_image_transform

    img = Image.open(io.BytesIO(base64.b64decode(b64)))
    return default_image_transform(size)(img)


def get_options(row: Dict) -> List[str]:
    """The row's non-empty options, in letter order."""
    return [str(row[c]) for c in ALL_OPTIONS if not _is_none(row.get(c))]


def rotate(options: Sequence[str], rounds: int) -> List[str]:
    """Cyclic rotation of the options by `rounds`."""
    options = list(options)
    return options[rounds:] + options[:rounds]


def build_prompt(question: str, options: Sequence[str], hint: Optional[str] = None,
                 lang: str = "en", single_pred_prompt: bool = True) -> str:
    q = question if _is_none(hint) else f"{hint}\n{question}"
    for ch, opt in zip(ALL_OPTIONS, options):
        q = f"{q}\n{ch}. {opt}"
    if single_pred_prompt:
        q = f"{q}\n{_CN_SUFFIX if lang == 'cn' else _EN_SUFFIX}"
    return q


def parse_choice(text: str, n_options: int) -> str:
    """The first standalone option letter in the generation; 'FAILED' if none."""
    valid = set(ALL_OPTIONS[:n_options])
    for tok in text.replace(".", " ").replace(",", " ").split():
        t = tok.strip("()*'\"").upper()
        if t in valid:
            return t
    return "FAILED"


def run_mmbench(model, rows: Sequence[Dict], *, size: int = 336, all_rounds: bool = True,
                lang: str = "en", max_new_tokens: int = 8, answers_file: Optional[str] = None,
                image_decode=decode_image) -> List[Dict]:
    """One answer record per (question, round), the reference's answers-JSONL
    rows. `model` follows the adapter contract (get_vqa_prompt, get_outputs);
    the image goes to its `device` when it has one."""
    device = getattr(model, "device", None)
    records = []
    for row in rows:
        options = get_options(row)
        x = torch.from_numpy(image_decode(row["image"], size))[None]
        x = x.to(device) if device is not None else x
        for r in range(len(options) if all_rounds else 1):
            opts = rotate(options, r)
            prompt_q = build_prompt(row["question"], opts, row.get("hint"), lang=lang)
            out = model.get_outputs(x, [model.get_vqa_prompt(prompt_q, None)],
                                    max_new_tokens=max_new_tokens)[0]
            records.append({"question_id": row["index"], "round_id": r, "prompt": prompt_q,
                            "text": out, "options": opts, "option_char": ALL_OPTIONS[:len(opts)],
                            "answer": row.get("answer")})
    if answers_file:
        Path(answers_file).parent.mkdir(parents=True, exist_ok=True)
        with open(answers_file, "w") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    return records


def eval_mmbench(records: Sequence[Dict]) -> Dict[str, float]:
    """Per-round accuracy and circular accuracy (right in EVERY rotation of
    a question), in percent."""
    per_q: Dict[str, List[bool]] = {}
    for rec in records:
        gt_letter = str(rec.get("answer") or "").strip().upper()
        if gt_letter not in ALL_OPTIONS:
            continue
        # the ground-truth option's text moves under rotation: find where
        # the original letter's text landed this round
        base = rotate(rec["options"], -rec["round_id"] % len(rec["options"]))
        gt_text = base[ALL_OPTIONS.index(gt_letter)]
        rotated_gt = ALL_OPTIONS[rec["options"].index(gt_text)]
        pred = parse_choice(rec["text"], len(rec["options"]))
        per_q.setdefault(str(rec["question_id"]), []).append(pred == rotated_gt)
    if not per_q:
        return {"accuracy": float("nan"), "circular_accuracy": float("nan")}
    flat = [c for v in per_q.values() for c in v]
    return {"accuracy": 100.0 * sum(flat) / len(flat),
            "circular_accuracy": 100.0 * sum(all(v) for v in per_q.values()) / len(per_q),
            "n_questions": len(per_q)}


def main(argv=None):
    """Generate the answers with the float32 adapter `run_evaluation` builds
    and score them."""
    import argparse

    from robustvlm_tpu_torch.device import resolve_device, use_full_fp32
    from robustvlm_tpu_torch.vlm_eval.run_evaluation import add_model_args, build_eval_model

    p = argparse.ArgumentParser(description="MMBench multiple-choice eval (PyTorch/CUDA)")
    add_model_args(p)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--mmbench_tsv", required=True)
    p.add_argument("--answers_file", default="")
    p.add_argument("--single_round", action="store_true",
                   help="skip the all-rounds circular option rotation")
    p.add_argument("--lang", default="en")
    p.add_argument("--max_new_tokens", type=int, default=8)
    p.add_argument("--image_size", type=int, default=336)
    args = p.parse_args(argv)
    resolve_device(args.device)
    use_full_fp32()

    model = build_eval_model(args, "full")
    records = run_mmbench(model, load_mmbench_tsv(args.mmbench_tsv), size=args.image_size,
                          all_rounds=not args.single_round, lang=args.lang,
                          max_new_tokens=args.max_new_tokens, answers_file=args.answers_file or None)
    metrics = eval_mmbench(records)
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
