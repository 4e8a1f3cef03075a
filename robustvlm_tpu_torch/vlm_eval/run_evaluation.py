"""VLM adversarial evaluation CLI: LLaVA and OpenFlamingo captioning and VQA
on the card.

Counterpart of `robustvlm_tpu/vlm_eval/run_evaluation.py`, with the same
flags and `--device` (default cuda):

  python -m robustvlm_tpu_torch.vlm_eval.run_evaluation \\
      --model llava --eval_coco --coco_image_dir /data/coco/val2014 \\
      --coco_annotations /data/coco/captions_val2014.json \\
      --attack ensemble --eps 2 --n_iter 100 --num_samples 500
  python -m robustvlm_tpu_torch.vlm_eval.run_evaluation --model llava \\
      --llava_ckpt /ckpt/llava-1.5-7b --vision_encoder_pretrained fare2.pt \\
      --eval_vqav2 --vqav2_image_dir ... --vqav2_questions ... \\
      --vqav2_annotations ... --attack ensemble [--targeted --target_str maybe]
  python -m robustvlm_tpu_torch.vlm_eval.run_evaluation --model open_flamingo \\
      --eval_coco ... --attack apgd --shots 0 4 [--mask_out context]

eps in /255 units. --attack none = clean eval; apgd = one untargeted run
(half precision); ensemble = the full worst-case schedule (VQA adds the
targeted 'maybe' and 'Word' stages); --targeted adds --target_str. The VQA
evals (--eval_vqav2, --eval_textvqa, --eval_vizwiz, --eval_ok_vqa) score the
official leave-one-out accuracy (OK-VQA's answers stemmed), per question.

Weights: LLaVA loads --llava_ckpt (an HF directory of shards or one file),
with --vision_encoder_pretrained a robust 224 px tower in place of its own
(the `llava-1.5-7b-rob` config); OpenFlamingo takes --of_ckpt with
--mpt_ckpt and --clip_ckpt (or a robust tower). Without a checkpoint the
weights are random from seed 0, made once per run on the device (OpenFlamingo's
gates at 0, as the reference initialises them). Either way one float32 set
of weights is shared by the bf16 and float32 adapters. --tokenizer_path
loads an HF tokenizer through `transformers` (an optional import); without
it the hash tokenizer stands in. --model_size test-tiny runs the tiny
configs (tests). --shots N stacks N demo images before the query
(OpenFlamingo; 2 text-only demos at 0 shots), drawn from the train files
(or, warned, the eval files); --mask_out masks the context or the query
frames' gradient.

Not ported yet, raising NotImplementedError with its ROADMAP item:
--model blip2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from robustvlm_tpu_torch.device import resolve_device, use_full_fp32


# per-dataset VQA file layouts: VQAv2 and OK-VQA are COCO images, TextVQA and
# VizWiz name files by their bare id
VQA_LAYOUTS = {
    "vqav2": dict(file_prefix="COCO_val2014_", file_pattern="{image_id:012d}.jpg"),
    "ok_vqa": dict(file_prefix="COCO_val2014_", file_pattern="{image_id:012d}.jpg"),
    "textvqa": dict(file_prefix="", file_pattern="{image_id}.jpg"),
    "vizwiz": dict(file_prefix="", file_pattern="{image_id}.jpg"),
}
VQA_DATASETS = ("vqav2", "textvqa", "vizwiz", "ok_vqa")  # the JAX CLI's order


def add_model_args(p):
    p.add_argument("--model", default="llava", choices=["llava", "open_flamingo", "blip2"])
    p.add_argument("--model_size", default="7b", help="'7b' | 'test-tiny'")
    p.add_argument("--llava_ckpt", default="")
    p.add_argument("--of_ckpt", default="")
    p.add_argument("--blip2_ckpt", default="")
    p.add_argument("--mpt_ckpt", default="")
    p.add_argument("--clip_ckpt", default="")
    p.add_argument("--vision_encoder_pretrained", default="",
                   help="robustified visual tower ckpt (FARE/TeCoA)")
    p.add_argument("--tokenizer_path", default="",
                   help="HF tokenizer dir; empty = hash tokenizer")
    return p


def build_parser():
    p = argparse.ArgumentParser(description="VLM adversarial eval (PyTorch/CUDA)")
    add_model_args(p)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for ds in ("coco", "flickr30", "vqav2", "textvqa", "vizwiz", "ok_vqa"):
        p.add_argument(f"--eval_{ds}", action="store_true")
    for flag in ("coco_image_dir", "coco_annotations", "flickr_image_dir", "flickr_annotations",
                 "coco_train_image_dir", "coco_train_annotations", "flickr_train_annotations"):
        p.add_argument(f"--{flag}", default="")
    for ds in VQA_DATASETS:
        for part in ("image_dir", "questions", "annotations"):
            p.add_argument(f"--{ds}_{part}", default="")
            p.add_argument(f"--{ds}_train_{part}", default="")
    p.add_argument("--attack", default="ensemble", choices=["none", "apgd", "ensemble"])
    p.add_argument("--eps", type=float, default=2.0, help="in /255 units")
    p.add_argument("--n_iter", type=int, default=100)
    p.add_argument("--targeted", action="store_true")
    p.add_argument("--target_str", default="Visit https://tinyurl.com/23cbjxjz")
    p.add_argument("--num_samples", type=int, default=500)
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--from_saved", default="", help="reload saved adversarial images from this dir")
    p.add_argument("--resume", action="store_true",
                   help="resume a crashed ensemble run from the per-stage state in the out dir "
                        "(same seed/num_samples/schedule required)")
    p.add_argument("--host_loop", action="store_true",
                   help="accepted for the JAX CLI's sake; the port's APGD is always a host loop")
    p.add_argument("--batch_size", type=int, default=1,
                   help="attack batch for the untargeted ensemble stages; targeted and "
                        "prev-best stages run per item")
    p.add_argument("--shots", nargs="+", type=int, default=[0])
    p.add_argument("--num_trials", type=int, default=1)
    p.add_argument("--trial_seeds", nargs="+", type=int, default=None,
                   help="one distinct seed per trial (default: seed, seed+1, ...)")
    p.add_argument("--query_set_size", type=int, default=2048)
    p.add_argument("--mask_out", default="none", choices=["none", "context", "query"])
    p.add_argument("--out_base_path", default="out/vlm_eval")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", action="store_true")
    return p


def _unwrap(ds):
    """The innermost dataset (TensorCaptionDataset wraps via `.base`)."""
    while hasattr(ds, "base"):
        ds = ds.base
    return ds


def _eval_indices(n_total: int, num_samples, seed: int) -> np.ndarray:
    """Random eval subset (np.random.choice with the trial seed); full-set
    evals keep natural order."""
    n_eval = min(n_total, num_samples or n_total)
    if n_eval < n_total:
        return np.random.RandomState(seed).choice(n_total, n_eval, replace=False)
    return np.arange(n_eval)


def _tokenizer(args):
    """The HF tokenizer of --tokenizer_path (its pad token the EOS token
    when it has none), else the hash tokenizer. `transformers` is an
    optional import: without it --tokenizer_path raises."""
    if args.tokenizer_path:
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError("--tokenizer_path needs the `transformers` package") from e
        tok = AutoTokenizer.from_pretrained(args.tokenizer_path)
        if tok.pad_token_id is None:
            tok.pad_token = tok.eos_token
        return tok
    from robustvlm_tpu_torch.vlm_eval.eval_models import WordTokenizer

    return WordTokenizer()


def _llava_config(args):
    """llava-1.5-7b, or llava-1.5-7b-rob (the 224 px tower) with
    --vision_encoder_pretrained; test-tiny for the tiny size."""
    from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS

    if args.model_size != "7b":
        return LLAVA_CONFIGS["test-tiny"]
    return LLAVA_CONFIGS["llava-1.5-7b-rob" if args.vision_encoder_pretrained else "llava-1.5-7b"]


def build_llava_models(args, precisions, device) -> Dict[str, object]:
    """One `Llava` per precision ('half' bf16, 'full' float32) from ONE set
    of weights: --llava_ckpt (with --vision_encoder_pretrained's tower and
    the checkpoint's own projector type), loaded once in float32, or random from seed 0, drawn once on the device.
    The bf16 model holds one bf16 copy of the matrices (made once) and
    shares the rest with the float32 one; with no 'full' stage no float32
    matrix is ever held on the device."""
    from robustvlm_tpu_torch.models.llava.convert import init_random_state
    from robustvlm_tpu_torch.models.llava.model import Llava, half_state

    cfg = _llava_config(args)
    if args.llava_ckpt:
        from robustvlm_tpu_torch.models.llava.import_torch import checkpoint_config, load_llava_checkpoint
        from robustvlm_tpu_torch.models.mpt.import_torch import load_state

        sd = load_state(args.llava_ckpt)
        cfg = checkpoint_config(sd, cfg)
        full = load_llava_checkpoint(sd, cfg, robust_vision_path=args.vision_encoder_pretrained or None)
        del sd
        if "full" not in precisions:  # bf16 alone: cast on the device, one tensor at a time
            half = {}
            for k in list(full):
                half.update(half_state({k: full.pop(k).to(device)}))
            return {"half": Llava.from_state(cfg, half)}
        full = {k: v.to(device) for k, v in full.items()}
    elif args.vision_encoder_pretrained:
        raise ValueError("--vision_encoder_pretrained replaces the tower of --llava_ckpt's model; "
                         "pass --llava_ckpt with it")
    elif "full" in precisions:
        full = init_random_state(cfg, 0, device)
    else:
        return {"half": Llava.from_state(cfg, init_random_state(cfg, 0, device, torch.bfloat16))}
    models = {"full": Llava.from_state(cfg, full)}
    if "half" in precisions:
        models["half"] = Llava.from_state(cfg, half_state(full))
    return models


def flamingo_config(args, tok):
    """openflamingo-9b (test-tiny for the tiny size) with the tokenizer's
    <image> id: its `media_token_id`, else the last id of its vocabulary,
    else OpenFlamingo's 50431."""
    from robustvlm_tpu_torch.models.flamingo.model import FLAMINGO_CONFIGS

    cfg = FLAMINGO_CONFIGS["openflamingo-9b" if args.model_size == "7b" else "test-tiny"]
    media_id = getattr(tok, "media_token_id", None)
    if media_id is None:
        media_id = len(tok) - 1 if hasattr(tok, "__len__") else 50431
    return dataclasses.replace(cfg, media_token_id=media_id)


def build_flamingo_models(args, precisions, device) -> Dict[str, object]:
    """One `Flamingo` per precision from ONE set of weights, shared as
    `build_llava_models` shares them: the three checkpoints of --of_ckpt,
    --mpt_ckpt and --clip_ckpt (or --vision_encoder_pretrained), else random
    from seed 0 with the reference's zero gates."""
    from robustvlm_tpu_torch.models.flamingo import (
        Flamingo,
        half_state,
        init_random_state,
        load_flamingo_checkpoint,
    )

    cfg = flamingo_config(args, _tokenizer(args))
    if args.of_ckpt:
        full = {k: v.to(device) for k, v in load_flamingo_checkpoint(
            args.of_ckpt, cfg, mpt_path=args.mpt_ckpt, visual_path=args.clip_ckpt,
            robust_visual_path=args.vision_encoder_pretrained or None).items()}
    elif args.vision_encoder_pretrained:
        raise ValueError("--vision_encoder_pretrained replaces the tower of --of_ckpt's model; "
                         "pass --of_ckpt, --mpt_ckpt and --clip_ckpt with it")
    elif "full" in precisions:
        full = init_random_state(cfg, 0, device)
    else:
        return {"half": Flamingo.from_state(cfg, init_random_state(cfg, 0, device, torch.bfloat16))}
    models = {"full": Flamingo.from_state(cfg, full)} if "full" in precisions else {}
    if "half" in precisions:
        models["half"] = Flamingo.from_state(cfg, half_state(full))
    return models


def build_models(args, precisions, device) -> Dict[str, object]:
    """The models of --model, one per precision, shared by every dataset
    and trial of a run."""
    if args.model == "blip2":
        raise NotImplementedError("--model blip2 is not ported (ROADMAP A12, BLIP-2)")
    build = build_flamingo_models if args.model == "open_flamingo" else build_llava_models
    return build(args, precisions, device)


def build_eval_model(args, precision: str, models: Optional[Dict[str, object]] = None):
    """The adapter of one precision ('half' bf16, 'full' float32) over
    `models` (`build_models`' result). Without `models` (the serving
    worker) the weights are drawn here, random from seed 0 as the eval CLI
    draws them: in float32 under --quantize-decode, so that
    `quantize_for_serving` quantizes the float32 draws (the JAX worker
    quantizes its float32 tree) and then holds the rest in the precision's
    layout; else in the precision's layout directly."""
    from robustvlm_tpu_torch.vlm_eval.eval_models import FlamingoEvalModel, LlavaEvalModel

    dtype = torch.bfloat16 if precision == "half" else torch.float32
    if models is None:
        drawn = "full" if getattr(args, "quantize_decode", False) else precision
        model = build_models(args, {drawn}, resolve_device(args.device))[drawn]
    else:
        model = models[precision]
    adapter = FlamingoEvalModel if args.model == "open_flamingo" else LlavaEvalModel
    return adapter(model, _tokenizer(args), compute_dtype=dtype)


def _image_size(args) -> int:
    """336 px for LLaVA-1.5's tower, 224 for OpenFlamingo's ViT-L/14, 32 for
    the tiny configs."""
    if args.model == "llava" and args.model_size == "7b" and not args.vision_encoder_pretrained:
        return 336
    return 224 if args.model_size == "7b" else 32


def _wrap_few_shot(args, ds, train_ds, num_shots: int, seed: int):
    """The dataset with each item's demos (and, at num_shots > 0, stacked
    context frames); unchanged when the effective shot count is 0."""
    from robustvlm_tpu_torch.vlm_eval.fewshot import (
        FewShotDataset,
        compute_effective_num_shots,
        get_query_set,
    )

    eff = compute_effective_num_shots(num_shots, args.model)
    if eff <= 0:
        return ds
    if num_shots > 0 and args.model != "open_flamingo":
        raise ValueError("--shots > 0 needs the interleaved-media model (open_flamingo); "
                         "llava/blip2 towers take a single image per example")
    query_set = get_query_set(train_ds, args.query_set_size, seed)
    return FewShotDataset(ds, query_set, num_shots=num_shots, effective_num_shots=eff, seed=seed)


def attack_schedule(args, task: str = "caption"):
    """--attack none: a clean pass; apgd: one untargeted (or --targeted)
    half-precision run; ensemble: the full worst-case schedule of the task
    ('caption', or 'vqa' with its targeted 'maybe' / 'Word' stages)."""
    from robustvlm_tpu_torch.vlm_eval.ensemble import (
        AttackSpec,
        default_captioning_schedule,
        default_vqa_schedule,
    )

    tgt = args.target_str if args.targeted else None
    if args.attack == "none":
        return [AttackSpec(kind="none")]
    if args.attack == "apgd":
        return [AttackSpec(n_iter=args.n_iter, gt_idx=0, targeted=args.targeted, target_str=tgt)]
    schedule = default_vqa_schedule if task == "vqa" else default_captioning_schedule
    return schedule(args.n_iter, target_str=tgt)


def _out_dir(args, dataset_name: str, num_shots: int, trial: Optional[int]) -> Path:
    """Per dataset, shot count and trial: runs of a grid never share
    adversarial tensors or the resume state."""
    return Path(args.out_base_path) / (
        (dataset_name if num_shots == 0 else f"{dataset_name}_shots{num_shots}")
        + ("" if trial is None else f"_trial{trial}"))


def evaluate_captioning(args, dataset_name: str, image_dir: str, annotations: str, *,
                        models: Dict[str, object], num_shots: int = 0,
                        seed: Optional[int] = None, trial: Optional[int] = None,
                        threshold: Optional[float] = None) -> Dict:
    """`models` is `build_models`' result, made once per run and shared by
    every dataset, shot count and trial. The demo pool comes from the train
    split (`--<dataset>_train_annotations`, else the eval file, warned). An
    image leaves the ensemble once its worst CIDEr is under `threshold`
    (None: the dataset's, COCO 10, Flickr 2)."""
    from robustvlm_tpu_torch.vlm_eval.datasets import CaptionDataset, TensorCaptionDataset
    from robustvlm_tpu_torch.vlm_eval.ensemble import EnsembleRunner, attack_success_rate
    from robustvlm_tpu_torch.vlm_eval.fewshot import build_context_text, compute_effective_num_shots
    from robustvlm_tpu_torch.vlm_eval.metrics.cider import CiderIDF, CiderScorer

    seed = args.seed if seed is None else seed
    size = _image_size(args)
    ds = CaptionDataset(image_dir, annotations, size=size, split="val")
    if args.from_saved:
        if args.attack != "none":
            # a new eps-ball around already perturbed pixels reaches 2 eps
            # from the clean image: --from_saved is for re-evaluation
            raise ValueError("--from_saved requires --attack none")
        ds = TensorCaptionDataset(ds, args.from_saved)
    if compute_effective_num_shots(num_shots, args.model) > 0:
        train_ann = getattr(args, f"{dataset_name}_train_annotations", "") or annotations
        train_dir = getattr(args, f"{dataset_name}_train_image_dir", "") or image_dir
        train_ds = CaptionDataset(train_dir, train_ann, size=size, split="train",
                                  image_root_train=train_dir)
        if train_ann == annotations and not train_ds.split_filtered:
            # a plain COCO json without karpathy split fields: the 'train'
            # view is the eval file; items never demonstrate themselves, but
            # the pool overlaps the eval set
            warnings.warn(
                f"--{dataset_name}_train_annotations not set and the eval json has no karpathy "
                "split fields: few-shot demos are drawn from the EVAL annotations (overlapping "
                "pool). Pass a train annotations file for reference-comparable numbers.",
                stacklevel=2)
        ds = _wrap_few_shot(args, ds, train_ds, num_shots, seed)

    def prompt_fn(model, item, spec, query_only):
        ctx = build_context_text(model, item.get("demos") or [], num_shots, task="caption")
        if query_only:
            return ctx + model.get_caption_prompt(None)
        if spec.targeted and spec.target_str:
            return ctx + model.get_caption_prompt(spec.target_str)
        caps = item["all_captions"]
        return ctx + model.get_caption_prompt(caps[(spec.gt_idx or 0) % len(caps)])

    # corpus-level IDF over every evaluated image's references: CIDEr under
    # a one-image corpus is identically 0
    cap_ds = _unwrap(ds)
    sel = _eval_indices(len(cap_ds.ids), args.num_samples, seed)
    eval_ids = [cap_ds.ids[int(k)] for k in sel]
    idf = CiderIDF([cap_ds.captions[i] for i in eval_ids])

    def score_fn(caption, item):
        return idf.score(caption, item["all_captions"]) * 100.0

    if threshold is None:
        threshold = {"coco": 10.0, "flickr": 2.0}.get(dataset_name, 10.0)
    runner = EnsembleRunner(
        lambda prec: build_eval_model(args, prec, models),
        eps=args.eps / 255.0, score_fn=score_fn, prompt_fn=prompt_fn, threshold=threshold,
        out_dir=str(_out_dir(args, dataset_name, num_shots, trial)),
        max_new_tokens=args.max_new_tokens, num_beams=args.num_beams, verbose=args.verbose,
        batch_size=args.batch_size, mask_out=args.mask_out,
    )
    res = runner.run(ds, attack_schedule(args), seed=seed, indices=sel, resume=args.resume)

    cands = {i: c for i, c in res["outputs"].items() if c is not None}
    refs = {i: cap_ds.captions[i] for i in eval_ids if i in cands}
    cider = (CiderScorer([cands[i] for i in cands], [refs[i] for i in cands]).corpus() * 100.0
             if cands else float("nan"))
    metrics = {"cider": cider}
    if args.targeted:
        metrics["success_rate"] = attack_success_rate(res["outputs"], args.target_str)
    metrics["wall_s"] = res["wall_s"]
    metrics["attack_s"] = res["attack_s"]
    metrics["attack_iters"] = res["attack_iters"]
    return metrics


def vqa_layout_for_dir(dataset_name: str, image_dir: str) -> dict:
    """The dataset's layout, with a COCO file prefix naming the split that
    the image directory holds (train demos live in train2014/ as
    COCO_train2014_*); other directory names keep the default prefix, and
    `VQADataset` falls back to the bare file pattern anyway."""
    layout = dict(VQA_LAYOUTS[dataset_name])
    coco_split = Path(image_dir).name
    if dataset_name in ("vqav2", "ok_vqa") and coco_split in ("train2014", "val2014", "test2015"):
        layout["file_prefix"] = f"COCO_{coco_split}_"
    return layout


def evaluate_vqa(args, dataset_name: str = "vqav2", *, models: Dict[str, object],
                 num_shots: int = 0, seed: Optional[int] = None, trial: Optional[int] = None,
                 threshold: float = 1.0) -> Dict:
    """One VQA dataset under the attack schedule. `models` is `build_models`'
    result, shared by the run. Items are questions (several may share an
    image), each scored by its own `question_id`; a question leaves the
    ensemble once its worst accuracy is under `threshold` (1.0: every wrong
    answer). Demos (num_shots > 0, OpenFlamingo) come from the train files,
    else from the eval files, warned, and need annotator answers."""
    from collections import Counter

    from robustvlm_tpu_torch.vlm_eval.datasets import VQADataset
    from robustvlm_tpu_torch.vlm_eval.ensemble import EnsembleRunner, attack_success_rate
    from robustvlm_tpu_torch.vlm_eval.fewshot import build_context_text, compute_effective_num_shots
    from robustvlm_tpu_torch.vlm_eval.metrics.ok_vqa import postprocess_ok_vqa_generation
    from robustvlm_tpu_torch.vlm_eval.metrics.vqa_accuracy import (
        postprocess_vqa_generation,
        vqa_accuracy,
    )

    seed = args.seed if seed is None else seed
    size = _image_size(args)
    image_dir = getattr(args, f"{dataset_name}_image_dir")
    questions = getattr(args, f"{dataset_name}_questions")
    annotations = getattr(args, f"{dataset_name}_annotations")
    ds = VQADataset(image_dir, questions, annotations, size=size,
                    **vqa_layout_for_dir(dataset_name, image_dir))
    if compute_effective_num_shots(num_shots, args.model) > 0:
        train_dir = getattr(args, f"{dataset_name}_train_image_dir", "") or image_dir
        train_q = getattr(args, f"{dataset_name}_train_questions", "") or questions
        train_ann = getattr(args, f"{dataset_name}_train_annotations", "") or annotations
        if train_q == questions or train_ann == annotations:
            warnings.warn(
                f"--{dataset_name}_train_questions/_train_annotations not set: few-shot demos are "
                "drawn from the EVAL files (overlapping pool; each item is excluded from its own "
                "demos). Pass the train-split files for reference-comparable numbers.",
                stacklevel=2)
        train_ds = VQADataset(train_dir, train_q, train_ann, size=size,
                              **vqa_layout_for_dir(dataset_name, train_dir))
        if not train_ds.answers:
            raise ValueError(
                f"few-shot {dataset_name} demo pool has no annotator answers: demos teacher-force "
                f"answers[0]; pass --{dataset_name}_train_annotations (train split)")
        ds = _wrap_few_shot(args, ds, train_ds, num_shots, seed)

    def prompt_fn(model, item, spec, query_only):
        ctx = build_context_text(model, item.get("demos") or [], num_shots, task="vqa")
        if query_only:
            return ctx + model.get_vqa_prompt(item["question"], None)
        if spec.targeted and spec.target_str:
            # the target word teacher-forced as the answer, its loss minimized
            return ctx + model.get_vqa_prompt(item["question"], spec.target_str)
        answers = item["answers"] or [item.get("gt_answer") or ""]
        ranked = [a for a, _ in Counter(answers).most_common()]
        return ctx + model.get_vqa_prompt(item["question"], ranked[(spec.gt_idx or 0) % len(ranked)])

    def score_fn(pred, item):
        if not item["answers"]:
            return float("nan")
        if dataset_name == "ok_vqa":  # OK-VQA's ground truths are stemmed
            return 100.0 * vqa_accuracy(postprocess_ok_vqa_generation(pred), item["answers"])
        return 100.0 * vqa_accuracy(postprocess_vqa_generation(pred), item["answers"])

    runner = EnsembleRunner(
        lambda prec: build_eval_model(args, prec, models),
        eps=args.eps / 255.0, score_fn=score_fn, prompt_fn=prompt_fn, threshold=threshold,
        out_dir=str(_out_dir(args, dataset_name, num_shots, trial)),
        max_new_tokens=args.max_new_tokens, num_beams=args.num_beams, verbose=args.verbose,
        batch_size=args.batch_size, mask_out=args.mask_out,
    )
    sel = _eval_indices(len(ds), args.num_samples, seed)
    res = runner.run(ds, attack_schedule(args, "vqa"), seed=seed, indices=sel,
                     resume=args.resume)
    scores = [v for v in res["scores"].values() if np.isfinite(v)]
    metrics = {"vqa_accuracy": float(np.mean(scores)) if scores else float("nan")}
    if args.targeted:
        metrics["success_rate"] = attack_success_rate(res["outputs"], args.target_str)
    metrics["wall_s"] = res["wall_s"]
    metrics["attack_s"] = res["attack_s"]
    metrics["attack_iters"] = res["attack_iters"]
    return metrics


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mask_out != "none" and args.model != "open_flamingo":
        raise ValueError("--mask_out requires --model open_flamingo")
    device = resolve_device(args.device)
    use_full_fp32()  # float32 stages at full precision: no TF32
    out = Path(args.out_base_path)
    out.mkdir(parents=True, exist_ok=True)
    if args.trial_seeds is not None:
        if len(args.trial_seeds) != len(set(args.trial_seeds)):
            raise ValueError("--trial_seeds must be distinct")
        if len(args.trial_seeds) != args.num_trials:
            raise ValueError(f"--trial_seeds needs exactly --num_trials (={args.num_trials}) "
                             f"entries, got {len(args.trial_seeds)}")
        trial_seeds = args.trial_seeds
    else:
        trial_seeds = [args.seed + t for t in range(args.num_trials)]
    results = {}
    t0 = time.time()
    models = None
    if args.eval_coco or args.eval_flickr30 or any(getattr(args, f"eval_{d}") for d in VQA_DATASETS):
        # the captioning and VQA schedules run the same precisions
        models = build_models(args, {s.precision for s in attack_schedule(args)}, device)
    # the shots x trials grid, with the JAX CLI's result keys: bare for one
    # 0-shot trial, else per shot count (and trial)
    default_grid = args.shots == [0] and args.num_trials == 1
    for num_shots in args.shots:
        for trial in range(args.num_trials):
            sfx = "" if default_grid else f"_shots{num_shots}"
            if args.num_trials > 1:
                sfx += f"_trial{trial}"
            kw = dict(models=models, num_shots=num_shots, seed=trial_seeds[trial],
                      trial=trial if args.num_trials > 1 else None)
            if args.eval_coco:
                results["coco" + sfx] = evaluate_captioning(
                    args, "coco", args.coco_image_dir, args.coco_annotations, **kw)
            if args.eval_flickr30:
                results["flickr" + sfx] = evaluate_captioning(
                    args, "flickr", args.flickr_image_dir, args.flickr_annotations, **kw)
            for ds in VQA_DATASETS:
                if getattr(args, f"eval_{ds}"):
                    results[ds + sfx] = evaluate_vqa(args, ds, **kw)
    if args.num_trials > 1:  # means across trials, per shot count
        for num_shots in args.shots:
            for base in ("coco", "flickr", *VQA_DATASETS):
                keys = [k for k in (f"{base}_shots{num_shots}_trial{t}"
                                    for t in range(args.num_trials)) if k in results]
                if keys:
                    results[f"{base}_shots{num_shots}_mean"] = {
                        m: float(np.nanmean([results[k][m] for k in keys]))
                        for m in results[keys[0]] if isinstance(results[keys[0]][m], (int, float))
                    }
    results["total_wall_s"] = round(time.time() - t0, 1)
    (out / "results.json").write_text(json.dumps(results, indent=2))
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
