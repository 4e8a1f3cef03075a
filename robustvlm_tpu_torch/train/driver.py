"""Training CLI: adversarial CLIP fine-tuning (TeCoA / FARE) on PyTorch/CUDA.

Counterpart of `python -m robustvlm_tpu.train.driver`, with the same flags
plus `--device`:

  python -m robustvlm_tpu_torch.train.driver --clip_model_name ViT-L-14 \\
      --pretrained /path/openai_clip.pt --dataset imagenet \\
      --imagenet_root /data/imagenet --loss l2 --attack apgd --eps 4 \\
      --steps 20000 --warmup 1400 --batch_size 128 --grad_accum 4 \\
      --output_dir out/fare4

eps and stepsize are in /255 units. `--dataset synthetic` runs without data
on disk. Runs on `--device cuda` (the default) and raises when no GPU is
visible, unless `--device cpu` is given; float32 matmuls run without TF32.
Each logged step prints a `[step]` line and appends to
`<output_dir>/metrics.jsonl` (the JAX metrics, `imgs_per_sec` since the
start, and `step_s`, the seconds from the batch's transfer to the step's
metrics on the host); the APGD-50 check prints `[eval]`.
Checkpoints are `torch.save` state dicts under `<output_dir>/checkpoints/`,
and the visual tower is exported as `checkpoints/final.pt` in the torch
layout. Not ported: the native C++ image transform (the PIL one is used)
and the COCO/SA-1B datasets (ROADMAP A.2).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from robustvlm_tpu_torch.attacks.apgd import fold_in
from robustvlm_tpu_torch.benchmark import templates as T
from robustvlm_tpu_torch.data.loaders import (
    DataLoader,
    ImageFolderDataset,
    SyntheticClassificationDataset,
)
from robustvlm_tpu_torch.device import resolve_device, use_full_fp32
from robustvlm_tpu_torch.eval.classifier import build_text_classifier
from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, load_clip_checkpoint
from robustvlm_tpu_torch.models.clip.tokenizer import get_tokenizer
from robustvlm_tpu_torch.train.trainer import TrainConfig, TrainStep, make_eval_step
from robustvlm_tpu_torch.utils.checkpoint import CheckpointManager
from robustvlm_tpu_torch.utils.logging import MetricLogger
from robustvlm_tpu_torch.utils.meters import AverageMeter


def str2bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Adversarial CLIP fine-tuning (PyTorch/CUDA)")
    p.add_argument("--clip_model_name", default="ViT-L-14", choices=sorted(CLIP_CONFIGS))
    p.add_argument("--pretrained", default="",
                   help="path to a torch CLIP checkpoint; empty = random init")
    p.add_argument("--dataset", default="imagenet", choices=["imagenet", "synthetic"])
    p.add_argument("--imagenet_root", default="/mnt/datasets/imagenet")
    p.add_argument("--template", default="std")
    p.add_argument("--output_normalize", type=str2bool, default=False)
    p.add_argument("--start_step", type=int, default=0)
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--warmup", type=int, default=1400)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--loss", default="l2", help="outer loss: l2 (FARE) | ce (TeCoA)")
    p.add_argument("--loss_clean", default="none")
    p.add_argument("--clean_weight", type=float, default=0.0)
    p.add_argument("--trades", type=str2bool, default=False)
    p.add_argument("--opt", default="adamw")
    p.add_argument("--momentum_sgd", type=float, default=0.9)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--attack", default="apgd", choices=["pgd", "apgd", "none"])
    p.add_argument("--inner_loss", default="l2")
    p.add_argument("--norm", default="linf")
    p.add_argument("--eps", type=float, default=4.0, help="in /255 units")
    p.add_argument("--iterations_adv", type=int, default=10)
    p.add_argument("--stepsize_adv", type=float, default=1.0, help="in /255 units")
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--remat", type=str2bool, default=False)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="micro-batch the step into k equal chunks (one optimizer update)")
    p.add_argument("--eval_freq", type=int, default=50)
    p.add_argument("--log_freq", type=int, default=1)
    p.add_argument("--output_dir", default="out/run")
    p.add_argument("--save_checkpoints", type=str2bool, default=True)
    p.add_argument("--resume", default="",
                   help="checkpoint name under <output_dir>/checkpoints to restore the "
                        "model and optimizer from (e.g. fallback_4200); pair with --start_step")
    p.add_argument("--text_embedding_path", default="",
                   help="npy file with the (D, C) normalized class-text matrix; empty = "
                        "computed from the ImageNet class names")
    p.add_argument("--bpe_path", default="", help="CLIP BPE merges file (or $CLIP_BPE_PATH)")
    p.add_argument("--wandb", type=str2bool, default=False)
    p.add_argument("--experiment_name", default="")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


@dataclasses.dataclass
class TrainRun:
    """What `main` leaves behind: the trained model, the frozen original,
    the step (its inner attack, optimizer and configuration), the last
    step's and eval's metrics, the steps done and the wall seconds."""

    model: CLIP
    model_orig: CLIP
    train_step: TrainStep
    metrics: Dict[str, float]
    eval_metrics: Optional[Dict[str, float]]
    steps: int
    wall_s: float


def text_embedding_for(args, model: CLIP, device) -> Optional[torch.Tensor]:
    """The (D, classes) class-text matrix from `--text_embedding_path`, or
    from the model's text tower over the ImageNet class names when a loss
    or the eval needs it (TeCoA, `--dataset imagenet`); else None."""
    if args.text_embedding_path:
        return torch.from_numpy(np.load(args.text_embedding_path)).float().to(device)
    if not (args.loss == "ce" or args.inner_loss == "ce" or args.dataset == "imagenet"):
        return None
    cfg = model.cfg
    tok = get_tokenizer(args.bpe_path or None, cfg.context_length, cfg.vocab_size)
    tpls = T.get_templates("imagenet1k") if args.template == "ensemble" else None
    return build_text_classifier(model, lambda t: torch.from_numpy(tok(t)).long(),
                                 T.get_classnames("imagenet1k"), templates=tpls)


def train_config(args) -> TrainConfig:
    """The parsed flags as a TrainConfig; eps and stepsize from /255 units."""
    return TrainConfig(
        loss=args.loss, inner_loss=args.inner_loss, loss_clean=args.loss_clean,
        clean_weight=args.clean_weight, trades=args.trades, attack=args.attack,
        norm=args.norm, eps=args.eps / 255.0, iterations_adv=args.iterations_adv,
        stepsize_adv=args.stepsize_adv / 255.0, opt=args.opt, lr=args.lr, wd=args.wd,
        momentum_sgd=args.momentum_sgd, warmup=args.warmup, steps=args.steps,
        output_normalize=args.output_normalize, compute_dtype=args.compute_dtype,
        remat=args.remat, grad_accum=args.grad_accum,
    )


def main(argv=None) -> TrainRun:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    use_full_fp32()
    clip_cfg = CLIP_CONFIGS[args.clip_model_name]
    cfg = train_config(args)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "args.json").write_text(json.dumps(vars(args), indent=2))
    logger = MetricLogger(str(out), run_name=args.experiment_name or "train",
                          use_wandb=args.wandb, config=vars(args))

    # the trainable model and the frozen original
    model = CLIP(clip_cfg, device=device).init_random_(0)
    if args.pretrained:
        model.load_state_dict(load_clip_checkpoint(args.pretrained, clip_cfg, base=model.state_dict()))
    model_orig = copy.deepcopy(model)
    text_embedding = text_embedding_for(args, model, device)

    if args.dataset == "imagenet":
        ds = ImageFolderDataset(args.imagenet_root + "/train", size=clip_cfg.image_size)
        ds_eval = ImageFolderDataset(args.imagenet_root + "/val", size=clip_cfg.image_size)
    else:
        ds = SyntheticClassificationDataset(n=max(args.batch_size * 4, 64), size=clip_cfg.image_size)
        ds_eval = SyntheticClassificationDataset(n=args.batch_size, size=clip_cfg.image_size, seed=1)
    loader = DataLoader(ds, args.batch_size, shuffle=True, drop_last=True)
    loader_eval = DataLoader(ds_eval, args.batch_size, shuffle=True, drop_last=True)

    train_step = TrainStep(cfg, model, model_orig, text_embedding)
    eval_step = None
    if text_embedding is not None:
        eval_step = make_eval_step(cfg, model, text_embedding,
                                   initial_stepsize=0.05 * cfg.eps if args.clean_weight > 0 else None)

    ckpt = CheckpointManager(str(out), args.steps) if args.save_checkpoints or args.resume else None
    if args.resume:
        ckpt.restore(args.resume, model, train_step.optimizer)
        print(f"resumed from {args.resume} at step {args.start_step}")
    meters = {k: AverageMeter(k) for k in ["loss", "cos_sim", "acc", "racc"]}

    def on_device(x_np, y_np):
        return torch.from_numpy(x_np).to(device), torch.from_numpy(y_np).to(device)

    step = start_step = args.start_step
    epoch = 0
    m, em = {}, None
    t_start = time.time()
    eval_iter = iter(loader_eval) if eval_step is not None else None
    while step < args.steps:
        for x_np, y_np in loader:
            t_step = time.time()
            x, y = on_device(x_np, y_np)
            metrics = train_step(x, y, fold_in(1, step))
            step += 1

            if (step - 1) % args.log_freq == 0:
                m = {k: float(v) for k, v in metrics.items()}  # waits for the step's device work
                m["step_s"] = time.time() - t_step
                for k in meters:
                    if k in m:
                        meters[k].update(m[k], x.shape[0])
                m["imgs_per_sec"] = args.batch_size * (step - start_step) / max(time.time() - t_start, 1e-9)
                logger.log(m, step=step)
                print(f"[step] {step} " + " ".join(f"[{k}] {v:.4f}" for k, v in m.items()), flush=True)

            if eval_step is not None and (step - 1) % args.eval_freq == 0:
                # one persistent iterator, so one prefetch thread
                try:
                    xe, ye = next(eval_iter)
                except StopIteration:
                    eval_iter = iter(loader_eval)
                    xe, ye = next(eval_iter)
                em = {k: float(v) for k, v in eval_step(*on_device(xe, ye)).items()}
                logger.log(em, step=step)
                print(f"[eval] {em}", flush=True)

            if ckpt is not None:
                ckpt.maybe_save(step, model, train_step.optimizer)
            if step >= args.steps:
                break
        epoch += 1
        print(f"Epoch {epoch} done.")

    if ckpt is not None:
        ckpt.save_final(model, train_step.optimizer)
        ckpt.export_torch_visual(model, clip_cfg)
    wall = time.time() - t_start
    # the logged steps' averages, each weighted by its batch
    logger.summary({"steps": step, "wall_time_s": wall,
                    **{f"avg_{k}": mt.avg for k, mt in meters.items() if mt.count}})
    return TrainRun(model, model_orig, train_step, m, em, step, wall)


if __name__ == "__main__":
    main()
