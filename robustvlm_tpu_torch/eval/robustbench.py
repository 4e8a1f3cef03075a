"""Robust-accuracy benchmark CLI for standalone CLIP, on PyTorch/CUDA.

Counterpart of `python -m robustvlm_tpu.eval.robustbench`, with its flags:

  python -m robustvlm_tpu_torch.eval.robustbench \\
      --clip_model_name ViT-L-14 --pretrained /ckpt/openai_l14.pt \\
      --dataset imagenet --imagenet_root /data/imagenet \\
      --n_ex 5000 --eps 2 --n_iter 100 --attacks apgd-ce,apgd-t

Flow: load CLIP (optionally beta-interpolating two checkpoints), build the
zero-shot classifier (std template or the 80-template ensemble), wrap it as
a pixel-space logits module (logits = 100 * e . T with normalize and
resize inside), then run the AutoAttack cascade over still-robust
examples (`--attacks`, or the `standard` version with `--full_benchmark`:
APGD-CE, APGD-T, FAB-T, Square) in the l-inf, l2 or l1 norm, and write
`result.json` and the summary to `metrics.jsonl` (and wandb with
`--wandb`). eps is in /255 units in every norm. ImageNet is read from
`<imagenet_root>/val`, one directory per class, the first `--n_ex` images
in sorted order.

Runs on `--device cuda` (the default) and raises when no GPU is visible,
unless `--device cpu` is given. float32 matmuls run without TF32. Under
`--compute_dtype bfloat16` the tower's matrices are held in bf16 once and
every 1-D parameter stays float32 (`cast_matrices_`): the logits are those
of the float32 model run at bf16, bit for bit. `--remat` other than `none`
recomputes each vision block in the backward (the port has one remat
mode). `--host_loop` is a JAX compile option, accepted and ignored.
`--labels predicted` is a smoke and debug setting, not an evaluation: it
labels every example with the model's clean prediction, so every example is
attacked (a random-weight model classifies random labels at chance), and
the "robust accuracy" it reports is the share of the model's own
predictions the attack could not flip, not robust accuracy.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from robustvlm_tpu_torch.benchmark import templates as T
from robustvlm_tpu_torch.data.loaders import (
    DataLoader,
    ImageFolderDataset,
    SyntheticClassificationDataset,
    load_cifar10,
)
from robustvlm_tpu_torch.device import resolve_device, use_full_fp32
from robustvlm_tpu_torch.eval.autoattack import AutoAttack
from robustvlm_tpu_torch.eval.classifier import build_text_classifier, make_zero_shot_classifier
from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, load_clip_checkpoint
from robustvlm_tpu_torch.models.clip.model import cast_matrices_
from robustvlm_tpu_torch.models.clip.tokenizer import get_tokenizer
from robustvlm_tpu_torch.utils.logging import MetricLogger

DATASET_SHORT = {"imagenet": "img", "cifar10": "c10", "synthetic": "synth"}


def build_parser():
    p = argparse.ArgumentParser(description="CLIP robust-accuracy benchmark (PyTorch/CUDA)")
    p.add_argument("--clip_model_name", default="ViT-L-14", choices=sorted(CLIP_CONFIGS))
    p.add_argument("--pretrained", default="", help="checkpoint path; '' = random")
    p.add_argument("--base_pretrained", default="",
                   help="full CLIP checkpoint supplying the text tower when "
                        "--pretrained is a visual-only (FARE/TeCoA) dict")
    p.add_argument("--pretrained2", default="", help="second ckpt for beta-interpolation")
    p.add_argument("--beta", type=float, default=0.5, help="interpolation weight of --pretrained2")
    p.add_argument("--dataset", default="imagenet", choices=["imagenet", "cifar10", "synthetic"])
    p.add_argument("--imagenet_root", default="data/imagenet",
                   help="ImageNet root; the eval split is <root>/val, a directory per class")
    p.add_argument("--cifar10_root", default="data/cifar10")
    p.add_argument("--n_ex", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=128, help="data-loading / clean-accuracy batch")
    p.add_argument("--attack_batch", type=int, default=8, help="attack chunk size")
    p.add_argument("--template", default="ensemble", choices=["std", "ensemble"])
    p.add_argument("--norm", default="linf", choices=["linf", "l2", "l1"])
    p.add_argument("--eps", type=float, default=2.0, help="in /255 units, in every norm")
    p.add_argument("--n_iter", type=int, default=100)
    p.add_argument("--attacks", default="apgd-ce,apgd-t",
                   help="comma list of apgd-ce, apgd-dlr, apgd-t, fab, fab-t, square")
    p.add_argument("--full_benchmark", action="store_true",
                   help="run AutoAttack's 'standard' cascade (apgd-ce, apgd-t, fab-t, "
                        "square) instead of --attacks")
    p.add_argument("--alpha", type=float, default=None,
                   help="APGD initial step-size multiplier override")
    p.add_argument("--remat", default="none", choices=["dots", "full", "dots_saveable", "none"],
                   help="recompute the attacked tower's blocks in the backward: any value "
                        "but 'none' recomputes each whole block (remat=True on the port's "
                        "CLIP; the JAX modes 'dots' and 'dots_saveable' choose what XLA "
                        "saves, which has no PyTorch counterpart); default 'none', since "
                        "an attack chunk's activations fit on the card")
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--labels", default="dataset", choices=["dataset", "predicted"],
                   help="'predicted' (smoke and debug only): label each example with "
                        "the model's clean prediction, so every example is attacked; the "
                        "result is then not robust accuracy")
    p.add_argument("--bpe_path", default="")
    p.add_argument("--state_path", default="", help="AutoAttack resume state file")
    p.add_argument("--host_loop", action="store_true",
                   help="a JAX compile option (host-looped APGD steps); accepted and ignored")
    p.add_argument("--output_dir", default="out/robustbench")
    p.add_argument("--wandb", action="store_true",
                   help="also log the summary to wandb (an optional import)")
    p.add_argument("--experiment_name", default="", help="run name (default 'robustbench')")
    p.add_argument("--save_adv", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def load_model(args, device) -> CLIP:
    cfg = CLIP_CONFIGS[args.clip_model_name]
    model = CLIP(cfg, device=device).init_random_(0)
    if args.base_pretrained:
        model.load_state_dict(load_clip_checkpoint(args.base_pretrained, cfg))
    if args.pretrained:
        sd = load_clip_checkpoint(
            args.pretrained, cfg, base=model.state_dict(),
            interpolate_with=args.pretrained2 or None, beta=args.beta,
        )
        model.load_state_dict(sd)
    elif args.pretrained2:
        raise ValueError("--pretrained2 interpolates AGAINST --pretrained; give both")
    return model


def load_data(args, size: int):
    if args.dataset == "cifar10":
        return load_cifar10(args.cifar10_root, train=False, n_examples=args.n_ex)
    if args.dataset == "imagenet":
        ds = ImageFolderDataset(f"{args.imagenet_root}/val", size=size)
        xs, ys, n = [], [], 0
        for xb, yb in DataLoader(ds, args.batch_size, shuffle=False, drop_last=False):
            take = min(len(xb), args.n_ex - n)
            xs.append(xb[:take])
            ys.append(yb[:take])
            n += take
            if n >= args.n_ex:
                break
        return np.concatenate(xs), np.concatenate(ys)
    return SyntheticClassificationDataset(n=args.n_ex, size=size).arrays()


def build_classifier(args, device):
    """(model, logits module, native image size) as `main` attacks them."""
    model = load_model(args, device)
    cfg = model.cfg
    tok = get_tokenizer(args.bpe_path or None, cfg.context_length, cfg.vocab_size)

    def tokenize(texts):
        return torch.from_numpy(tok(texts)).long()

    dataset_key = "imagenet1k" if args.dataset in ("imagenet", "synthetic") else args.dataset
    classnames = T.get_classnames(dataset_key)
    tpls = T.get_templates(dataset_key) if args.template == "ensemble" else None
    classifier = build_text_classifier(model, tokenize, classnames, templates=tpls)

    native = 32 if args.dataset == "cifar10" else cfg.image_size
    compute_dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    # the attacked tower's matrices in the compute dtype once; its 1-D
    # parameters (LayerNorm gains and biases, biases) stay float32, as the
    # JAX package applies them
    cast_matrices_(model.visual, compute_dtype)
    logits_fn = make_zero_shot_classifier(
        model, classifier,
        resize_to=cfg.image_size if native != cfg.image_size else None,
        compute_dtype=compute_dtype, remat=args.remat != "none",
    )
    return model, logits_fn, native


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    use_full_fp32()
    eps = args.eps / 255.0
    _, logits_fn, native = build_classifier(args, device)

    x, y = load_data(args, native)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    logger = MetricLogger(str(out), run_name=args.experiment_name or "robustbench",
                          use_wandb=args.wandb, config=vars(args))

    common = dict(norm=args.norm, eps=eps, n_iter=args.n_iter, alpha=args.alpha, verbose=True, device=device)
    if args.full_benchmark:
        aa = AutoAttack(logits_fn, version="standard", **common)
    else:
        aa = AutoAttack(logits_fn, attacks_to_run=[a.strip() for a in args.attacks.split(",") if a.strip()],
                        **common)
    if args.labels == "predicted":
        y = aa.predict(x, args.batch_size)

    t0 = time.time()
    x_adv = aa.run_standard_evaluation(
        x, y, bs=args.attack_batch, state_path=(args.state_path or None),
        bs_forward=args.batch_size,
    )
    racc = aa.robust_accuracy_dict
    clean_acc = racc["clean"]
    print(f"clean accuracy: {100 * clean_acc:.2f}%")
    robust_acc = min((v for k, v in racc.items() if k != "clean"), default=clean_acc)
    result = {
        "model": args.clip_model_name,
        "pretrained": args.pretrained,
        "dataset": args.dataset,
        "labels": args.labels,
        "n_ex": int(x.shape[0]),
        "eps": args.eps,
        "norm": args.norm,
        "compute_dtype": args.compute_dtype,
        "device": str(device),
        "clean_acc": clean_acc,
        "robust_acc": robust_acc,
        "cascade": racc,
        "wall_s": round(time.time() - t0, 1),
    }
    ds_short = DATASET_SHORT[args.dataset]
    eps_descr = str(int(args.eps)) if args.norm == "linf" else str(eps)
    result[f"rb/acc-{ds_short}"] = 100 * clean_acc
    result[f"rb/racc-{ds_short}-{args.norm}-{eps_descr}"] = 100 * robust_acc
    logger.summary(result)
    (out / "result.json").write_text(json.dumps(result, indent=2))
    if args.save_adv:
        np.save(out / "x_adv.npy", x_adv.numpy())
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
