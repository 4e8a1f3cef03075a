#!/usr/bin/env bash
# The PyTorch/CUDA port's twin of eval_cifar10_pgd.sh: the same flags, plus --device cuda
# (a later --device overrides it).
# ViT-B/32 zero-shot CIFAR-10 + 10-step attack at eps 2/255 (BASELINE
# config 1 — CPU-runnable smoke of the full eval stack).
set -e
python -m robustvlm_tpu_torch.eval.robustbench \
  --clip_model_name ViT-B-32 \
  --pretrained "${CLIP_CKPT:?}" \
  --dataset cifar10 --cifar10_root "${CIFAR10_ROOT:?}" \
  --n_ex 1000 --batch_size 128 --eps 2 --n_iter 10 \
  --attacks apgd-ce --template std --device cuda "$@"
