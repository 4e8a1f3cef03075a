#!/usr/bin/env bash
# The PyTorch/CUDA port's twin of eval_robustbench_vitl14.sh: the same flags, plus --device cuda
# (a later --device overrides it).
# APGD-100 robust-accuracy eval on ImageNet (BASELINE config 2):
# AutoAttack apgd-ce + targeted apgd-t at eps 2/255 over 5000 examples.
set -e
python -m robustvlm_tpu_torch.eval.robustbench \
  --clip_model_name ViT-L-14 \
  --pretrained "${CLIP_CKPT:?}" \
  --dataset imagenet --imagenet_root "${IMAGENET_ROOT:?}" \
  --n_ex 5000 --batch_size 128 --eps 2 --n_iter 100 \
  --attacks apgd-ce,apgd-t --template ensemble \
  --compute_dtype bfloat16 --device cuda "$@"
