#!/bin/bash
# The PyTorch/CUDA port's twin of clip_robustbench.sh: the same flags, plus --device cuda.
# Robust-accuracy benchmark (AutoAttack APGD-CE + APGD-T cascade) on a
# fine-tuned CLIP — mirror of the reference's CLIP_eval/clip_robustbench.
python -m robustvlm_tpu_torch.eval.robustbench \
  --clip_model_name ViT-L-14 \
  --pretrained /path/to/fare_eps_2.pt \
  --dataset imagenet --imagenet_root /mnt/datasets/imagenet \
  --n_ex 1000 --eps 2 --n_iter 100 --template ensemble \
  --device cuda
