#!/usr/bin/env bash
# The PyTorch/CUDA port's twin of train_fare4_vitl14.sh: the same flags, plus --device cuda
# (a later --device overrides it).
# FARE^4 unsupervised adversarial fine-tuning of ViT-L/14 (reference bash/ +
# README recipe: 20k steps, bs 128, lr 1e-5 AdamW, warmup 1400, APGD-10 inner,
# eps 4/255, 2 epochs ImageNet).
set -e
python -m robustvlm_tpu_torch.train.driver \
  --clip_model_name ViT-L-14 \
  --pretrained "${CLIP_CKPT:?set CLIP_CKPT to the openai ViT-L/14 .pt}" \
  --dataset imagenet --imagenet_root "${IMAGENET_ROOT:?}" \
  --loss l2 --inner_loss l2 --attack apgd --eps 4 --iterations_adv 10 \
  --steps 20000 --warmup 1400 --batch_size 128 --lr 1e-5 --wd 1e-4 \
  --opt adamw --compute_dtype bfloat16 --remat true \
  --output_dir out/fare_eps4 --device cuda "$@"
