#!/bin/bash
# The PyTorch/CUDA port's twin of fare_train.sh: the same flags, plus --device cuda.
# FARE adversarial fine-tuning of CLIP ViT-L/14 — the reference
# README.md:275-284 recipe (unsupervised l2 embedding loss, PGD-10,
# eps 4/255, batch 128, AdamW). --loss ce gives TeCoA instead.
python -m robustvlm_tpu_torch.train.driver \
  --clip_model_name ViT-L-14 \
  --pretrained /path/to/openai_vitl14.pt \
  --dataset imagenet --imagenet_root /mnt/datasets/imagenet \
  --loss l2 --attack pgd --inner_loss l2 \
  --eps 4 --iterations_adv 10 --stepsize_adv 1 \
  --batch_size 128 --steps 20000 --warmup 1400 \
  --lr 1e-5 --wd 1e-4 --opt adamw \
  --compute_dtype bfloat16 --remat true --grad_accum 16 \
  --output_dir out/fare_eps4 \
  --device cuda
