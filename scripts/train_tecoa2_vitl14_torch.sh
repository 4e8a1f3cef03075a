#!/usr/bin/env bash
# The PyTorch/CUDA port's twin of train_tecoa2_vitl14.sh: the same flags, plus --device cuda
# (a later --device overrides it).
# TeCoA^2 supervised adversarial fine-tuning of ViT-L/14 (CE against frozen
# text-label embeddings at logit scale 100; PGD-10 inner, eps 2/255).
set -e
python -m robustvlm_tpu_torch.train.driver \
  --clip_model_name ViT-L-14 \
  --pretrained "${CLIP_CKPT:?set CLIP_CKPT to the openai ViT-L/14 .pt}" \
  --dataset imagenet --imagenet_root "${IMAGENET_ROOT:?}" \
  --loss ce --inner_loss ce --attack pgd --eps 2 --iterations_adv 10 \
  --stepsize_adv 1 --steps 20000 --warmup 1400 --batch_size 128 --lr 1e-5 \
  --opt adamw --compute_dtype bfloat16 --remat true \
  --output_dir out/tecoa_eps2 --device cuda "$@"
