#!/bin/bash
# The PyTorch/CUDA port's twin of of_eval_9b.sh: the same flags, plus --device cuda.
# OpenFlamingo-9B ensemble attack eval — mirror of the reference's
# bash/of_eval_9B.sh (same protocol: ensemble, eps 2/255, 100 iters,
# 500 samples, context frames masked out of the perturbation).
# Fill the dataset/checkpoint paths for your machine.
# --model_size 7b = full size (maps to the OF-9B config for this family)
python -m robustvlm_tpu_torch.vlm_eval.run_evaluation \
  --model open_flamingo --model_size 7b \
  --of_ckpt /path/to/OpenFlamingo-9B-vitl-mpt7b/checkpoint.pt \
  --mpt_ckpt /path/to/mpt-7b \
  --tokenizer_path /path/to/mpt-7b \
  --vision_encoder_pretrained /path/to/fare_eps_2.pt \
  --eval_coco \
  --coco_image_dir /mnt/datasets/coco/val2014 \
  --coco_annotations /mnt/datasets/coco/annotations/captions_val2014.json \
  --coco_train_image_dir /mnt/datasets/coco/train2014 \
  --attack ensemble --eps 2 --n_iter 100 --mask_out context \
  --shots 0 --num_samples 500 --batch_size 1 \
  --out_base_path out/of9b_coco \
  --device cuda
# crashed? re-run the same command with --resume
