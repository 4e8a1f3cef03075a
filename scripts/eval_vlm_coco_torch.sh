#!/usr/bin/env bash
# The PyTorch/CUDA port's twin of eval_vlm_coco.sh: the same flags, plus --device cuda
# (a later --device overrides it).
# LLaVA-1.5-7B COCO captioning under the ensemble attack (eps 2/255,
# APGD-100 per stage, 500 images) — the headline VLM eval.
set -e
python -m robustvlm_tpu_torch.vlm_eval.run_evaluation \
  --model llava --llava_ckpt "${LLAVA_CKPT:?}" \
  --tokenizer_path "${TOKENIZER:?HF tokenizer dir}" \
  --eval_coco --coco_image_dir "${COCO_IMG:?}" \
  --coco_annotations "${COCO_ANN:?}" \
  --attack ensemble --eps 2 --n_iter 100 --num_samples 500 \
  --max_new_tokens 32 --device cuda "$@"
