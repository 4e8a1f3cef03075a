#!/bin/bash
# The PyTorch/CUDA port's twin of eval_pope.sh: the same flags, plus --device cuda.
# POPE object-hallucination probe for LLaVA — mirror of the reference's
# bash/eval_pope.sh (llava.eval.model_vqa_loader + eval_pope two-step;
# here one CLI that generates answers and scores them).
python -m robustvlm_tpu_torch.vlm_eval.pope \
  --model llava \
  --llava_ckpt /path/to/llava-v1.5-7b \
  --tokenizer_path /path/to/llava-v1.5-7b \
  --vision_encoder_pretrained /path/to/fare_eps_2.pt \
  --pope_questions ./pope_eval/llava_pope_test.jsonl \
  --image_root /mnt/datasets/coco/val2014 \
  --answers_path out/pope_answers.jsonl \
  --device cuda
