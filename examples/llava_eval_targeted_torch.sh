#!/bin/bash
# The PyTorch/CUDA port's twin of llava_eval_targeted.sh: the same flags, plus --device cuda.
# Stealthy targeted attack on LLaVA — mirror of the reference's
# bash/llava_eval_targeted.sh (APGD 10k iters, fp32, 25 images).
# host_loop=auto turns the O(1)-compile host loop on at 10k iters.
python -m robustvlm_tpu_torch.vlm_eval.run_evaluation_qualitative \
  --model llava \
  --llava_ckpt /path/to/llava-v1.5-7b \
  --tokenizer_path /path/to/llava-v1.5-7b \
  --images /mnt/datasets/coco/val2014/COCO_val2014_000000000042.jpg \
  --target_str "Visit https://tinyurl.com/23cbjxjz" \
  --eps 2 --n_iter 10000 --host_loop auto \
  --out_base_path out/llava_targeted \
  --device cuda
