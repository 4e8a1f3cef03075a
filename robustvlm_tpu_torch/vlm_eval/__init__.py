"""VLM adversarial evaluation: the LLaVA adapter, the ensemble attack
schedule with per-image worst-case selection, CIDEr-D, caption datasets and
the run_evaluation CLI (counterpart of `robustvlm_tpu/vlm_eval/`)."""
