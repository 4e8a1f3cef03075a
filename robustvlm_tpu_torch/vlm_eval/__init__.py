"""VLM adversarial evaluation: the LLaVA and OpenFlamingo adapters, the
few-shot protocol, the ensemble attack schedule with per-image (per-question)
worst-case selection, CIDEr-D and the VQA accuracy, caption and VQA
datasets, the run_evaluation CLI, the targeted qualitative CLI and LLaVA's
POPE and ScienceQA evals (counterpart of `robustvlm_tpu/vlm_eval/`)."""
