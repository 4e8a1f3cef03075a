"""The 0-shot side of the few-shot protocol (counterpart of
`robustvlm_tpu/vlm_eval/fewshot.py`).

`compute_effective_num_shots` and `build_context_text` are what the
captioning driver calls; at 0 shots with LLaVA the context is empty. The
demo pool (`get_query_set`, `FewShotDataset`) comes with OpenFlamingo
(ROADMAP A11), the only family that takes interleaved demo images.
"""

from __future__ import annotations

from typing import Dict, Sequence


def compute_effective_num_shots(num_shots: int, model_type: str) -> int:
    """OpenFlamingo always gets at least 2 (text-only) demos (reference
    run_evaluation.py:788-791)."""
    if model_type == "open_flamingo":
        return num_shots if num_shots > 0 else 2
    return num_shots


def build_context_text(model, demos: Sequence[Dict], num_shots: int, task: str = "caption") -> str:
    """The in-context prefix for one item: demo prompts with their gt
    answers, `<image>` tags stripped in the zero-shot case."""
    if task == "caption":
        ctx = "".join(model.get_caption_prompt(d["caption"].strip()) for d in demos)
    else:
        if any(not d.get("answers") for d in demos):
            raise ValueError(
                "few-shot VQA demo without annotator answers: the demo pool must come "
                "from an annotated train split"
            )
        ctx = "".join(model.get_vqa_prompt(d["question"], d["answers"][0]) for d in demos)
    if num_shots == 0:
        ctx = ctx.replace("<image>", "")
    return ctx
