"""Eval-model adapter contract (counterpart of
`robustvlm_tpu/vlm_eval/base.py`): the interface every VLM threat-model
adapter satisfies, so the attack and ensemble layers stay model-agnostic."""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence, runtime_checkable

import torch


@runtime_checkable
class BaseEvalModel(Protocol):
    """- prompts: get_caption_prompt(caption|None), get_vqa_prompt(q, a|None)
    - set_inputs(full_prompts): cache tokenized teacher-forcing targets
    - __call__(x01) -> (B,) per-sample loss on the cached targets, pixels
      unnormalized in [0,1] (normalization inside: the threat model)
    - get_outputs(x01, prompts, ...) -> generated strings
    """

    def get_caption_prompt(self, caption: Optional[str] = None) -> str: ...

    def get_vqa_prompt(self, question: str, answer: Optional[str] = None) -> str: ...

    def set_inputs(self, full_prompts: Sequence[str]) -> None: ...

    def __call__(self, x01: torch.Tensor) -> torch.Tensor: ...

    def get_outputs(self, x01: torch.Tensor, prompts: Sequence[str], **kw) -> List[str]: ...
