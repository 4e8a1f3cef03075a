"""Conversation prompt templates for LLaVA.

Equivalent of reference llava/conversation.py (Conversation /
SeparatorStyle machinery, ~381 LoC) reduced to the two templates the eval
harness actually builds (models/llava.py:148-185): vicuna_v1-style
"USER: ... ASSISTANT:" with the <image> placeholder, for captioning and VQA.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

IMAGE_PLACEHOLDER = "<image>"

VICUNA_SYSTEM = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's "
    "questions."
)


@dataclasses.dataclass
class Conversation:
    """Minimal two-role conversation with vicuna_v1 separators."""

    system: str = VICUNA_SYSTEM
    roles: Tuple[str, str] = ("USER", "ASSISTANT")
    messages: List[Tuple[str, Optional[str]]] = dataclasses.field(default_factory=list)
    sep: str = " "
    sep2: str = "</s>"

    def append(self, role: str, message: Optional[str]) -> "Conversation":
        self.messages.append((role, message))
        return self

    def get_prompt(self) -> str:
        parts = [self.system + self.sep]
        for i, (role, msg) in enumerate(self.messages):
            if msg is not None:
                sep = self.sep if role == self.roles[0] else self.sep2
                parts.append(f"{role}: {msg}{sep}")
            else:
                parts.append(f"{role}:")
        return "".join(parts)


def get_caption_prompt(caption: Optional[str] = None) -> str:
    """Reference EvalModelLLAVA.get_caption_prompt (models/llava.py:170-185)."""
    conv = Conversation()
    conv.append(
        conv.roles[0],
        f"{IMAGE_PLACEHOLDER}\nProvide a short caption for this image.",
    )
    conv.append(conv.roles[1], caption if caption else None)
    return conv.get_prompt()


def get_vqa_prompt(question: str, answer: Optional[str] = None) -> str:
    """Reference EvalModelLLAVA.get_vqa_prompt (models/llava.py:148-168)."""
    conv = Conversation()
    conv.append(
        conv.roles[0],
        f"{IMAGE_PLACEHOLDER}\n{question}\nAnswer the question using a single "
        "word or phrase.",
    )
    conv.append(conv.roles[1], answer if answer else None)
    return conv.get_prompt()


def split_at_image(prompt: str) -> Tuple[str, str]:
    """Split a prompt at the <image> placeholder -> (pre_text, post_text);
    the JAX splice takes static (pre, post) token arrays."""
    if IMAGE_PLACEHOLDER not in prompt:
        return "", prompt
    pre, post = prompt.split(IMAGE_PLACEHOLDER, 1)
    return pre, post


def answer_span(prompt: str) -> Tuple[str, str]:
    """Split a full teacher-forcing prompt at the last 'ASSISTANT:' ->
    (context, answer): the loss is masked to the answer span
    (reference models/llava.py:115-133)."""
    marker = "ASSISTANT:"
    idx = prompt.rfind(marker)
    if idx < 0:
        return prompt, ""
    cut = idx + len(marker)
    return prompt[:cut], prompt[cut:]
