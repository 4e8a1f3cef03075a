"""The few-shot in-context protocol (counterpart of
`robustvlm_tpu/vlm_eval/fewshot.py`).

- The demo pool (`get_query_set`) is `query_set_size` examples drawn
  without replacement from the TRAIN split with the trial seed.
- Each eval item gets `compute_effective_num_shots` demos: OpenFlamingo
  gets 2 even at 0 shots, and those are TEXT-ONLY (their `<image>` tags are
  stripped by `build_context_text`, no frames stacked); LLaVA's context is
  empty at 0 shots.
- At num_shots > 0 `FewShotDataset` stacks the demo images before the
  query image on the media axis: (T = shots + 1, F = 1, C, H, W), query last.
- Caption demos teacher-force their gt caption; VQA demos their first
  annotator answer.

As in the JAX package (and unlike the reference's unseeded global
`random`), demos are drawn ONCE per eval item from
`random.Random(f"{seed}:{item_index}")`, so a run is reproducible and the
ensemble's warm-started last stage re-attacks the frames it started from.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence

import numpy as np


def compute_effective_num_shots(num_shots: int, model_type: str) -> int:
    """OpenFlamingo always gets at least 2 (text-only) demos (reference
    run_evaluation.py:788-791)."""
    if model_type == "open_flamingo":
        return num_shots if num_shots > 0 else 2
    return num_shots


def get_query_set(train_dataset, query_set_size: int, seed: int) -> List[Dict]:
    """The demo pool from the train split, clamped to its size."""
    n = min(query_set_size, len(train_dataset))
    idx = np.random.RandomState(seed).choice(len(train_dataset), n, replace=False)
    return [train_dataset[int(i)] for i in idx]


def sample_demos(query_set: Sequence[Dict], effective_num_shots: int, seed: int,
                 item_index: int) -> List[Dict]:
    """The demos of ONE eval item, from its own seeded stream."""
    if effective_num_shots <= 0:
        return []
    r = random.Random(f"{seed}:{item_index}")
    return r.sample(list(query_set), min(effective_num_shots, len(query_set)))


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


class FewShotDataset:
    """An eval dataset whose items carry their demos (`item["demos"]`) and,
    at num_shots > 0, the stacked context and query frames in place of
    `item["image"]`: (T = shots + 1, F = 1, C, H, W), the query last, the
    layout the Flamingo adapter and `make_frame_mask` take. An item never
    demonstrates itself (a pool drawn from the eval file would otherwise
    teacher-force its own ground truth)."""

    def __init__(self, base, query_set: Sequence[Dict], *, num_shots: int,
                 effective_num_shots: Optional[int] = None, seed: int = 42):
        self.base = base
        self.query_set = list(query_set)
        self.num_shots = num_shots
        self.effective_num_shots = num_shots if effective_num_shots is None else effective_num_shots
        self.seed = seed

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i: int) -> Dict:
        item = dict(self.base[i])
        key = item.get("question_id", item.get("image_id"))
        pool = [d for d in self.query_set if d.get("question_id", d.get("image_id")) != key]
        demos = sample_demos(pool, self.effective_num_shots, self.seed, i)
        item["demos"] = demos
        # ndim guard: a saved few-shot adversarial tensor is already (T, F, C, H, W)
        if self.num_shots > 0 and demos and np.asarray(item["image"]).ndim == 3:
            frames = [np.asarray(d["image"]) for d in demos] + [np.asarray(item["image"])]
            item["image"] = np.stack(frames)[:, None]
        return item
