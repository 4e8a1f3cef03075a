"""Prompt templates and classname tables for zero-shot classifiers.

Counterpart of `get_classnames`, `get_templates`, `format_prompts` and
`target_to_seed` in `robustvlm_tpu/benchmark/templates.py`. The tables are
the JSON files under `robustvlm_tpu/benchmark/data/`, read by path (the
port imports nothing of the JAX package).
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Dict, List, Sequence

_DATA = Path(__file__).resolve().parents[2] / "robustvlm_tpu" / "benchmark" / "data"

STD_TEMPLATE = "This is a photo of a {c}"

_BUILTIN_CLASSNAMES: Dict[str, List[str]] = {
    "cifar10": [
        "airplane", "automobile", "bird", "cat", "deer",
        "dog", "frog", "horse", "ship", "truck",
    ],
}


@functools.lru_cache()
def _load_json(name: str):
    return json.loads((_DATA / name).read_text())


def get_templates(dataset: str) -> List[str]:
    """Per-dataset English prompt-template ensemble (`{c}` is the classname
    slot); falls back to the imagenet1k 80-template set."""
    tpl = _load_json("zeroshot_templates.json")
    return tpl.get(dataset, tpl["imagenet1k"])


def get_classnames(dataset: str) -> List[str]:
    if dataset in _BUILTIN_CLASSNAMES:
        return _BUILTIN_CLASSNAMES[dataset]
    cn = _load_json("en_classnames.json")
    if dataset in cn:
        return cn[dataset]
    if dataset in ("imagenet", "imagenet1k", "imagenet-r", "imagenet-a", "imagenetv2"):
        return _load_json("imagenet_classnames.json")
    raise KeyError(f"no classname table for dataset '{dataset}'")


def format_prompts(templates: Sequence[str], classname: str) -> List[str]:
    return [
        t.format(c=classname) if "{c}" in t else t.format(classname)
        for t in templates
    ]


def target_to_seed() -> Dict[str, int]:
    """Fixed seeds of the stealthy targeted caption attacks, one a target
    string (`target_to_seed.json`)."""
    return _load_json("target_to_seed.json")
