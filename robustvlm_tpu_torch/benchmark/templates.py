"""Prompt templates and classname tables for zero-shot classifiers.

Counterpart of `robustvlm_tpu/benchmark/templates.py`: the per-dataset
template ensembles and classnames in English and, through `language=`, the
translated tables (ar, cn, it, jp), the small built-in label sets (cifar10,
cifar100, stl10), the ImageNet classnames and the targeted-attack seeds.
The tables are the JSON files under `robustvlm_tpu/benchmark/data/`, read
by path (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Dict, List, Sequence

_DATA = Path(__file__).resolve().parents[2] / "robustvlm_tpu" / "benchmark" / "data"

STD_TEMPLATE = "This is a photo of a {c}"

# small standard label sets not covered by the JSON tables
_BUILTIN_CLASSNAMES: Dict[str, List[str]] = {
    "cifar10": [
        "airplane", "automobile", "bird", "cat", "deer",
        "dog", "frog", "horse", "ship", "truck",
    ],
    "cifar100": [
        "apple", "aquarium fish", "baby", "bear", "beaver", "bed", "bee",
        "beetle", "bicycle", "bottle", "bowl", "boy", "bridge", "bus",
        "butterfly", "camel", "can", "castle", "caterpillar", "cattle",
        "chair", "chimpanzee", "clock", "cloud", "cockroach", "couch", "crab",
        "crocodile", "cup", "dinosaur", "dolphin", "elephant", "flatfish",
        "forest", "fox", "girl", "hamster", "house", "kangaroo", "keyboard",
        "lamp", "lawn mower", "leopard", "lion", "lizard", "lobster", "man",
        "maple tree", "motorcycle", "mountain", "mouse", "mushroom",
        "oak tree", "orange", "orchid", "otter", "palm tree", "pear",
        "pickup truck", "pine tree", "plain", "plate", "poppy", "porcupine",
        "possum", "rabbit", "raccoon", "ray", "road", "rocket", "rose",
        "sea", "seal", "shark", "shrew", "skunk", "skyscraper", "snail",
        "snake", "spider", "squirrel", "streetcar", "sunflower",
        "sweet pepper", "table", "tank", "telephone", "television", "tiger",
        "tractor", "train", "trout", "tulip", "turtle", "wardrobe", "whale",
        "willow tree", "wolf", "woman", "worm",
    ],
    "stl10": [
        "airplane", "bird", "car", "cat", "deer",
        "dog", "horse", "monkey", "ship", "truck",
    ],
}


@functools.lru_cache()
def _load_json(name: str):
    return json.loads((_DATA / name).read_text())


def get_templates(dataset: str, language: str = "en") -> List[str]:
    """Per-dataset prompt-template ensemble (`{c}` is the classname slot);
    falls back to the imagenet1k set. Languages other than en read the
    translated template tables."""
    name = (
        "zeroshot_templates.json" if language == "en"
        else f"{language}_zeroshot_classification_templates.json"
    )
    tpl = _load_json(name)
    return tpl.get(dataset, tpl["imagenet1k"])


def get_classnames(dataset: str, language: str = "en") -> List[str]:
    if language != "en":
        cn = _load_json(f"{language}_classnames.json")
        if dataset in cn:
            return cn[dataset]
        raise KeyError(f"no {language} classname table for '{dataset}'")
    if dataset in _BUILTIN_CLASSNAMES:
        return _BUILTIN_CLASSNAMES[dataset]
    cn = _load_json("en_classnames.json")
    if dataset in cn:
        return cn[dataset]
    if dataset in ("imagenet", "imagenet1k", "imagenet-r", "imagenet-a", "imagenetv2"):
        return _load_json("imagenet_classnames.json")
    raise KeyError(f"no classname table for dataset '{dataset}'")


def imagenet_classnames() -> List[str]:
    """The 1000 CLIP-style ImageNet classnames."""
    return _load_json("imagenet_classnames.json")


def format_prompts(templates: Sequence[str], classname: str) -> List[str]:
    return [
        t.format(c=classname) if "{c}" in t else t.format(classname)
        for t in templates
    ]


def target_to_seed() -> Dict[str, int]:
    """Fixed seeds of the stealthy targeted caption attacks, one a target
    string (`target_to_seed.json`)."""
    return _load_json("target_to_seed.json")
