"""Caption, VQA and classification datasets for the VLM eval (counterpart
of `CaptionDataset`, `VQADataset`, `TensorCaptionDataset`, `save_adv_image`,
`VLMImageNetDataset` and `HatefulMemesDataset` in
`robustvlm_tpu/vlm_eval/datasets.py`).

Images come out as [0,1] float32 CHW (the threat-model contract);
adversarial tensors are stored as .npy, and .pt is still read.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

from robustvlm_tpu_torch.data.loaders import default_image_transform


def _load_image(path: str, transform) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return transform(img)


def _parse_caption_annotations(annotations_path: str):
    """(captions_by_id, filename_by_id, meta_by_id) from a COCO-style or
    karpathy-style annotations json; `meta` carries the karpathy 'split'
    and 'filepath' fields when present."""
    with open(annotations_path) as f:
        data = json.load(f)
    caps: Dict[int, List[str]] = {}
    files: Dict[int, str] = {}
    meta: Dict[int, Dict] = {}
    if isinstance(data, dict) and "annotations" in data:
        for im in data.get("images", []):
            iid = im.get("id", im.get("cocoid"))
            files[iid] = im.get("file_name", im.get("filename"))
            meta[iid] = {}
        for a in data["annotations"]:
            caps.setdefault(a["image_id"], []).append(a["caption"])
    else:  # karpathy flat format
        for im in data["images"] if isinstance(data, dict) else data:
            iid = im.get("cocoid", im.get("imgid"))
            files[iid] = im.get("filename")
            caps[iid] = [s["raw"] for s in im.get("sentences", [])]
            meta[iid] = {k: im[k] for k in ("split", "filepath") if k in im}
    return caps, files, meta


def load_caption_annotations(annotations_path: str) -> Dict[int, List[str]]:
    """image_id -> reference captions (the metrics' view of the same json)."""
    return _parse_caption_annotations(annotations_path)[0]


class CaptionDataset:
    """COCO/Flickr captioning split from a COCO-style or karpathy-style
    annotations json. `split` 'train' keeps split == 'train' entries,
    anything else split == 'test'; jsons without split fields are left
    unfiltered. `image_root_train` resolves karpathy filepath == 'train2014'
    entries."""

    def __init__(self, image_root: str, annotations_path: str, *, size: int = 224,
                 which_gt: Union[int, Dict, str] = 0, n_samples: Optional[int] = None,
                 split: Optional[str] = None, image_root_train: Optional[str] = None):
        self.image_root = Path(image_root)
        self.image_root_train = Path(image_root_train) if image_root_train else self.image_root
        self.transform = default_image_transform(size)
        caps, files, meta = _parse_caption_annotations(annotations_path)
        ids = [i for i in files if i in caps]
        self.split_filtered = split is not None and any("split" in meta[i] for i in ids)
        if self.split_filtered:
            want = "train" if split == "train" else "test"
            ids = [i for i in ids if meta[i].get("split") == want]
        self.ids = ids[:n_samples]
        self.files = files
        self.meta = meta
        self.captions = caps
        self.which_gt = which_gt

    def __len__(self):
        return len(self.ids)

    def get_gt_caption(self, image_id: int) -> str:
        caps = self.captions[image_id]
        wg = self.which_gt
        if isinstance(wg, dict):
            wg = wg.get(str(image_id), wg.get(image_id, 0))
        if wg == "best" or wg is None:
            wg = 0
        return caps[int(wg) % len(caps)]

    def __getitem__(self, i: int):
        iid = self.ids[i]
        train = self.meta.get(iid, {}).get("filepath") == "train2014"
        root = self.image_root_train if train else self.image_root
        return {
            "image": _load_image(str(root / self.files[iid]), self.transform),
            "image_id": iid,
            "caption": self.get_gt_caption(iid),
            "all_captions": self.captions[iid],
        }


class VQADataset:
    """VQAv2-style questions and annotations jsons (a dict with
    'questions' / 'annotations', or a bare list). The ground truth is the
    `which_gt`-th most common annotator answer (an int, or a dict by
    question id). An image is `<image_root>/<file_prefix><file_pattern>`,
    else `<image_root>/<file_pattern>`."""

    def __init__(self, image_root: str, questions_path: str, annotations_path: Optional[str] = None,
                 *, size: int = 224, which_gt: Union[int, Dict] = 0, n_samples: Optional[int] = None,
                 file_pattern: str = "{image_id:012d}.jpg", file_prefix: str = "COCO_val2014_"):
        self.image_root = Path(image_root)
        self.transform = default_image_transform(size)
        with open(questions_path) as f:
            qdata = json.load(f)
        self.questions = (qdata["questions"] if isinstance(qdata, dict) else qdata)[:n_samples]
        self.answers: Dict[int, List[str]] = {}
        if annotations_path:
            with open(annotations_path) as f:
                adata = json.load(f)
            for a in (adata["annotations"] if isinstance(adata, dict) else adata):
                self.answers[a["question_id"]] = [x["answer"] for x in a["answers"]]
        self.which_gt = which_gt
        self.file_pattern = file_pattern
        self.file_prefix = file_prefix

    def __len__(self):
        return len(self.questions)

    def get_gt_answer(self, question_id: int) -> Optional[str]:
        if question_id not in self.answers:
            return None
        wg = self.which_gt
        if isinstance(wg, dict):
            wg = wg.get(str(question_id), wg.get(question_id, 0))
        ranked = [a for a, _ in Counter(self.answers[question_id]).most_common()]
        return ranked[int(wg) % len(ranked)]

    def __getitem__(self, i: int):
        q = self.questions[i]
        iid = q["image_id"]
        path = self.image_root / (self.file_prefix + self.file_pattern.format(image_id=iid))
        if not path.exists():
            path = self.image_root / self.file_pattern.format(image_id=iid)
        return {
            "image": _load_image(str(path), self.transform),
            "image_id": iid,
            "question_id": q["question_id"],
            "question": q["question"],
            "answers": self.answers.get(q["question_id"], []),
            "gt_answer": self.get_gt_answer(q["question_id"]),
        }


class TensorCaptionDataset:
    """Saved adversarial images in place of the clean ones:
    <adv_root>/<image_id>.npy (or .pt). `strict` raises when a selected
    image has none: a silent clean fallback would report clean performance
    as robustness (a different --seed or --num_samples selects other
    images)."""

    def __init__(self, base: CaptionDataset, adv_root: str, *, strict: bool = True):
        self.base = base
        self.adv_root = Path(adv_root)
        self.strict = strict

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i: int):
        item = self.base[i]
        iid = item["image_id"]
        npy = self.adv_root / f"{iid}.npy"
        pt = self.adv_root / f"{iid}.pt"
        if npy.exists():
            item["image"] = np.load(npy).astype(np.float32)
        elif pt.exists():
            import torch

            item["image"] = torch.load(pt, map_location="cpu", weights_only=True).float().numpy()
        elif self.strict:
            raise FileNotFoundError(
                f"no saved adversarial tensor for image_id={iid} under {self.adv_root}: "
                "re-run with the same --seed and --num_samples as the saving run"
            )
        return item


def save_adv_image(x: np.ndarray, adv_root: str, image_id) -> str:
    """Atomic write (tmp + os.replace): the files double as the ensemble's
    crash-resume state, so a crash mid-write must not leave a truncated
    tensor."""
    p = Path(adv_root)
    p.mkdir(parents=True, exist_ok=True)
    path = p / f"{image_id}.npy"
    tmp = p / f"{image_id}.npy.tmp"
    with open(tmp, "wb") as f:  # a file object: np.save does not rename it
        np.save(f, np.asarray(x, np.float32))
    os.replace(tmp, path)
    return str(path)


class VLMImageNetDataset:
    """An ImageNet tree, one directory per class, for VLM classification
    probing: items carry the class id and its CLIP-style class name."""

    def __init__(self, root: str, *, size: int = 224, n_samples: Optional[int] = None):
        from robustvlm_tpu_torch.benchmark.templates import imagenet_classnames
        from robustvlm_tpu_torch.data.loaders import ImageFolderDataset

        self.base = ImageFolderDataset(root, size=size)
        self.n = min(len(self.base), n_samples or len(self.base))
        self.classnames = imagenet_classnames()

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        x, label = self.base[i]
        return {
            "image": x,
            "image_id": i,
            "class_id": label,
            "class_name": self.classnames[label] if label < len(self.classnames) else str(label),
        }


class HatefulMemesDataset:
    """Hateful Memes jsonl lines ({'img', 'text', 'label'}) for the yes/no
    VLM probe; an image is `<image_root>/<basename of img>`."""

    def __init__(self, image_root: str, annotations_path: str, *, size: int = 224,
                 n_samples: Optional[int] = None):
        self.image_root = Path(image_root)
        self.transform = default_image_transform(size)
        with open(annotations_path) as f:
            items = [json.loads(line) for line in f if line.strip()]
        self.items = items[:n_samples]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int):
        it = self.items[i]
        return {
            "image": _load_image(str(self.image_root / Path(it["img"]).name), self.transform),
            "image_id": it.get("id", i),
            "text": it.get("text", ""),
            "label": it.get("label"),
        }
