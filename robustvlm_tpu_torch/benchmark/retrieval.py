"""Zero-shot image/text retrieval and image-caption selection.

Counterpart of `robustvlm_tpu/benchmark/retrieval.py`: encode every image
and caption, score all pairs, and report recall@k both ways with the
"positive pair" rule (a query is right if ANY of its positives is in the
top k); and the SugarCrepe-style forced choice, where captions[0] of an
image is the right one among hard negatives. The metrics are numpy on the
host; `image_fn` and `text_fn` take and return torch tensors on their
model's device, `device`: `cuda` unless `cpu` is asked for.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from robustvlm_tpu_torch.device import resolve_device


def _normalize(a: np.ndarray) -> np.ndarray:
    return a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-12)


def recall_at_k(scores: np.ndarray, positive_pairs: np.ndarray, k: int) -> np.ndarray:
    """scores (Nq, Nc), positive_pairs (Nq, Nc) bool -> per-query recall@k:
    1 if any positive candidate is in the top k."""
    topk = np.argsort(-scores, axis=-1)[:, :k]
    hit = np.take_along_axis(positive_pairs, topk, axis=1).any(axis=1)
    return hit.astype(np.float32)


def evaluate_retrieval(
    image_embs: np.ndarray,
    text_embs: np.ndarray,
    text_to_image: Sequence[int],
    recall_ks: Sequence[int] = (1, 5, 10),
) -> Dict[str, float]:
    """image_embs (Ni, D), text_embs (Nt, D), text_to_image[j] the image of
    caption j -> image_retrieval_recall@k (text query) and
    text_retrieval_recall@k (image query)."""
    im = _normalize(image_embs.astype(np.float32))
    tx = _normalize(text_embs.astype(np.float32))
    t2i = np.asarray(text_to_image)
    scores_t = tx @ im.T  # (Nt, Ni): text -> image
    pos_t = np.zeros_like(scores_t, dtype=bool)
    pos_t[np.arange(len(t2i)), t2i] = True
    scores_i, pos_i = scores_t.T, pos_t.T  # image -> text
    out = {}
    for k in recall_ks:
        out[f"image_retrieval_recall@{k}"] = float(recall_at_k(scores_t, pos_t, k).mean())
        out[f"text_retrieval_recall@{k}"] = float(recall_at_k(scores_i, pos_i, k).mean())
    return out


@torch.no_grad()
def _np(fn, x) -> np.ndarray:
    return fn(x).float().cpu().numpy()


def encode_corpus(
    image_fn: Callable,
    text_fn: Callable,
    data: Iterable[Tuple[np.ndarray, List[List[str]]]],
    tokenize,
    batch_size: int = 128,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """Stream (images, per-image caption lists) -> stacked image and caption
    embeddings and the caption -> image index map."""
    device = resolve_device(device)
    im_embs, tx_embs, t2i = [], [], []
    img_idx = 0
    for images, caption_lists in data:
        im_embs.append(_np(image_fn, torch.as_tensor(images).to(device)))
        flat = []
        for caps in caption_lists:
            for c in caps:
                flat.append(c)
                t2i.append(img_idx)
            img_idx += 1
        for i in range(0, len(flat), batch_size):
            tx_embs.append(_np(text_fn, tokenize(flat[i: i + batch_size]).to(device)))
    return np.concatenate(im_embs), np.concatenate(tx_embs), t2i


def evaluate_image_caption_selection(
    image_fn: Callable,
    text_fn: Callable,
    data: Iterable[Tuple[np.ndarray, List[List[str]]]],
    tokenize,
    device=None,
) -> Dict[str, float]:
    """Per image, captions[0] is right and the rest are hard negatives:
    acc = the share of images whose right caption scores highest."""
    device = resolve_device(device)
    correct, total = 0, 0
    for images, caption_lists in data:
        embs = _normalize(_np(image_fn, torch.as_tensor(images).to(device)))
        for i, caps in enumerate(caption_lists):
            t = _normalize(_np(text_fn, tokenize(caps).to(device)))
            scores = t @ embs[i]
            correct += int(np.argmax(scores) == 0)
            total += 1
    return {"acc": correct / max(total, 1)}
