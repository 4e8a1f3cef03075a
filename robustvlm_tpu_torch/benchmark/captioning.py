"""Caption scores for the benchmark suite: BLEU-1..4, ROUGE-L and CIDEr.

Counterpart of `robustvlm_tpu/benchmark/captioning.py` (the reference
scores generated captions with pycocoevalcap's Bleu/Rouge/Cider; its
java-based METEOR/SPICE are left out there and here):

- BLEU-n: corpus-level clipped n-gram precision, geometric mean over orders
  1..n, brevity penalty against the closest reference length (ties go to
  the shorter);
- ROUGE-L: per image, the LCS F-beta (beta 1.2) from the best precision and
  the best recall over the references, averaged over images;
- CIDEr-D: the port's `vlm_eval/metrics/cider.py` (corpus IDF).

Every metric reads the CIDEr module's PTB-style token streams.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

from robustvlm_tpu_torch.vlm_eval.metrics.cider import CiderScorer, _ngrams, tokenize

ROUGE_BETA = 1.2


def bleu_scores(cands: Sequence[str], refs: Sequence[Sequence[str]], n_max: int = 4) -> List[float]:
    """Corpus BLEU-1..n_max."""
    if len(cands) != len(refs) or not cands:
        raise ValueError("bleu_scores needs one reference list per candidate, and a candidate")
    total_match = [0] * n_max
    total_cand = [0] * n_max
    cand_len_sum = ref_len_sum = 0
    for cand, rs in zip(cands, refs):
        ct = tokenize(cand)
        rts = [tokenize(r) for r in rs]
        cand_len_sum += len(ct)
        ref_len_sum += min((abs(len(rt) - len(ct)), len(rt)) for rt in rts)[1]
        for n in range(1, n_max + 1):
            cg = _ngrams(ct, n)
            if not cg:
                continue
            max_ref = Counter()
            for rt in rts:
                for g, c in _ngrams(rt, n).items():
                    max_ref[g] = max(max_ref[g], c)
            total_match[n - 1] += sum(min(c, max_ref.get(g, 0)) for g, c in cg.items())
            total_cand[n - 1] += sum(cg.values())
    bp = 1.0 if cand_len_sum > ref_len_sum else math.exp(1.0 - ref_len_sum / max(cand_len_sum, 1))
    out, log_p = [], []
    for n in range(n_max):
        p = total_match[n] / total_cand[n] if total_cand[n] else 0.0
        log_p.append(math.log(p) if p > 0 else -math.inf)
        gm = sum(log_p) / (n + 1)
        out.append(bp * math.exp(gm) if gm > -math.inf else 0.0)
    return out


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l_score(cand: str, refs: Sequence[str]) -> float:
    """Per-image ROUGE-L: the best precision and recall over the
    references, F-beta with beta 1.2."""
    ct = tokenize(cand)
    precs, recs = [], []
    for r in refs:
        rt = tokenize(r)
        lcs = _lcs_len(rt, ct)
        precs.append(lcs / len(ct) if ct else 0.0)
        recs.append(lcs / len(rt) if rt else 0.0)
    p, r = max(precs, default=0.0), max(recs, default=0.0)
    if p == 0.0 or r == 0.0:
        return 0.0
    b2 = ROUGE_BETA ** 2
    return (1 + b2) * p * r / (r + b2 * p)


def score_captions(cands: Sequence[str], refs: Sequence[Sequence[str]]) -> Dict[str, float]:
    """Bleu_1..4, ROUGE_L and CIDEr (pycocoevalcap's scale: a perfect match
    of 4 or more tokens is 10) over a corpus."""
    metrics = {f"Bleu_{i + 1}": b for i, b in enumerate(bleu_scores(cands, refs))}
    metrics["ROUGE_L"] = sum(rouge_l_score(c, r) for c, r in zip(cands, refs)) / len(cands)
    metrics["CIDEr"] = CiderScorer(cands, refs).corpus()
    return metrics


def evaluate_captioning(
    generate_fn: Callable[[object], List[str]],
    data: Iterable[Tuple[object, Sequence[Sequence[str]]]],
) -> Dict[str, float]:
    """Generate a batch at a time, then score the corpus once. `data`
    yields (image batch, per-image reference lists)."""
    cands: List[str] = []
    refs: List[Sequence[str]] = []
    for images, ref_lists in data:
        cands.extend(generate_fn(images))
        refs.extend(ref_lists)
    return score_captions(cands, refs)
