"""OK-VQA answer post-processing (counterpart of
`robustvlm_tpu/vlm_eval/metrics/ok_vqa.py`, copied).

OK-VQA's ground truths are stemmed, so a prediction is lowercased,
punctuation-stripped and stemmed word by word before matching: nltk's
PorterStemmer when nltk imports, else a minimal suffix-stripping fallback.
"""

from __future__ import annotations

import re

try:
    from nltk.stem import PorterStemmer

    _STEMMER = PorterStemmer()

    def _stem(w: str) -> str:
        return _STEMMER.stem(w)

except ImportError:  # pragma: no cover
    def _stem(w: str) -> str:
        for suf in ("ing", "edly", "ed", "es", "s"):
            if w.endswith(suf) and len(w) > len(suf) + 2:
                return w[: -len(suf)]
        return w


_PUNCT = re.compile(r"[^\w\s]")


def postprocess_ok_vqa_generation(prediction: str) -> str:
    pred = prediction.split("\n", 1)[0].lower().strip()
    pred = _PUNCT.sub("", pred)
    return " ".join(_stem(w) for w in pred.split())
