"""CIDEr-D metric, implemented from the published algorithm.

Replaces the reference's pycocoevalcap dependency
(open_flamingo/eval/coco_metric.py:1-20 `compute_cider`, :22-46
`compute_cider_all_scores`): TF-IDF-weighted n-gram (n=1..4) cosine
similarity between candidate and references, with CIDEr-D's count clipping
and gaussian length penalty (sigma=6), corpus-level IDF, final score x10.

The IDF is a corpus-level object (`CiderIDF`): document frequencies are
computed ONCE over every image's reference set, and individual candidates
are scored under that shared IDF — exactly what pycocoevalcap's Cider does
when the reference scores the full 500-image result set per attack stage
(coco_metric.py:22-46). Scoring a caption against a 1-image "corpus" is
degenerate (log N = 0 makes every TF-IDF weight vanish), which is why the
ensemble harness must never do it.

Tokenization is a native PTB-style tokenizer reproducing the effective
behavior of pycocoevalcap's PTBTokenizer pipeline (Stanford PTBTokenizer
-preserveLines -lowerCase, then the PUNCTUATIONS-list filter): possessives
and contractions split into their own tokens ("dog's" -> ["dog", "'s"],
"isn't" -> ["is", "n't"]), acronym periods kept ("U.S." -> ["u.s."]),
hyphenated words intact ("red-striped"), digit-internal commas kept
("1,000"), % and $ detached as standalone surviving tokens ("50%" ->
["50", "%"]), and all pure-punctuation tokens (including PTB's "--",
"...", bracket and quote tokens) dropped. Hand-derived golden values in
tests/test_vlm_eval.py pin the scorer to the pycocoevalcap algorithm on
pre-tokenized fixtures; tests/test_vlm_eval.py::TestPtbTokenize pins the
tokenizer on the cases above. Residual drift vs the Java tokenizer:
known-abbreviation periods ("etc.", "mr.") are stripped here, and PTB's
forward-slash escaping is not reproduced. tests/test_cider_oracle.py is a
skip-if-absent pycocoevalcap oracle (same pattern as the torch parity
oracles) that activates wherever the package exists: scorer math must
match to float precision on shared tokens; residual tokenizer drift is
gated at score level (<=5 points on the x100 threshold scale).
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

SIGMA = 6.0
N_MAX = 4

# letter-period sequences ("u.s.", "a.m.") keep their periods, like the
# Stanford tokenizer's acronym handling
_ACRONYM = re.compile(r"^(?:[a-z]\.){2,}$")
# PTB contraction suffixes become their own tokens and SURVIVE the
# punctuation filter (pycocoevalcap's PUNCTUATIONS list has no "'s"/"n't")
_CONTRACTION_TOKENS = frozenset({"'s", "'m", "'d", "'ll", "'re", "'ve"})


def tokenize(s: str) -> List[str]:
    """PTB-style caption tokenization (see module docstring): lowercase,
    treebank splits for contractions/possessives, punctuation tokens
    dropped per pycocoevalcap's PUNCTUATIONS filter."""
    s = s.strip().lower()
    # PTB's '...' / '--' tokens are in the punctuation filter — drop now
    s = re.sub(r"\.\.\.+", " ", s)
    s = re.sub(r"--+", " ", s)
    # always-splitting punctuation, all filtered out downstream
    s = re.sub(r"[;:?!()\[\]{}<>\"“”‘’`]", " ", s)
    # commas split (and die) except between digits ("1,000" stays whole)
    s = re.sub(r"(?<!\d),|,(?!\d)", " ", s)
    # % and $ are standalone PTB tokens ("50%" -> "50 %", "$5" -> "$ 5")
    # that SURVIVE the reference filter (neither is in PUNCTUATIONS)
    s = re.sub(r"([%$])", r" \1 ", s)
    # contractions: "isn't" -> "is n't", then possessives/clitics
    s = re.sub(r"(\w)(n't)\b", r"\1 \2", s)
    s = re.sub(r"(\w)('s|'m|'d|'ll|'re|'ve)\b", r"\1 \2", s)
    out = []
    for tok in s.split():
        if tok == "n't" or tok in _CONTRACTION_TOKENS:
            out.append(tok)
            continue
        # leading/trailing apostrophes are PTB quote tokens (filtered);
        # possessive-plural "cats'" becomes cats + ' in PTB, ' is filtered
        tok = tok.strip("'")
        # trailing sentence periods split off (and die); acronyms keep them
        while tok.endswith(".") and not _ACRONYM.match(tok):
            tok = tok[:-1]
        # pure-punctuation leftovers ("-", em-dashes) are filtered; "&",
        # "%", "$" are real PTB tokens that survive the reference filter
        if tok in ("&", "%", "$") or re.search(r"[a-z0-9]", tok):
            out.append(tok)
    return out


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def _counts(sent: str) -> List[Counter]:
    toks = tokenize(sent)
    return [_ngrams(toks, n) for n in range(1, N_MAX + 1)]


class CiderIDF:
    """Corpus-level document frequencies for CIDEr-D.

    Built once from ALL images' reference lists (pycocoevalcap
    cider_scorer.compute_doc_freq: each n-gram counts once per image whose
    reference set contains it; ref_len = log(#images)). `score(cand, refs)`
    then scores one candidate under the shared IDF.
    """

    def __init__(self, all_refs: Sequence[Sequence[str]]):
        assert len(all_refs) > 0
        self.doc_freq: List[Dict] = [defaultdict(int) for _ in range(N_MAX)]
        for rs in all_refs:
            counted = [_counts(r) for r in rs]
            for n in range(N_MAX):
                seen = set()
                for r in counted:
                    seen.update(r[n].keys())
                for g in seen:
                    self.doc_freq[n][g] += 1
        self.log_n_images = math.log(max(len(all_refs), 1))

    def _vec(self, counts: Counter, n: int):
        """TF-IDF vector + norm. tf is the raw count (pycocoevalcap
        convention); idf = log(N) - log(max(df, 1))."""
        vec = {}
        norm = 0.0
        for g, c in counts.items():
            df = math.log(max(self.doc_freq[n][g], 1.0))
            w = c * (self.log_n_images - df)
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm)

    @staticmethod
    def _sim(cvec, cnorm, rvec, rnorm, len_c, len_r):
        """CIDEr-D pair similarity for one n: clipped dot / norms with the
        gaussian length penalty."""
        if cnorm == 0.0 or rnorm == 0.0:
            return 0.0
        num = 0.0
        for g, w in cvec.items():
            if g in rvec:
                num += min(w, rvec[g]) * rvec[g]
        delta = float(len_c - len_r)
        return (
            (num / (cnorm * rnorm))
            * math.exp(-(delta ** 2) / (2 * SIGMA ** 2))
        )

    def score(self, cand: str, refs: Sequence[str]) -> float:
        """CIDEr-D of one candidate vs its references, on the x10 scale
        (perfect >=4-token match = 10.0). The harness multiplies by a
        further x100 (run_evaluation.py) to land on the reference's scale:
        pycocoevalcap's internal x10 then coco_metric.py:42 `scores *= 100`
        — the cider<10 early-stop threshold lives on THAT scale."""
        cand_counts = _counts(cand)
        len_c = len(tokenize(cand))
        ref_counts = [_counts(r) for r in refs]
        ref_lens = [len(tokenize(r)) for r in refs]
        score_ns = []
        for n in range(N_MAX):
            cvec, cnorm = self._vec(cand_counts[n], n)
            s = 0.0
            for rc, rl in zip(ref_counts, ref_lens):
                rvec, rnorm = self._vec(rc[n], n)
                s += self._sim(cvec, cnorm, rvec, rnorm, len_c, rl)
            score_ns.append(s / max(len(refs), 1))
        return 10.0 * sum(score_ns) / N_MAX


class CiderScorer:
    """Batch CIDEr-D: `refs[i]` is the reference list for image i, `cands[i]`
    the candidate caption. IDF is built from THESE refs — callers scoring
    single captions repeatedly must build one `CiderIDF` over the whole
    corpus instead (see the ensemble harness)."""

    def __init__(self, cands: Sequence[str], refs: Sequence[Sequence[str]]):
        assert len(cands) == len(refs) and len(cands) > 0
        self.cands = list(cands)
        self.refs = [list(rs) for rs in refs]
        self.idf = CiderIDF(self.refs)

    def per_image(self) -> List[float]:
        return [
            self.idf.score(c, rs) for c, rs in zip(self.cands, self.refs)
        ]

    def corpus(self) -> float:
        p = self.per_image()
        return sum(p) / len(p)


def compute_cider(
    result_captions: Dict, annotations: Dict
) -> float:
    """reference coco_metric.compute_cider equivalent: results maps
    image_id -> caption; annotations maps image_id -> [ref captions]."""
    ids = list(result_captions.keys())
    cands = [result_captions[i] for i in ids]
    refs = [annotations[i] for i in ids]
    return CiderScorer(cands, refs).corpus()


def compute_cider_all_scores(
    result_captions: Dict, annotations: Dict
) -> Dict:
    """Per-image CIDEr-D x100 (the harness thresholds at cider<10,
    reference run_evaluation.py:1073-1092 use the x100 scale)."""
    ids = list(result_captions.keys())
    cands = [result_captions[i] for i in ids]
    refs = [annotations[i] for i in ids]
    per = CiderScorer(cands, refs).per_image()
    return {i: 100.0 * s for i, s in zip(ids, per)}
