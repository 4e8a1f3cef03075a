"""CLIP byte-pair-encoding tokenizer (native implementation).

The port's own copy of `robustvlm_tpu/models/clip/tokenizer.py` (the port
imports nothing of the JAX package).

Replaces the reference's external `open_clip.tokenize` dependency
(SURVEY.md §2.7; reference uses open_clip's SimpleTokenizer, itself the
openai CLIP tokenizer) with a from-scratch implementation of the same
algorithm: byte-level BPE over a 16e6-merge vocabulary, lowercasing +
whitespace cleanup, `<|startoftext|> tokens <|endoftext|>` framing, and
padding/truncation to the 77-token context.

The merges file (`bpe_simple_vocab_16e6.txt.gz`, shipped with every CLIP
distribution) is loaded from a user-provided path or from
$CLIP_BPE_PATH; without it, `HashTokenizer` provides a deterministic
stand-in for tests (same interface, same special-token framing) so the
full pipeline is exercisable with randomly initialized models.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import List, Optional, Sequence, Union

import numpy as np

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte -> unicode-char table (the GPT-2/CLIP trick): printable
    chars map to themselves, the rest shift into unused codepoints so every
    byte string becomes a valid unicode string with no whitespace bytes."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    """The CLIP BPE tokenizer. `bpe_path` points to bpe_simple_vocab_16e6.txt.gz
    (or the uncompressed text); defaults to $CLIP_BPE_PATH."""

    def __init__(self, bpe_path: Optional[str] = None, context_length: int = 77):
        bpe_path = bpe_path or os.environ.get("CLIP_BPE_PATH", "")
        if not bpe_path or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                "CLIP BPE merges file not found; pass bpe_path or set "
                "$CLIP_BPE_PATH to bpe_simple_vocab_16e6.txt.gz"
            )
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if bpe_path.endswith(".gz"):
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                merge_lines = f.read().split("\n")
        else:
            with open(bpe_path, encoding="utf-8") as f:
                merge_lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in merge_lines[1 : 49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend([SOT_TEXT, EOT_TEXT])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
            if _HAS_REGEX
            else r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )
        self.sot = self.encoder[SOT_TEXT]
        self.eot = self.encoder[EOT_TEXT]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )

    def __call__(self, texts: Union[str, Sequence[str]]) -> np.ndarray:
        """Tokenize to a (B, context_length) int32 array: SOT + bpe + EOT,
        truncated (keeping EOT last) and zero-padded — open_clip semantics."""
        if isinstance(texts, str):
            texts = [texts]
        n = self.context_length
        result = np.zeros((len(texts), n), np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot] + self.encode(text) + [self.eot]
            if len(toks) > n:
                toks = toks[: n - 1] + [self.eot]
            result[i, : len(toks)] = toks
        return result


try:  # the canonical pattern uses unicode properties; fall back to ASCII classes
    import regex as _regex  # noqa: F401

    _HAS_REGEX = True
    re = _regex  # type: ignore[assignment]
except ImportError:
    _HAS_REGEX = False


class HashTokenizer:
    """Deterministic stand-in tokenizer (tests / random-weight pipelines).

    Same interface and framing as SimpleTokenizer but maps each whitespace
    word to a stable hash bucket. NOT compatible with pretrained weights.
    """

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def encode(self, text: str) -> List[int]:
        import zlib

        words = whitespace_clean(basic_clean(text)).lower().split(" ")
        return [
            zlib.crc32(w.encode()) % (self.vocab_size - 2) for w in words if w
        ]

    def __call__(self, texts: Union[str, Sequence[str]]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        n = self.context_length
        result = np.zeros((len(texts), n), np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot] + self.encode(text) + [self.eot]
            if len(toks) > n:
                toks = toks[: n - 1] + [self.eot]
            result[i, : len(toks)] = toks
        return result


def get_tokenizer(
    bpe_path: Optional[str] = None, context_length: int = 77,
    vocab_size: int = 49408,
) -> Union[SimpleTokenizer, HashTokenizer]:
    """SimpleTokenizer when a merges file is available, HashTokenizer
    (over the model's `vocab_size`: torch indexing raises out of range
    where a JAX gather clamps) otherwise. An EXPLICIT bpe_path that doesn't resolve is an error —
    silently hashing tokens against pretrained weights would return
    near-chance eval numbers with no hint why."""
    try:
        return SimpleTokenizer(bpe_path, context_length)
    except FileNotFoundError:
        explicit = bpe_path or os.environ.get("CLIP_BPE_PATH", "")
        if explicit:
            raise FileNotFoundError(
                f"BPE merges file not found at {explicit!r}; fix the path "
                "(or unset it to use the test-only HashTokenizer)"
            )
        return HashTokenizer(vocab_size=vocab_size, context_length=context_length)
