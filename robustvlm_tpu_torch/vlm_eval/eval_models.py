"""The LLaVA eval-model adapter: the threat-model layer of the VLM attacks.

Counterpart of `WordTokenizer`, `truncate_at_stops` and `LlavaEvalModel` in
`robustvlm_tpu/vlm_eval/eval_models.py`: holds the model and a tokenizer,
builds prompts, caches the tokenized teacher-forcing targets (`set_inputs`),
exposes `__call__(x01) -> (B,) per-sample loss` for the attack loop and
`get_outputs(x01) -> captions` for generation; pixels are unnormalized
[0,1], normalization happens inside the forward.

Tokenizer protocol (duck-typed): encode(str) -> List[int], decode(ids) ->
str, eos_token_id / pad_token_id / bos_token_id. `WordTokenizer` is the
stand-in used without a HF tokenizer.

Not ported here: the streaming and continuous-batching cores and the
weight-quantized decode (serving, ROADMAP A13); the OpenFlamingo and BLIP-2
adapters (ROADMAP A11, A12).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from robustvlm_tpu_torch.models.generation import (
    beam_generate,
    greedy_generate,
    left_pad,
    strip_after_eos,
)
from robustvlm_tpu_torch.models.llava.conversation import (
    answer_span,
    get_caption_prompt,
    get_vqa_prompt,
    split_at_image,
)
from robustvlm_tpu_torch.models.llava.model import (
    Llava,
    llava_per_sample_loss,
    make_llava_decode_fns,
)


class WordTokenizer:
    """Deterministic whitespace/hash tokenizer; reserves ids 0 = pad,
    1 = bos, 2 = eos, vocab-1 = <image> media token."""

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size
        self.pad_token_id = 0
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.media_token_id = vocab_size - 1

    def encode(self, text: str) -> List[int]:
        out = []
        for w in text.strip().split():
            if w == "<image>":
                out.append(self.media_token_id)
            else:
                out.append(3 + zlib.crc32(w.encode()) % (self.vocab_size - 5))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        return " ".join(f"tok{int(i)}" for i in ids)


def truncate_at_stops(text: str, stop_strings) -> str:
    """Truncate decoded text at the first stop string (the reference halts
    generation at conversation separators)."""
    for stop in stop_strings or ():
        idx = text.find(stop)
        if idx >= 0:
            text = text[:idx]
    return text.strip()


def _encode_plain(tok, text: str) -> List[int]:
    """One tokenizer call without the tokenizer's own special tokens (the
    adapter adds BOS/EOS itself). HF tokenizers take add_special_tokens;
    the stand-ins do not."""
    try:
        return list(tok.encode(text, add_special_tokens=False))
    except TypeError:
        return list(tok.encode(text))


def _pad_right(seqs: Sequence[Sequence[int]], pad: int, length: int):
    out = np.full((len(seqs), length), pad, np.int32)
    mask = np.zeros((len(seqs), length), np.float32)
    for i, s in enumerate(seqs):
        s = list(s)[:length]
        out[i, : len(s)] = s
        mask[i, : len(s)] = 1.0
    return out, mask


@dataclasses.dataclass
class _CachedInputs:
    pre: torch.Tensor         # (B, T_pre) prompt tokens before the image
    post: torch.Tensor        # (B, T_post) tokens after the image (incl. answer)
    labels: torch.Tensor      # (B, T_post)
    label_mask: torch.Tensor  # (B, T_post) 1.0 on answer tokens


class LlavaEvalModel:
    """`__call__(x)` returns the per-sample HF-style mean CE over the answer
    span. `model` holds its weights in the compute dtype's layout
    (`models/llava/model.half_state` for bfloat16), so nothing is cast per
    forward beyond what the JAX package casts."""

    DEFAULT_STOPS = ("</s>", "USER:")

    def __init__(self, model: Llava, tokenizer, *, compute_dtype=torch.bfloat16,
                 max_post_len: int = 64, remat: bool = False, quantize_decode=False):
        if remat:
            raise NotImplementedError("LlavaEvalModel: remat is not ported (ROADMAP A7, training)")
        if quantize_decode:
            raise NotImplementedError(
                "LlavaEvalModel: quantized decode is not ported (ROADMAP A13, serving)")
        self.model = model
        self.cfg = model.cfg
        self.tok = tokenizer
        self.compute_dtype = compute_dtype
        self.max_post_len = max_post_len
        self._cached: Optional[_CachedInputs] = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    def get_caption_prompt(self, caption: Optional[str] = None) -> str:
        return get_caption_prompt(caption)

    def get_vqa_prompt(self, question: str, answer: Optional[str] = None) -> str:
        return get_vqa_prompt(question, answer)

    def set_inputs(self, full_prompts: Sequence[str]) -> None:
        """Tokenize teacher-forcing prompts; the loss is masked to the span
        after the last 'ASSISTANT:'."""
        pres, posts, masks = [], [], []
        for p in full_prompts:
            pre_txt, post_txt = split_at_image(p)
            ctx, ans = answer_span(post_txt)
            pre_ids = [self.tok.bos_token_id] + _encode_plain(self.tok, pre_txt)
            ctx_ids = _encode_plain(self.tok, ctx)
            ans_ids = _encode_plain(self.tok, ans) + [self.tok.eos_token_id]
            pres.append(pre_ids)
            posts.append(ctx_ids + ans_ids)
            masks.append([0.0] * len(ctx_ids) + [1.0] * len(ans_ids))
        t_pre = max(len(p) for p in pres)
        pre_arr, _ = _pad_right(pres, self.tok.pad_token_id, t_pre)
        post_arr, valid = _pad_right(posts, self.tok.pad_token_id, self.max_post_len)
        mask_arr = np.zeros_like(valid)
        for i, m in enumerate(masks):
            m = m[: self.max_post_len]
            mask_arr[i, : len(m)] = m
        dev = self.device
        post = torch.from_numpy(post_arr).long().to(dev)
        self._cached = _CachedInputs(
            pre=torch.from_numpy(pre_arr).long().to(dev), post=post, labels=post,
            label_mask=torch.from_numpy(mask_arr).to(dev),
        )

    def __call__(self, x01: torch.Tensor) -> torch.Tensor:
        c = self._cached
        if c is None:
            raise RuntimeError("LlavaEvalModel: call set_inputs first")
        return llava_per_sample_loss(self.model, x01, c.pre, c.post, c.labels, c.label_mask,
                                     compute_dtype=self.compute_dtype)

    def _tokenize_gen(self, prompts):
        """(pre_ids, left-padded post tokens, n_pad). All prompts share the
        pre-image segment (the system prompt): one tower run serves the
        batch."""
        pre_txt, _ = split_at_image(prompts[0])
        pre_ids = [self.tok.bos_token_id] + _encode_plain(self.tok, pre_txt)
        post_seqs = [_encode_plain(self.tok, split_at_image(p)[1]) for p in prompts]
        toks, n_pad = left_pad(post_seqs, self.tok.pad_token_id)
        return pre_ids, toks, n_pad

    @torch.no_grad()
    def get_outputs(self, x01: torch.Tensor, prompts: Sequence[str], *, max_new_tokens: int = 32,
                    num_beams: int = 1, length_penalty: float = 0.0,
                    stop_strings: Sequence[str] = DEFAULT_STOPS) -> List[str]:
        pre_ids, toks, n_pad = self._tokenize_gen(prompts)
        dev = self.device
        toks = torch.from_numpy(toks).long().to(dev)
        n_pad = torch.from_numpy(n_pad).long().to(dev)
        pre = torch.tensor([pre_ids] * x01.shape[0], dtype=torch.long, device=dev)
        pf, df = make_llava_decode_fns(self.model, x01, pre,
                                       max_total_len=toks.shape[1] + max_new_tokens,
                                       compute_dtype=self.compute_dtype)
        kw = dict(max_new_tokens=max_new_tokens, eos_id=self.tok.eos_token_id,
                  pad_id=self.tok.pad_token_id)
        if num_beams == 1:
            res = greedy_generate(pf, df, toks, n_pad, **kw)
        else:
            res = beam_generate(pf, df, toks, n_pad, num_beams=num_beams,
                                length_penalty=length_penalty, **kw)
        return [truncate_at_stops(self.tok.decode(ids), stop_strings)
                for ids in strip_after_eos(res.tokens, self.tok.eos_token_id,
                                           self.tok.pad_token_id)]

    def stream_tokens(self, x01, prompts, max_new_tokens):
        raise NotImplementedError("stream_tokens: streaming is not ported (ROADMAP A13, serving)")

    def quantize_for_serving(self, bits: int = 8) -> None:
        raise NotImplementedError("quantize_for_serving is not ported (ROADMAP A13, serving)")
