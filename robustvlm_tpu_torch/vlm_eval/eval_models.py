"""The LLaVA and OpenFlamingo eval-model adapters: the threat-model layer of
the VLM attacks.

Counterpart of `WordTokenizer`, `truncate_at_stops`, `LlavaEvalModel`,
`FlamingoEvalModel`, `Blip2EvalModel` and `make_frame_mask` in
`robustvlm_tpu/vlm_eval/eval_models.py`: each adapter holds the model and a tokenizer,
builds prompts, caches the tokenized teacher-forcing targets (`set_inputs`),
exposes `__call__(x01) -> (B,) per-sample loss` for the attack loop and
`get_outputs(x01) -> captions` for generation; pixels are unnormalized
[0,1], normalization happens inside the forward.

Tokenizer protocol (duck-typed): encode(str) -> List[int], decode(ids) ->
str, eos_token_id / pad_token_id / bos_token_id. `WordTokenizer` is the
stand-in used without a HF tokenizer.

Serving: generation can run on weight-only quantized LM weights, built
lazily beside the fp model (`quantize_decode`) or in place for a
serving-only process (`quantize_for_serving`), and `stream_tokens` /
`stream_outputs` yield tokens as they are made, one token a step or, with
`speculate=k`, in bursts verified by one step of width k + 1
(`serve/speculative.py`). `quantize_kv` makes generation keep an int8 KV
cache. `LlavaEvalModel._continuous_cores` are the admission and step of the
continuous-batching engine (`serve/continuous.py`).

`remat=True` recomputes each vision and LM block in the backward
(`torch.utils.checkpoint`); the loss and its gradient are those without it.

A model sharded by `parallel/mesh.shard_params` works in every adapter: the
loss, the decode functions and the continuous engine's cores run through
`sharded_call`, which gathers the root's parameters (a plain call on an
unsharded model).
"""

from __future__ import annotations

import dataclasses
import re
import zlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from robustvlm_tpu_torch.models.blip2.model import Blip2, blip2_per_sample_loss, make_blip2_decode_fns
from robustvlm_tpu_torch.models.flamingo.model import (
    Flamingo,
    flamingo_per_sample_loss,
    make_flamingo_decode_fns,
)
from robustvlm_tpu_torch.models.generation import (
    beam_generate,
    greedy_generate,
    greedy_generate_stream,
    left_pad,
    strip_after_eos,
)
from robustvlm_tpu_torch.models.llava.conversation import (
    answer_span,
    get_caption_prompt,
    get_vqa_prompt,
    split_at_image,
)
from robustvlm_tpu_torch.models.llama.model import init_cache, local_kv_heads
from robustvlm_tpu_torch.models.llava.model import (
    Llava,
    llava_decode_step,
    llava_per_sample_loss,
    make_llava_decode_fns,
    to_half_layout_,
)
from robustvlm_tpu_torch.ops.quant import (
    quantize_decode_params_inplace,
    quantize_llama_decode_params,
)
from robustvlm_tpu_torch.parallel.mesh import is_sharded, sharded_call


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


def _generate_texts(adapter, x, prompts, max_new_tokens: int, num_beams: int,
                    length_penalty: float, stop_strings) -> List[str]:
    """Greedy (num_beams 1) or beam decode through the adapter's
    `_decode_fns`, each text cut after EOS and at the first stop string."""
    pf, df, toks, n_pad = adapter._decode_fns(x, prompts, max_new_tokens)
    tok = adapter.tok
    kw = dict(max_new_tokens=max_new_tokens, eos_id=tok.eos_token_id, pad_id=tok.pad_token_id)
    if num_beams == 1:
        res = greedy_generate(pf, df, toks, n_pad, **kw)
    else:
        res = beam_generate(pf, df, toks, n_pad, num_beams=num_beams, length_penalty=length_penalty, **kw)
    return [truncate_at_stops(tok.decode(ids), stop_strings)
            for ids in strip_after_eos(res.tokens, tok.eos_token_id, tok.pad_token_id)]


@dataclasses.dataclass
class _CachedInputs:
    pre: torch.Tensor         # (B, T_pre) prompt tokens before the image
    post: torch.Tensor        # (B, T_post) tokens after the image (incl. answer)
    labels: torch.Tensor      # (B, T_post)
    label_mask: torch.Tensor  # (B, T_post) 1.0 on answer tokens


def _decode_fns_of(model, make_fns, *args, **kwargs):
    """`make_fns(model, *args, **kwargs)` -> (prefill_fn, decode_fn), built
    and called through `sharded_call(model, ...)` (the builders run the
    vision side at once); `reorder_carry` is kept."""
    pf, df = sharded_call(model, make_fns, model, *args, **kwargs)
    if not is_sharded(model):
        return pf, df

    def prefill_fn(*a, **k):
        return sharded_call(model, pf, *a, **k)

    def decode_fn(*a, **k):
        return sharded_call(model, df, *a, **k)

    if hasattr(pf, "reorder_carry"):
        prefill_fn.reorder_carry = pf.reorder_carry
    return prefill_fn, decode_fn


class LlavaEvalModel:
    """`__call__(x)` returns the per-sample HF-style mean CE over the answer
    span. `model` holds its weights in the compute dtype's layout
    (`models/llava/model.half_state` for bfloat16), so nothing is cast per
    forward beyond what the JAX package casts.

    `quantize_decode` (True or 8: int8; 4: packed int4 with group-128
    scales) makes generation run on a weight-only quantized copy of the LM,
    built at the first generation and kept beside the fp model, which the
    loss path goes on using. A serving-only process calls
    `quantize_for_serving` instead: in place, the fp LM weights dropped.
    `quantize_kv` (llama family) makes every generation keep an int8 KV
    cache with per-token scales (`models/llama/model._quantize_kv`)."""

    DEFAULT_STOPS = ("</s>", "USER:")

    def __init__(self, model: Llava, tokenizer, *, compute_dtype=torch.bfloat16,
                 max_post_len: int = 64, remat: bool = False, quantize_decode=False):
        self.model = model
        self.cfg = model.cfg
        self.tok = tokenizer
        self.compute_dtype = compute_dtype
        self.max_post_len = max_post_len
        self.remat = remat
        self._cached: Optional[_CachedInputs] = None
        self.quantize_decode = quantize_decode
        self.quantize_kv = False
        self._decode_model = None  # (bits, Llava) once built
        self._fp_dropped = False

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

    def quantize_for_serving(self, bits: int = 8) -> None:
        """SERVING-ONLY: quantize the LM decode weights in place, leaf by leaf
        (`ops/quant.quantize_decode_params_inplace`), so the device never
        holds the fp and the quantized LM together; then hold the leaves that
        stay fp as the compute dtype's model holds them (`half_state` for
        bfloat16). The fp weights are gone afterwards, so the loss path is
        disabled: the threat model is defined on the fp model."""
        bits = 8 if int(bits) == 1 else int(bits)
        quantize_decode_params_inplace(self.model, bits=bits)
        if self.compute_dtype == torch.bfloat16:
            to_half_layout_(self.model)
        self.quantize_decode = bits
        self._decode_model = (bits, self.model)
        self._fp_dropped = True

    def _require_fp(self) -> None:
        if self._fp_dropped:
            raise RuntimeError(
                "loss/attack path disabled: quantize_for_serving() dropped the fp weights "
                "(serving-only mode); build a fresh model for attacks")

    def __call__(self, x01: torch.Tensor) -> torch.Tensor:
        self._require_fp()
        c = self._cached
        if c is None:
            raise RuntimeError("LlavaEvalModel: call set_inputs first")
        return sharded_call(self.model, llava_per_sample_loss, self.model, x01, c.pre, c.post, c.labels,
                            c.label_mask, compute_dtype=self.compute_dtype, remat=self.remat)

    def _gen_params(self) -> Llava:
        """The model generation runs on: the fp one, or the (cached) weight-only
        quantized one when quantize_decode is set."""
        if not self.quantize_decode:
            return self.model
        bits = int(self.quantize_decode)
        bits = 8 if bits == 1 else bits  # True -> int8
        # keyed on the resolved bits: a change of width after a generation
        # rebuilds instead of serving the stale one
        if self._decode_model is None or self._decode_model[0] != bits:
            if self._fp_dropped:
                raise RuntimeError("cannot requantize to a different width after "
                                   "quantize_for_serving(): the fp weights are gone")
            with torch.no_grad():
                state = quantize_llama_decode_params(self.model.state_dict(), bits=bits)
            # shares every fp tensor with self.model; only the LM leaves are new
            self._decode_model = (bits, Llava.from_state(self.cfg, state))
        return self._decode_model[1]

    def _tokenize_gen(self, prompts):
        """(pre_ids, left-padded post tokens, n_pad). All prompts share the
        pre-image segment (the system prompt): one tower run serves the
        batch."""
        pre_txt, _ = split_at_image(prompts[0])
        pre_ids = [self.tok.bos_token_id] + _encode_plain(self.tok, pre_txt)
        post_seqs = [_encode_plain(self.tok, split_at_image(p)[1]) for p in prompts]
        toks, n_pad = left_pad(post_seqs, self.tok.pad_token_id)
        return pre_ids, toks, n_pad

    def _decode_fns(self, x01, prompts, max_new_tokens):
        """(prefill_fn, decode_fn, post tokens, n_pad) of a generation."""
        pre_ids, toks, n_pad = self._tokenize_gen(prompts)
        dev = self.device
        toks = torch.from_numpy(toks).long().to(dev)
        n_pad = torch.from_numpy(n_pad).long().to(dev)
        pre = torch.tensor([pre_ids] * x01.shape[0], dtype=torch.long, device=dev)
        pf, df = _decode_fns_of(self._gen_params(), make_llava_decode_fns, x01, pre,
                                max_total_len=toks.shape[1] + max_new_tokens,
                                compute_dtype=self.compute_dtype, kv_bits=8 if self.quantize_kv else 0)
        return pf, df, toks, n_pad

    def _continuous_cores(self, n_slots: int, width: int, max_new: int, chunk: int = 1):
        """(admit, step, lanes) of the continuous-batching engine
        (serve/continuous.py): `n_slots` decode lanes, post tokens
        left-padded to `width`, a lane cache of `width + max_new` post slots,
        `chunk` greedy steps a dispatch. Every tensor is made on the
        adapter's device; the caches are stacked (L, B, ...), lanes on axis 1.

        lanes(pre) -> the zeroed batched caches, at the prefill's cache
            length and dtype (int8 under `quantize_kv`).
        admit(x01, pre, toks, n_pad, bcaches, slot) -> first token (1,)
            a batch-1 prefill at the static width whose KV rows are written
            straight into lane `slot` (zeroed first, so no row of an earlier
            occupant stays).
        step(nxt, bcaches, pos, n_pad) -> (n_slots, chunk) tokens
            `chunk` greedy steps of every lane at its own depth `pos` (n_slots,);
            key masks and positions are made on the device from the three
            (n_slots,) operands, and the tokens stay there until the caller
            copies them. A write past the last slot (a lane that is idle or
            past its cap) lands on the last slot, as JAX's clamped update."""
        model, cfg, dtype = self._gen_params(), self.cfg, self.compute_dtype
        kv_bits = 8 if self.quantize_kv else 0
        total = width + max_new
        dev = self.device
        sl = torch.arange(total, device=dev)[None, :]
        ar = sl[:, :width]

        def lanes(pre):
            t_prefix = pre.shape[1] + cfg.n_image_tokens
            return init_cache(cfg.llama, n_slots, max_len=t_prefix + total, dtype=dtype,
                              kv_bits=kv_bits, device=dev, n_kv_heads=local_kv_heads(model.llama))

        def admit_(x01, pre, toks, n_pad, bcaches, slot):
            pf, _ = make_llava_decode_fns(model, x01, pre, max_total_len=total, compute_dtype=dtype,
                                          kv_bits=kv_bits)
            lane = {key: buf[:, slot:slot + 1] for key, buf in bcaches.items()}
            for buf in lane.values():
                buf.zero_()
            logits, _ = pf(toks, ar >= n_pad[:, None], torch.clamp(ar - n_pad[:, None], min=0),
                           cache=lane)
            return torch.argmax(logits, dim=-1)

        def step_(nxt, bcaches, pos, n_pad):
            t_prefix = bcaches["k"].shape[3] - total
            cur, out = nxt, []
            for j in range(chunk):
                p = torch.clamp(pos + j, max=total - 1)
                kv_mask = (sl >= n_pad[:, None]) & (sl <= p[:, None])
                logits, bcaches = llava_decode_step(model, cur[:, None], bcaches, p, kv_mask,
                                                    (p - n_pad)[:, None], t_prefix=t_prefix,
                                                    compute_dtype=dtype)
                cur = torch.argmax(logits[:, -1], dim=-1)
                out.append(cur)
            return torch.stack(out, dim=1)

        def admit(*a):
            return sharded_call(model, admit_, *a)

        def step(*a):
            return sharded_call(model, step_, *a)

        return admit, step, lanes

    @torch.no_grad()
    def stream_tokens(self, x01: torch.Tensor, prompts: Sequence[str], max_new_tokens: int):
        """Greedy decode yielding one (B,) numpy token-id array per step
        (`generation.greedy_generate_stream`)."""
        pf, df, toks, n_pad = self._decode_fns(x01, prompts, max_new_tokens)
        yield from greedy_generate_stream(pf, df, toks, n_pad, max_new_tokens=max_new_tokens,
                                          eos_id=self.tok.eos_token_id,
                                          pad_id=self.tok.pad_token_id)

    @torch.no_grad()
    def get_outputs(self, x01: torch.Tensor, prompts: Sequence[str], *, max_new_tokens: int = 32,
                    num_beams: int = 1, length_penalty: float = 0.0,
                    stop_strings: Sequence[str] = DEFAULT_STOPS) -> List[str]:
        return _generate_texts(self, x01, prompts, max_new_tokens, num_beams, length_penalty,
                               stop_strings)


class FlamingoEvalModel:
    """OpenFlamingo adapter. Prompts follow the reference few-shot format,
    '<image>Output:...<|endofchunk|>' chains; `__call__` returns the
    per-sample SUMMED CE over the answer span, the labels masked up to and
    including the LAST ':' of the prompt (the reference's get_label), and
    <image> / <|endofchunk|> never carry loss. Pixels are (B, T_img, F, C,
    H, W) in [0,1]; a (B, C, H, W) batch is one frame of one media slot.

    `pad_to_multiple` rounds the token length up (end padding leaves the
    loss unchanged: causal attention and masked labels)."""

    DEFAULT_STOPS = ("<|endofchunk|>", "Output:", "Question:")

    def __init__(self, model: Flamingo, tokenizer, *, compute_dtype=torch.bfloat16,
                 remat: bool = False, max_len: int = 128, pad_to_multiple: Optional[int] = None):
        self.model = model
        self.cfg = model.cfg
        self.tok = tokenizer
        self.compute_dtype = compute_dtype
        self.max_len = max_len
        self.remat = remat
        self.pad_to_multiple = pad_to_multiple
        self._lang = self._labels = self._mask = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    def get_caption_prompt(self, caption: Optional[str] = None) -> str:
        c = f" {caption.strip()}<|endofchunk|>" if caption else ""
        return f"<image>Output:{c}"

    def get_vqa_prompt(self, question: str, answer: Optional[str] = None) -> str:
        a = f" {answer.strip()}<|endofchunk|>" if answer else ""
        return f"<image>Question:{question.strip()} Short answer:{a}"

    def _encode(self, text: str) -> List[int]:
        """Split ONLY on <image> and <|endofchunk|> and encode each plain
        segment in one call (BPE tokenizers are whitespace-sensitive, and the
        reference tokenizes the whole prompt with both markers registered as
        special tokens)."""
        out = []
        for seg in re.split(r"(<image>|<\|endofchunk\|>)", text):
            if seg == "<image>":
                out.append(self.cfg.media_token_id)
            elif seg == "<|endofchunk|>":
                out.append(self.tok.eos_token_id)
            elif seg:
                out.extend(_encode_plain(self.tok, seg))
        return out

    def set_inputs(self, full_prompts: Sequence[str]) -> None:
        """Tokenize teacher-forcing prompts: the context up to the last ':'
        and the answer after it as separate segments, so the answer mask is
        exact in token space; right-padded to the longest (rounded up to
        `pad_to_multiple`), at most `max_len`."""
        langs, masks = [], []
        special = (self.cfg.media_token_id, self.tok.eos_token_id)
        for p in full_prompts:
            marker = p.rfind(":")
            if marker >= 0:
                ctx_ids, ans_ids = self._encode(p[:marker + 1]), self._encode(p[marker + 1:])
            else:
                ctx_ids, ans_ids = [], self._encode(p)
            ids = ctx_ids + ans_ids
            m = [0.0] * len(ctx_ids) + [1.0] * len(ans_ids)
            langs.append(ids)
            masks.append([0.0 if t in special else w for t, w in zip(ids, m)])
        t = max(len(x) for x in langs)
        if self.pad_to_multiple:
            t = -(-t // self.pad_to_multiple) * self.pad_to_multiple
        t = min(t, self.max_len)
        lang_arr, _ = _pad_right(langs, self.tok.pad_token_id, t)
        mask_arr = np.zeros((len(langs), t), np.float32)
        for i, m in enumerate(masks):
            m = m[:t]
            mask_arr[i, :len(m)] = m
        dev = self.device
        self._lang = torch.from_numpy(lang_arr).long().to(dev)
        self._labels = self._lang
        self._mask = torch.from_numpy(mask_arr).to(dev)

    def __call__(self, vision_x: torch.Tensor) -> torch.Tensor:
        if self._lang is None:
            raise RuntimeError("FlamingoEvalModel: call set_inputs first")
        if vision_x.dim() == 4:  # (B, C, H, W) -> (B, T=1, F=1, C, H, W)
            vision_x = vision_x[:, None, None]
        return sharded_call(self.model, flamingo_per_sample_loss, self.model, vision_x, self._lang,
                            self._labels, self._mask, compute_dtype=self.compute_dtype, remat=self.remat)

    def _decode_fns(self, vision_x, prompts, max_new_tokens):
        """(prefill_fn, decode_fn, left-padded tokens, n_pad) of a generation."""
        if vision_x.dim() == 4:
            vision_x = vision_x[:, None, None]
        toks, n_pad = left_pad([self._encode(p) for p in prompts], self.tok.pad_token_id)
        dev = self.device
        pf, df = _decode_fns_of(self.model, make_flamingo_decode_fns, vision_x,
                                max_total_len=toks.shape[1] + max_new_tokens,
                                compute_dtype=self.compute_dtype)
        return pf, df, torch.from_numpy(toks).long().to(dev), torch.from_numpy(n_pad).long().to(dev)

    @torch.no_grad()
    def get_outputs(self, vision_x: torch.Tensor, prompts: Sequence[str], *, max_new_tokens: int = 32,
                    num_beams: int = 1, length_penalty: float = 0.0,
                    stop_strings: Sequence[str] = DEFAULT_STOPS) -> List[str]:
        return _generate_texts(self, vision_x, prompts, max_new_tokens, num_beams, length_penalty,
                               stop_strings)


class Blip2EvalModel:
    """BLIP-2 adapter. The reference wraps BLIP-2 for generation only; this
    adapter also gives the adversarial protocol (`set_inputs` + the
    per-sample mean CE over the answer), so BLIP-2 is attacked like the
    other families. One image per example. `model` holds its weights in the
    compute dtype's layout (`models/blip2/model.half_state` for bfloat16).

    `pure(model, tokens, labels, mask, x01)` is the loss as a function of
    its operands and `bound_args` the operands held here, so
    `pure(*bound_args, x01)` is `__call__(x01)`."""

    DEFAULT_STOPS = ("Question:", "\n")

    def __init__(self, model: Blip2, tokenizer, *, compute_dtype=torch.float32,
                 remat: bool = False, max_len: int = 64):
        self.model = model
        self.cfg = model.cfg
        self.tok = tokenizer
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.max_len = max_len
        self._cached = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    def get_caption_prompt(self, caption: Optional[str] = None) -> str:
        return f"A photo of {caption if caption is not None else ''}"

    def get_vqa_prompt(self, question: str, answer: Optional[str] = None) -> str:
        return f"Question:{question} Short answer:{answer if answer is not None else ''}"

    @staticmethod
    def _answer_split(prompt: str):
        """(context, answer), split at the prompt's MARKER and not at any
        colon: answers like '4:30' and captions with a ':' stay whole."""
        vqa_marker = " Short answer:"
        i = prompt.rfind(vqa_marker)
        if i >= 0:
            cut = i + len(vqa_marker)
            return prompt[:cut], prompt[cut:]
        cap_marker = "A photo of "
        if prompt.startswith(cap_marker):
            return cap_marker, prompt[len(cap_marker):]
        return "", prompt

    def set_inputs(self, full_prompts: Sequence[str]) -> None:
        """BOS + context + answer + EOS, right-padded to `max_len`, the loss
        mask over the answer and EOS."""
        bos = getattr(self.tok, "bos_token_id", None)
        toks, masks = [], []
        for p in full_prompts:
            ctx, ans = self._answer_split(p)
            ctx_ids = ([bos] if bos is not None else []) + _encode_plain(self.tok, ctx)
            ans_ids = _encode_plain(self.tok, ans) + [self.tok.eos_token_id]
            toks.append(ctx_ids + ans_ids)
            masks.append([0.0] * len(ctx_ids) + [1.0] * len(ans_ids))
        arr, _ = _pad_right(toks, self.tok.pad_token_id, self.max_len)
        mask_arr = np.zeros(arr.shape, np.float32)
        for i, m in enumerate(masks):
            m = m[: self.max_len]
            mask_arr[i, : len(m)] = m
        tokens = torch.from_numpy(arr).long().to(self.device)
        self._cached = (tokens, tokens, torch.from_numpy(mask_arr).to(self.device))

    def pure(self, model: Blip2, tokens, labels, mask, x01: torch.Tensor) -> torch.Tensor:
        return sharded_call(model, blip2_per_sample_loss, model, x01, tokens, labels, mask,
                            compute_dtype=self.compute_dtype, remat=self.remat)

    @property
    def bound_args(self) -> tuple:
        if self._cached is None:
            raise RuntimeError("Blip2EvalModel: call set_inputs first")
        return (self.model, *self._cached)

    def __call__(self, x01: torch.Tensor) -> torch.Tensor:
        return self.pure(*self.bound_args, x01)

    def _decode_fns(self, x01, prompts, max_new_tokens):
        """(prefill_fn, decode_fn, left-padded tokens, n_pad) of a generation."""
        bos = getattr(self.tok, "bos_token_id", None)
        seqs = [([bos] if bos is not None else []) + _encode_plain(self.tok, p) for p in prompts]
        toks, n_pad = left_pad(seqs, self.tok.pad_token_id)
        pf, df = _decode_fns_of(self.model, make_blip2_decode_fns, x01,
                                max_total_len=toks.shape[1] + max_new_tokens, compute_dtype=self.compute_dtype)
        dev = self.device
        return pf, df, torch.from_numpy(toks).long().to(dev), torch.from_numpy(n_pad).long().to(dev)

    @torch.no_grad()
    def get_outputs(self, x01: torch.Tensor, prompts: Sequence[str], *, max_new_tokens: int = 32,
                    num_beams: int = 1, length_penalty: float = 0.0,
                    stop_strings: Sequence[str] = DEFAULT_STOPS) -> List[str]:
        return _generate_texts(self, x01, prompts, max_new_tokens, num_beams, length_penalty,
                               stop_strings)


def stream_outputs(model, x01: torch.Tensor, prompt: str, *, max_new_tokens: int = 32,
                   stop_strings: Optional[Sequence[str]] = None, speculate: int = 0):
    """Yield the cumulative decoded text of ONE example as greedy tokens
    arrive (the serving stream path), through the adapter's `_decode_fns`.
    speculate=k > 0 routes an adapter with `stream_tokens` through
    prompt-lookup speculative decoding (`serve/speculative.py`: greedy
    verification, 1 to k + 1 tokens a step)."""
    stops = tuple(stop_strings) if stop_strings is not None else model.DEFAULT_STOPS
    if speculate and hasattr(model, "stream_tokens"):
        from robustvlm_tpu_torch.serve.speculative import spec_stream_tokens

        gen = spec_stream_tokens(model, x01, [prompt], max_new_tokens, k=speculate)
    else:
        pf, df, toks, n_pad = model._decode_fns(x01, [prompt], max_new_tokens)
        gen = greedy_generate_stream(pf, df, toks, n_pad, max_new_tokens=max_new_tokens,
                                     eos_id=model.tok.eos_token_id, pad_id=model.tok.pad_token_id)
    ids: List[int] = []
    for step in gen:
        t_id = int(step[0])
        if t_id in (model.tok.eos_token_id, model.tok.pad_token_id):
            break
        ids.append(t_id)
        raw = model.tok.decode(ids)
        if any(st in raw for st in stops):
            yield truncate_at_stops(raw, stops)
            return
        yield raw.strip()


def make_frame_mask(vision_x_shape, mask_out: str = "context") -> torch.Tensor:
    """float32 gradient mask (on the CPU) over the few-shot media frames of
    a (B, T_img, F, C, H, W) input (the reference's _set_mask): 'context'
    zeroes every frame but the LAST (only the query is attacked); 'query'
    zeroes ONLY the last (only the context is attacked); an int k zeroes
    only frame k; 'only:k' zeroes every frame but k; 'none' attacks
    everything."""
    mask = np.ones(vision_x_shape, np.float32)
    t = vision_x_shape[1]
    if mask_out == "context":
        mask[:, :t - 1] = 0.0
    elif mask_out == "query":
        mask[:, t - 1] = 0.0
    elif isinstance(mask_out, str) and mask_out.startswith("only:"):
        k = int(mask_out[len("only:"):])
        mask[:, :k] = 0.0
        mask[:, k + 1:] = 0.0
    elif mask_out != "none":
        mask[:, int(mask_out)] = 0.0
    return torch.from_numpy(mask)
