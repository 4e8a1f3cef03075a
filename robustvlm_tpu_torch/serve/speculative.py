"""Prompt-lookup speculative decoding for the single-stream serving path.

Counterpart of `robustvlm_tpu/serve/speculative.py`. Draft the next k
tokens by copying the continuation of the most recent earlier occurrence of
the current n-gram suffix (prompt-lookup decoding, the n-gram drafter behind
HF assisted generation), then verify all k drafts and take one bonus token
in ONE cached decode step of width k + 1. Every emitted token is the argmax
of the model's logits given the emitted prefix; the drafter only decides how
many of them one step yields. A batch-1 decode step reads every weight once
whatever its width (under int4 every matmul is `q4_matmul`, which takes up
to 32 rows), so an accepted draft saves a weight pass and a step's host
launches, and a rejected one costs the wider step's small extra work.

Token equality with the plain stream is exact on the CPU in float32. On the
card the width-(k+1) step can round differently from the width-1 step
(other GEMM shapes, another key length), so an argmax can flip where two
logits nearly tie.

Cache-slot safety: a verify step at depth `pos` writes KV rows for its k + 1
inputs at slots [pos, pos + k]. Accepting m drafts moves the depth to
pos' = pos + m + 1 and leaves slots [pos', pos + k] stale. The next verify
writes [pos', pos' + k], which covers them, before any attention read
(the llama block writes the cache first), and the slot-indexed causal mask
hides every slot beyond the current query meanwhile, so a stale row is
never read. The cache carries k spill slots past t_prompt + max_new so that
the last verify (which may start at depth t_prompt + max_new - 1) stays in
bounds.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from robustvlm_tpu_torch.models.llava.model import make_llava_decode_fns
from robustvlm_tpu_torch.vlm_eval.eval_models import _decode_fns_of


def draft_prompt_lookup(ids: Sequence[int], k: int, *, max_ngram: int = 3) -> List[int]:
    """Draft k tokens by n-gram lookup over `ids` (the prompt and every token
    generated so far, ending with the token about to be fed): for n from
    max_ngram down to 1, find the MOST RECENT earlier occurrence of the
    last-n-token suffix and return the k tokens that followed it (padded with
    the last token when fewer follow). No match at any n repeats the last
    token: verification makes any draft safe."""
    if k <= 0:
        return []
    ids = list(ids)
    t = len(ids)
    for n in range(min(max_ngram, t - 1), 0, -1):
        suffix = ids[t - n:]
        # latest match strictly before the suffix's own position, with at
        # least one continuation token
        for i in range(t - n - 1, -1, -1):
            if ids[i: i + n] == suffix and i + n < t:
                cont = ids[i + n: i + n + k]
                if len(cont) < k:
                    cont = cont + [ids[-1]] * (k - len(cont))
                return cont
    return [ids[-1]] * k


def _spec_cores(model, x01: torch.Tensor, pre: torch.Tensor, t_prompt: int, max_new: int, k: int):
    """The (prefill, verify) pair of one speculative stream, on the adapter's
    generation weights (int8 KV cache under `quantize_kv`), sharded or not.

    prefill(toks, n_pad) -> (first token (B,), cache)
        the stream prefill, its cache carrying k spill slots.
    verify(toks_k1, cache, pos, n_pad) -> ((B, k + 1) greedy tokens, cache)
        toks_k1 = [last emitted, draft_1 .. draft_k]: one decode step of
        width k + 1 at post slot `pos` (an int). Row j is the model's greedy
        token after toks_k1[:, :j + 1]: row 0 checks draft_1, ..., row k - 1
        checks draft_k, row k is the bonus token."""
    total = t_prompt + max_new + k  # k spill slots for the last verify
    # through sharded_call, as the plain stream: a sharded model's root
    # parameters are gathered for the tower, the splice and the LM head
    pf, df = _decode_fns_of(model._gen_params(), make_llava_decode_fns, x01, pre, max_total_len=total,
                            compute_dtype=model.compute_dtype, kv_bits=8 if model.quantize_kv else 0)
    dev = pre.device
    sl = torch.arange(total, device=dev)[None, :]
    ar = sl[:, :t_prompt]
    steps = torch.arange(k + 1, device=dev)[None, :]

    def prefill(toks, n_pad):
        logits, cache = pf(toks, ar >= n_pad[:, None], torch.clamp(ar - n_pad[:, None], min=0))
        return torch.argmax(logits, dim=-1), cache

    def verify(toks_k1, cache, pos: int, n_pad):
        # valid keys: the past and the k + 1 rows this step writes (each
        # query's causality comes from the slot-indexed mask in the block)
        kv_mask = (sl >= n_pad[:, None]) & (sl < pos + k + 1)
        qpos = (pos - n_pad)[:, None] + steps
        logits, cache = df(toks_k1, cache, pos, kv_mask, qpos)
        return torch.argmax(logits, dim=-1), cache

    return prefill, verify


@torch.no_grad()
def spec_stream_tokens(model, x01: torch.Tensor, prompts: Sequence[str], max_new_tokens: int, *,
                       k: int = 8, max_ngram: int = 3,
                       drafter: Optional[Callable[[Sequence[int], int], List[int]]] = None,
                       stats: Optional[dict] = None):
    """Speculative greedy decode of ONE stream: yields (1,) int32 numpy
    arrays, one per token, the tokens of `model.stream_tokens(x01, prompts,
    max_new_tokens)`, made in bursts of 1 to k + 1 tokens a step. Batch 1
    only (the continuous engine is the batched serving path).

    drafter(history_ids, k) -> k proposed ids, by default
    `draft_prompt_lookup`. stats (a dict) is updated in place with
    verify_steps, emitted and accept_rate (accepted drafts over drafted
    tokens; bonus tokens excluded)."""
    if x01.shape[0] != 1 or len(prompts) != 1:
        raise ValueError(f"speculative decode is single-stream (batch 1); got batch {x01.shape[0]} "
                         "- use the continuous engine for multi-lane")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if drafter is None:
        def drafter(ids, kk):
            return draft_prompt_lookup(ids, kk, max_ngram=max_ngram)

    if stats is not None:
        stats.update({"verify_steps": 0, "emitted": 0, "accept_rate": 0.0})
    if max_new_tokens <= 0:
        return

    pre_ids, toks, n_pad = model._tokenize_gen(prompts)
    t = toks.shape[1]
    dev = model.device
    pre = torch.tensor([pre_ids], dtype=torch.long, device=dev)
    n_pad_dev = torch.from_numpy(n_pad).long().to(dev)
    prefill, verify = _spec_cores(model, x01, pre, t, max_new_tokens, k)
    nxt_dev, cache = prefill(torch.from_numpy(toks).long().to(dev), n_pad_dev)
    eos = model.tok.eos_token_id
    # drafting history: the prompt without its padding and every emitted
    # token (the image splice is invisible to the text drafter)
    history = list(pre_ids) + [int(v) for v in toks[0][int(n_pad[0]):]]
    nxt = int(nxt_dev[0])
    emitted = 0
    pos = t  # next free cache slot in the post region
    steps = 0
    accepted = 0
    try:
        while True:
            yield np.asarray([nxt], np.int32)
            emitted += 1
            if nxt == eos or emitted >= max_new_tokens:
                return
            history.append(nxt)
            draft = list(drafter(history, k))
            if len(draft) != k:
                raise ValueError(f"drafter returned {len(draft)} tokens, expected {k}")
            toks_k1 = torch.tensor([[nxt] + draft], dtype=torch.long, device=dev)
            preds_dev, cache = verify(toks_k1, cache, pos, n_pad_dev)
            preds = preds_dev[0].cpu().numpy()  # (k + 1,), one copy a step
            steps += 1
            m = 0
            while m < k and int(draft[m]) == int(preds[m]):
                m += 1
            accepted += m
            pos += m + 1
            # the m accepted drafts now; the bonus token preds[m] is the next
            # loop-top emission and the next verify's first input
            for j in range(m):
                tok = int(preds[j])
                yield np.asarray([tok], np.int32)
                emitted += 1
                history.append(tok)
                if tok == eos or emitted >= max_new_tokens:
                    return
            nxt = int(preds[m])
    finally:
        if stats is not None:
            stats["verify_steps"] = steps
            stats["emitted"] = emitted
            stats["accept_rate"] = accepted / (steps * k) if steps else 0.0
