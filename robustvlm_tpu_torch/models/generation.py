"""Autoregressive generation: greedy and beam decode with a KV cache.

Counterpart of `robustvlm_tpu/models/generation.py` (the JAX scans become
Python loops over one-token decode steps). Prompts are LEFT-padded so every
example writes cache slot T + i at step i; a key-validity mask hides the
pad slots. Model-agnostic: driven by a `prefill_fn` / `decode_fn` pair
(`models/llava/model.make_llava_decode_fns`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


def left_pad(seqs: Sequence[Sequence[int]], pad_id: int = 0,
             length: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """-> (tokens (B, T) left-padded, n_pad (B,))."""
    t = length or max(len(s) for s in seqs)
    out = np.full((len(seqs), t), pad_id, np.int32)
    n_pad = np.zeros((len(seqs),), np.int32)
    for i, s in enumerate(seqs):
        s = list(s)[-t:]
        out[i, t - len(s):] = s
        n_pad[i] = t - len(s)
    return out, n_pad


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # (B, max_new_tokens) generated ids (pad after EOS)
    scores: torch.Tensor  # (B,) sequence log-prob (length-penalized for beam)


def _start(prefill_fn, prompt_tokens, n_pad, max_new_tokens):
    """Prefill, and the (B, T + max_new) key mask with the prompt's valid
    slots set."""
    b, t = prompt_tokens.shape
    ar = torch.arange(t, device=prompt_tokens.device)[None, :]
    kv_valid0 = ar >= n_pad[:, None]
    positions = torch.clamp(ar - n_pad[:, None], min=0)
    logits, cache = prefill_fn(prompt_tokens, kv_valid0, positions)
    pad = torch.zeros(b, max_new_tokens, dtype=torch.bool, device=prompt_tokens.device)
    return logits, cache, torch.cat([kv_valid0, pad], dim=1)


@torch.no_grad()
def greedy_generate(prefill_fn: Callable, decode_fn: Callable, prompt_tokens: torch.Tensor,
                    n_pad: torch.Tensor, *, max_new_tokens: int, eos_id: int,
                    pad_id: int = 0) -> GenerateResult:
    """prefill_fn(tokens, kv_mask, positions) -> (logits_last (B, V), cache);
    decode_fn(tok (B, 1), cache, pos, kv_mask, positions) -> (logits, cache)."""
    b, t = prompt_tokens.shape
    logits, cache, kv_mask = _start(prefill_fn, prompt_tokens, n_pad, max_new_tokens)
    done = torch.zeros(b, dtype=torch.bool, device=logits.device)
    logp = torch.zeros(b, dtype=torch.float32, device=logits.device)
    toks = []
    for i in range(max_new_tokens):
        nxt = torch.argmax(logits, dim=-1)
        lp = torch.log_softmax(logits, dim=-1)
        logp = logp + torch.where(done, 0.0, torch.gather(lp, 1, nxt[:, None])[:, 0])
        nxt = torch.where(done, pad_id, nxt)
        done = done | (nxt == eos_id)
        toks.append(nxt)
        kv_mask[:, t + i] = True
        qpos = (t + i - n_pad)[:, None]
        logits, cache = decode_fn(nxt[:, None], cache, t + i, kv_mask, qpos)
        logits = logits[:, -1]
    return GenerateResult(tokens=torch.stack(toks, dim=1), scores=logp)


@torch.no_grad()
def beam_generate(prefill_fn: Callable, decode_fn: Callable, prompt_tokens: torch.Tensor,
                  n_pad: torch.Tensor, *, max_new_tokens: int, eos_id: int,
                  num_beams: int = 3, length_penalty: float = 0.0,
                  pad_id: int = 0) -> GenerateResult:
    """Batched beam search with HF-style length penalty (score = logp /
    len**length_penalty). Cache rows (axis 1 of the (L, B, ...) buffers) are
    reordered each step."""
    b, t = prompt_tokens.shape
    nb = num_beams
    dev = prompt_tokens.device
    tokens_r = prompt_tokens.repeat_interleave(nb, dim=0)
    n_pad_r = n_pad.repeat_interleave(nb, dim=0)
    logits, cache, kv_mask = _start(prefill_fn, tokens_r, n_pad_r, max_new_tokens)

    # beam 0 starts at 0, the others at -1e9: the first expansion picks the
    # top-nb continuations of beam 0
    beam_lp = torch.cat([torch.zeros(1), torch.full((nb - 1,), -1e9)]).repeat(b).to(dev)
    done = torch.zeros(b * nb, dtype=torch.bool, device=dev)
    out_toks = torch.full((b * nb, max_new_tokens), pad_id, dtype=torch.long, device=dev)
    for i in range(max_new_tokens):
        lp = torch.log_softmax(logits, dim=-1)
        v = lp.shape[-1]
        # finished beams only propose EOS at score 0 (their score frozen)
        frozen = torch.full_like(lp, -1e9)
        frozen[:, eos_id] = 0.0
        lp = torch.where(done[:, None], frozen, lp)
        cand = (beam_lp[:, None] + lp).reshape(b, nb * v)
        top_lp, top_idx = torch.topk(cand, nb, dim=-1)
        src_beam = top_idx // v
        tok = top_idx % v
        gather = (torch.arange(b, device=dev)[:, None] * nb + src_beam).reshape(-1)

        cache = {k: buf[:, gather] for k, buf in cache.items()}
        kv_mask = kv_mask[gather]
        out_toks = out_toks[gather]
        done = done[gather]
        tok_flat = torch.where(done, pad_id, tok.reshape(-1))
        out_toks[:, i] = tok_flat
        beam_lp = top_lp.reshape(-1)
        done = done | (tok_flat == eos_id)

        kv_mask[:, t + i] = True
        qpos = (t + i - n_pad_r)[:, None]
        logits, cache = decode_fn(tok_flat[:, None], cache, t + i, kv_mask, qpos)
        logits = logits[:, -1]

    lengths = (out_toks != pad_id).sum(dim=1).float()
    score = beam_lp / torch.clamp(lengths, min=1.0) ** length_penalty
    best = torch.argmax(score.reshape(b, nb), dim=1)
    sel = torch.arange(b, device=dev) * nb + best
    return GenerateResult(tokens=out_toks[sel], scores=score[sel])


def strip_after_eos(tokens, eos_id: int, pad_id: int = 0):
    """Token lists truncated at the first EOS (or pad)."""
    out = []
    for row in np.asarray(tokens.cpu() if torch.is_tensor(tokens) else tokens):
        ids = []
        for t in row:
            if t == eos_id or t == pad_id:
                break
            ids.append(int(t))
        out.append(ids)
    return out
