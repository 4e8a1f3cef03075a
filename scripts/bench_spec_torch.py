#!/usr/bin/env python3
"""Prompt-lookup speculative decoding against the plain stream: LLaVA-1.5-7B
single-stream tokens/s on one card.

    python3 scripts/bench_spec_torch.py [--device cuda]

Times `serve/speculative.spec_stream_tokens` (drafts verified by one LM
step of width k + 1) against the plain stream
(`LlavaEvalModel.stream_tokens`, one step a token) on a 7B serving model
(random bf16 weights drawn on the card, weight-only quantized in place,
BENCH_SPEC_BITS 8 or 4). The accept rate depends on the text, and the
weights are random, so the script measures the envelope a drafter lands in:

  reject-all  the floor: every draft is wrong, so a verify step of width
              k + 1 emits one token. Each draft token is derived from the
              plain stream's own next token at that position, plus one
              modulo the vocabulary, so it is never the model's choice and
              the accept rate is exactly 0 (a fixed id such as vocab - 1
              can be a random model's argmax and be accepted);
  accept-all  the ceiling: the drafts are the plain stream's next tokens,
              k + 1 tokens a verify step, accept rate 1;
  pld         the real drafter (prompt lookup), on random-weight text
              (greedy loops repeat n-grams more than natural captions do).

Knobs (environment): BENCH_SPEC_K (7), BENCH_SPEC_NEW (64), BENCH_SPEC_BITS
(8). Warm once, then best of 3 whole streams a config; one JSON line a
config (tokens, wall, tokens/s, verify steps, accept rate, ms a dispatch)
and a summary line last with each config's ratio to the plain stream and
the port kernels the configs launched.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import bench_common_torch as common  # noqa: E402


def _run(model, x01, prompt: str, max_new: int, k: int, drafter, label: str) -> dict:
    """Warm once, then the best of 3 whole streams; prints the row and
    returns it with the streamed ids (`ids`)."""
    from robustvlm_tpu_torch.serve.speculative import spec_stream_tokens

    def once():
        stats = {}
        t0 = time.perf_counter()
        if drafter == "plain":
            ids = [int(t[0]) for t in model.stream_tokens(x01, [prompt], max_new)]
        else:
            ids = [int(t[0]) for t in spec_stream_tokens(model, x01, [prompt], max_new, k=k,
                                                         drafter=None if drafter == "pld" else drafter,
                                                         stats=stats)]
        common.sync(x01.device)
        return ids, time.perf_counter() - t0, stats

    once()  # warm-up
    common.reset_launches()
    best = None
    for _ in range(3):
        ids, dt, stats = once()
        if best is None or dt < best[1]:
            best = (ids, dt, stats)
    ids, dt, stats = best
    row = {"metric": "llava7b_spec_decode", "config": label, "k": k, "tokens": len(ids), "wall_s": dt,
           "tokens_per_sec": len(ids) / dt, "launches": common.launches()}
    if stats:
        row.update(verify_steps=stats["verify_steps"], accept_rate=stats["accept_rate"],
                   ms_per_dispatch=dt / (1 + stats["verify_steps"]) * 1e3)
    else:
        row["ms_per_token"] = dt / len(ids) * 1e3 if ids else None
    common.emit(row)
    return {**row, "ids": ids}


def drafters(model, prompt: str, trace: list):
    """(reject_all, accept_all) drafters over the plain stream's tokens
    `trace`: at a history whose generated part is g tokens long, the true
    continuation is trace[g:]."""
    pre_ids, toks, n_pad = model._tokenize_gen([prompt])
    n_prompt = len(pre_ids) + (toks.shape[1] - int(n_pad[0]))
    vocab = model.tok.vocab_size

    def cont(ids, kk):
        g = len(ids) - n_prompt
        c = list(trace[g:g + kk])
        return c + [0] * (kk - len(c))

    def reject_all(ids, kk):
        return [(t + 1) % vocab for t in cont(ids, kk)]

    def accept_all(ids, kk):
        return cont(ids, kk)

    return reject_all, accept_all


def run_configs(model, x01, prompt: str, max_new: int, k: int) -> dict:
    """The plain stream, reject-all, accept-all and prompt lookup; prints one
    row each and the summary, and returns the summary with the rows."""
    rows = [_run(model, x01, prompt, max_new, k, "plain", "plain_stream")]
    reject_all, accept_all = drafters(model, prompt, rows[0]["ids"])
    rows.append(_run(model, x01, prompt, max_new, k, reject_all, "spec_reject_all"))
    rows.append(_run(model, x01, prompt, max_new, k, accept_all, "spec_accept_all"))
    rows.append(_run(model, x01, prompt, max_new, k, "pld", "spec_pld"))
    plain = rows[0]["tokens_per_sec"]
    launched = {}
    for r in rows:
        for name, n in r["launches"].items():
            launched[name] = launched.get(name, 0) + n
    summary = common.emit({
        "metric": "llava7b_spec_decode_tokens_per_sec",
        "value": rows[3]["tokens_per_sec"],
        "unit": "tokens/s (single stream)",
        "k": k,
        "max_new_tokens": max_new,
        "vs_plain_stream": {r["config"]: r["tokens_per_sec"] / plain for r in rows[1:]},
        "accept_rate": {r["config"]: r["accept_rate"] for r in rows[1:]},
        "note": "floor = reject_all, ceiling = accept_all; pld's acceptance on random-weight text "
                "overstates natural captions",
        "card": common.card(),
        "launches": launched,
    })
    return {**summary, "rows": rows}


def main(argv=None) -> int:
    import numpy as np
    import torch

    from bench_decode_torch import build_serving_model
    from robustvlm_tpu_torch.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(p.parse_args(argv).device)
    k = int(os.environ.get("BENCH_SPEC_K", 7))
    max_new = int(os.environ.get("BENCH_SPEC_NEW", 64))
    bits = int(os.environ.get("BENCH_SPEC_BITS", 8))
    model = build_serving_model(bits, dev)
    s = model.cfg.vision.image_size
    x01 = torch.from_numpy(np.random.RandomState(0).rand(1, 3, s, s).astype(np.float32)).to(dev)
    summary = run_configs(model, x01, model.get_caption_prompt(), max_new, k)
    rates = summary["accept_rate"]
    if rates["spec_reject_all"] != 0.0:
        print(f"reject-all accepted drafts: {rates['spec_reject_all']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
