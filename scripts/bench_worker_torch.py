#!/usr/bin/env python3
"""The serving worker end to end on one card: HTTP -> controller -> worker
-> decode, on localhost.

    python3 scripts/bench_worker_torch.py [--device cuda]

`bench_decode_torch.py` times the generation path alone; this script times
what a client of the port's serving stack gets (`serve/controller.py`
proxying to `serve/model_worker.py`), through real HTTP on 127.0.0.1
ephemeral ports:

  1. /worker_generate, one client, no batching window: latency and tokens/s
     at batch 1 (HTTP, base64 PNG decode, tokenizing and the host's share
     on top of the decode);
  2. /worker_generate_stream, one client: time to the first chunk and the
     steady ms a token (a chunk a token);
  3. /worker_generate under c concurrent clients (c in {2, 4, 8}) against a
     worker whose window batcher (`_Batcher`, 30 ms window) pads to
     max_batch = c: aggregate emitted tokens/s and latencies;
  4. staggered arrivals (client i starts i x BENCH_WORKER_STAGGER_S late,
     then sends its requests back to back) against the continuous-batching
     engine (`serve/continuous.py`: requests join the running decode batch)
     and against the window batcher under the same schedule.

Tokens are counted from the response text (the bench model's
`WordTokenizer` decodes one word a token), so a lane that stops early is
credited only with what it emitted, in every mode. Model: LLaVA-1.5-7B at
full width, random bf16 weights drawn on the card, quantized in place for
serving (`quantize_for_serving`, BENCH_WORKER_BITS: 8 or 4, whose products
run the port's `q4_matmul`).

Knobs (environment): BENCH_WORKER_BITS (8), BENCH_WORKER_NEW (64),
BENCH_WORKER_STREAM_NEW (32), BENCH_WORKER_CONC (2,4,8; empty skips),
BENCH_WORKER_REQS (3), BENCH_WORKER_KVQ=1 (int8 KV cache), BENCH_WORKER_CB
(4; lane counts of stage 4, empty skips), BENCH_WORKER_CB_CHUNK (8 decode
steps a dispatch), BENCH_WORKER_STAGGER_S (0.25), BENCH_WORKER_SINGLE=0
(skips stages 1-2). One JSON line a stage, each with the port kernels it
launched, and a summary line last; a stage that fails prints its error,
the others still run, and the script then exits 1.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import sys
import threading
import time
import urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import bench_common_torch as common  # noqa: E402

MODEL_NAME = "llava-7b-bench"


def _png_b64(size: int, seed: int = 0) -> str:
    """A random RGB PNG at the model's resolution, base64: the worker's real
    image path (PIL decode and transform), as a browser client sends it."""
    import numpy as np
    from PIL import Image

    rgb = (np.random.RandomState(seed).rand(size, size, 3) * 255).astype("uint8")
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(url: str, payload: dict, timeout: float = 3600.0) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _stream_times(url: str, payload: dict, timeout: float = 3600.0):
    """POST to a /worker_generate_stream URL; -> (t_first_chunk_s, t_total_s,
    n_chunks) from the send. Each NDJSON chunk is one new token."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    t_first = None
    n = 0
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for line in r:
            if not line.strip():
                continue
            chunk = json.loads(line)
            if chunk.get("error_code") or "error" in chunk:
                raise RuntimeError(chunk.get("error", "stream error"))
            if t_first is None:
                t_first = time.perf_counter() - t0
            n += 1
    return t_first, time.perf_counter() - t0, n


class Stack:
    """The port's controller and one worker on 127.0.0.1 ephemeral ports,
    the worker registered; `url` is the controller's."""

    def __init__(self, worker):
        from robustvlm_tpu_torch.serve import controller as C
        from robustvlm_tpu_torch.serve import model_worker as MW

        self.servers = [C.serve("127.0.0.1", 0), MW.serve_worker(worker, "127.0.0.1", 0)]
        for srv in self.servers:
            threading.Thread(target=srv.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.servers[0].server_address[1]}"
        worker.worker_address = f"http://127.0.0.1:{self.servers[1].server_address[1]}"
        if not _post(self.url + "/register_worker", {"worker_name": worker.worker_address,
                                                     "check_heart_beat": False})["exist"]:
            raise RuntimeError("the worker did not register with the controller")

    def shutdown(self):
        for srv in self.servers:
            srv.shutdown()
            srv.server_close()


def _serve(model, *, image_size: int, window_ms: float, max_batch: int):
    """A worker (window batcher when window_ms > 0) behind the controller;
    -> (stack, controller url). The caller shuts the stack down."""
    from robustvlm_tpu_torch.serve.model_worker import ModelWorker

    worker = ModelWorker(model, MODEL_NAME, worker_address="", controller_address=None,
                         image_size=image_size, batch_window_ms=window_ms, max_batch=max_batch)
    stack = Stack(worker)
    return stack, stack.url


def _serve_continuous(model, *, image_size: int, n_slots: int, max_new: int, chunk: int, width: int = 32):
    """A worker backed by the continuous-batching engine behind the
    controller; -> (stack, url, engine). The caller shuts both down."""
    from robustvlm_tpu_torch.serve.continuous import ContinuousEngine
    from robustvlm_tpu_torch.serve.model_worker import ModelWorker

    eng = ContinuousEngine(model, n_slots=n_slots, width=width, max_new=max_new, chunk=chunk)
    worker = ModelWorker(model, MODEL_NAME, worker_address="", controller_address=None,
                         image_size=image_size, continuous=eng)
    stack = Stack(worker)
    return stack, stack.url, eng


def _caption(img: str, max_new: int) -> dict:
    return {"model": MODEL_NAME, "image_b64": img, "task": "caption", "max_new_tokens": max_new}


def _checked(out: dict) -> dict:
    if out.get("error_code") or "error" in out:
        raise RuntimeError(out.get("error", "generate failed"))
    return out


def bench_single(url: str, img: str, max_new: int, *, reps: int = 3) -> dict:
    """Stage 1: /worker_generate, one client; the first call warms up, then
    best of `reps`."""
    payload = _caption(img, max_new)
    t0 = time.perf_counter()
    _checked(_post(url + "/worker_generate", payload))
    t_first = time.perf_counter() - t0
    common.reset_launches()
    best, text = None, None
    for _ in range(reps):
        t0 = time.perf_counter()
        text = _checked(_post(url + "/worker_generate", payload))["text"]
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return {"stage": "single_request", "latency_s": best, "tokens_per_sec": max_new / best,
            "first_call_s": t_first, "max_new_tokens": max_new, "tokens_emitted": len(text.split()),
            "launches": common.launches()}


def bench_stream(url: str, img: str, max_new: int, *, reps: int = 3) -> dict:
    """Stage 2: /worker_generate_stream, one client: the steady rate is
    taken over the chunks after the first (which carries the prefill)."""
    payload = _caption(img, max_new)
    _stream_times(url + "/worker_generate_stream", payload)  # warm-up
    common.reset_launches()
    best = None
    for _ in range(reps):
        t_first, t_total, n = _stream_times(url + "/worker_generate_stream", payload)
        if best is None or t_total < best[1]:
            best = (t_first, t_total, n)
    t_first, t_total, n = best
    if t_first is None:  # no chunk at all (EOS at once)
        t_first = t_total
    return {"stage": "stream_single", "time_to_first_token_s": t_first, "total_s": t_total,
            "n_chunks": n, "tokens_emitted": n,
            "steady_ms_per_token": (t_total - t_first) / max(n - 1, 1) * 1e3,
            "tokens_per_sec": n / t_total, "max_new_tokens": max_new, "launches": common.launches()}


def _run_clients(url: str, img: str, max_new: int, conc: int, reqs: int, stagger_s: float):
    """`conc` client threads (client i starts i * stagger_s late), `reqs`
    requests each, back to back; -> (wall_s, tokens emitted, errors,
    sorted latencies). A transport error is recorded, never lost with its
    thread."""
    errors: list = []
    counts = [0] * conc
    lats: list = []

    def client(i: int):
        try:
            time.sleep(i * stagger_s)
            payload = {"model": MODEL_NAME, "image_b64": img, "task": "vqa",
                       "question": f"what is in image {i}", "max_new_tokens": max_new}
            for _ in range(reqs):
                t0 = time.perf_counter()
                out = _post(url + "/worker_generate", payload)
                dt = time.perf_counter() - t0
                if out.get("error_code") or "error" in out:
                    errors.append(out.get("error", "?"))
                    return
                counts[i] += len(out.get("text", "").split())
                lats.append(dt)
        except Exception as e:  # noqa: BLE001 - surfaced by the caller
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(conc)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, sum(counts), errors, sorted(lats)


def _latencies(lats: list) -> dict:
    return {"latency_mean_s": sum(lats) / len(lats), "latency_p95_s": lats[max(0, int(len(lats) * 0.95) - 1)],
            "latency_max_s": lats[-1]}


def bench_concurrent(url: str, img: str, max_new: int, conc: int, reqs: int) -> dict:
    """Stage 3: `conc` clients against a window batcher padding to conc;
    aggregate emitted tokens/s."""
    t_first, _, errors, _ = _run_clients(url, img, max_new, conc, 1, 0.0)  # warm-up volley
    if errors:
        raise RuntimeError(f"concurrency {conc}: {errors[0][:300]}")
    common.reset_launches()
    dt, n_tokens, errors, lats = _run_clients(url, img, max_new, conc, reqs, 0.0)
    if errors:
        raise RuntimeError(f"concurrency {conc}: {errors[0][:300]}")
    return {"stage": "concurrent_batched", "concurrency": conc, "requests_per_client": reqs,
            "aggregate_tokens_per_sec": n_tokens / dt, "tokens_counted": "emitted",
            "tokens_emitted": n_tokens, **_latencies(lats), "wall_s": dt, "first_volley_s": t_first,
            "max_new_tokens": max_new, "launches": common.launches()}


def bench_staggered(url: str, img: str, max_new: int, *, conc: int, reqs: int, stagger_s: float,
                    mode: str) -> dict:
    """Stage 4: client i starts i * stagger_s after client 0 and sends `reqs`
    requests back to back, so arrivals land mid-decode; the same schedule
    and counting for both modes."""
    t_first, _, errors, _ = _run_clients(url, img, max_new, conc, 1, 0.0)  # warm-up volley
    if errors:
        raise RuntimeError(f"{mode} conc {conc}: {errors[0][:300]}")
    common.reset_launches()
    dt, n_tokens, errors, lats = _run_clients(url, img, max_new, conc, reqs, stagger_s)
    if errors:
        raise RuntimeError(f"{mode} conc {conc}: {errors[0][:300]}")
    return {"stage": "staggered_arrivals", "mode": mode, "concurrency": conc, "requests_per_client": reqs,
            "stagger_s": stagger_s, "aggregate_tokens_per_sec": n_tokens / dt, "tokens_counted": "emitted",
            "tokens_emitted": n_tokens, **_latencies(lats), "wall_s": dt, "first_volley_s": t_first,
            "max_new_tokens": max_new, "launches": common.launches()}


def run_stages(model, *, max_new: int, stream_new: int, concs, reqs: int, cb_concs, cb_chunk: int,
               stagger_s: float, single: bool = True, cb_width: int = 32) -> dict:
    """Every stage on `model` (an eval adapter); prints one line a stage and
    the summary, and returns the summary with `failed` (stages that raised)."""
    size = model.cfg.vision.image_size
    img = _png_b64(size)
    points, failed = [], []

    def stage(fn, *a, **kw):
        try:
            out = fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 - reported; the summary then counts it
            failed.append(fn.__name__)
            out = {"stage": fn.__name__, "error": f"{type(e).__name__}: {e!s:.400}",
                   **{k: v for k, v in kw.items() if k in ("conc", "mode")}}
        points.append(out)
        common.emit({"metric": "llava7b_worker_e2e", **out})
        return out

    single_out = stream_out = {}
    if single:
        stack, url = _serve(model, image_size=size, window_ms=0.0, max_batch=1)
        try:
            single_out = stage(bench_single, url, img, max_new)
            stream_out = stage(bench_stream, url, img, stream_new)
        finally:
            stack.shutdown()
    for c in concs:
        # one worker a concurrency, so the batcher pads to the offered load
        stack, url = _serve(model, image_size=size, window_ms=30.0, max_batch=c)
        try:
            stage(bench_concurrent, url, img, max_new, conc=c, reqs=reqs)
        finally:
            stack.shutdown()
    for c in cb_concs:
        stack, url, eng = _serve_continuous(model, image_size=size, n_slots=c, max_new=max_new,
                                            chunk=cb_chunk, width=cb_width)
        try:
            stage(bench_staggered, url, img, max_new, conc=c, reqs=reqs, stagger_s=stagger_s,
                  mode="continuous")
        finally:
            stack.shutdown()
            eng.shutdown()
        stack, url = _serve(model, image_size=size, window_ms=30.0, max_batch=c)
        try:
            stage(bench_staggered, url, img, max_new, conc=c, reqs=reqs, stagger_s=stagger_s,
                  mode="window_batcher")
        finally:
            stack.shutdown()

    ok = [p for p in points if "error" not in p]
    agg = {p["concurrency"]: p["aggregate_tokens_per_sec"] for p in ok if p["stage"] == "concurrent_batched"}
    stag = {f'{p["mode"]}_c{p["concurrency"]}': p["aggregate_tokens_per_sec"]
            for p in ok if p["stage"] == "staggered_arrivals"}
    values = [v for v in (single_out.get("tokens_per_sec"), *agg.values(), *stag.values()) if v is not None]
    summary = common.emit({
        "metric": "llava7b_worker_e2e_tokens_per_sec",
        "value": max(values) if values and not failed else None,
        "unit": "tokens/s/chip",
        "kv_cache": "int8" if model.quantize_kv else "bf16",
        "single_request_tokens_per_sec": single_out.get("tokens_per_sec"),
        "stream_steady_ms_per_token": stream_out.get("steady_ms_per_token"),
        "aggregate_by_concurrency": agg,
        "staggered_aggregate": stag,
        "max_new_tokens": max_new,
        "via": "controller",
        "card": common.card(),
    })
    summary["failed"] = failed
    summary["points"] = points
    return summary


def main(argv=None) -> int:
    from robustvlm_tpu_torch.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(p.parse_args(argv).device)

    def ints(name, default):
        return [int(c) for c in os.environ.get(name, default).split(",") if c.strip()]

    from bench_decode_torch import build_serving_model

    bits = int(os.environ.get("BENCH_WORKER_BITS", 8))
    model = build_serving_model(bits, dev)
    model.quantize_kv = os.environ.get("BENCH_WORKER_KVQ") == "1"
    summary = run_stages(
        model, max_new=int(os.environ.get("BENCH_WORKER_NEW", 64)),
        stream_new=int(os.environ.get("BENCH_WORKER_STREAM_NEW", 32)),
        concs=ints("BENCH_WORKER_CONC", "2,4,8"), reqs=int(os.environ.get("BENCH_WORKER_REQS", 3)),
        cb_concs=ints("BENCH_WORKER_CB", "4"), cb_chunk=int(os.environ.get("BENCH_WORKER_CB_CHUNK", 8)),
        stagger_s=float(os.environ.get("BENCH_WORKER_STAGGER_S", 0.25)),
        single=os.environ.get("BENCH_WORKER_SINGLE", "1") != "0")
    print(f"weights int{bits}; failed stages: {summary['failed']}", file=sys.stderr)
    return 1 if summary["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
