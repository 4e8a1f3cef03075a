"""Model worker: serves VLM caption and VQA generation over HTTP.

Counterpart of `robustvlm_tpu/serve/model_worker.py`: builds an eval-model
adapter (`vlm_eval/eval_models.py`), registers with the controller, sends
heartbeats and answers /worker_generate and /worker_generate_stream (images
as base64 PNG or raw float lists in [0,1]). One worker process per card:

    python -m robustvlm_tpu_torch.serve.model_worker --model llava --model_size 7b \\
        --quantize-decode --quantize-bits 4 [--batch-window-ms W --max-batch B]
        [--continuous --cb-slots 4 --cb-width 32 --cb-max-new 64 --cb-chunk 1]
        [--speculate K] [--quantize-kv]

`--device` defaults to cuda (`--device cpu --model_size test-tiny` runs the
tiny model on the CPU). `--quantize-decode` quantizes the LM at startup, in
place, leaf by leaf (serving-only: the fp weights are dropped); with
`--quantize-bits 4` every decode-step matmul runs the `q4_matmul` kernel.
`--batch-window-ms` coalesces concurrent requests into one batched call
(`_Batcher`). `--continuous` admits greedy requests into a running decode
batch of `--cb-slots` lanes at step boundaries (`serve/continuous.py`);
`--speculate k` serves /worker_generate_stream by prompt-lookup speculative
decoding, up to k + 1 tokens a step (`serve/speculative.py`); `--quantize-kv`
keeps an int8 KV cache. `--speculate` and `--continuous` together are
refused (the JAX worker ignores `--speculate` there without a word).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

HEARTBEAT_INTERVAL = 30.0


class _Batcher:
    """Window-coalescing micro-batcher for /worker_generate.

    Concurrent requests arriving within `window_ms` are grouped by their
    generation config (max_new_tokens, num_beams) and run as ONE batched
    `get_outputs` call, padded to `max_batch` by repeating the last row, so
    that every call of a config has one batch shape. window_ms=0 disables
    batching (one request per call)."""

    def __init__(self, worker: "ModelWorker", window_ms: float, max_batch: int):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.worker = worker
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        self.cv = threading.Condition()
        self.pending: list = []  # (key, image, prompt, slot)
        threading.Thread(target=self._loop, daemon=True).start()

    def submit(self, payload: dict) -> dict:
        try:
            image = self.worker.decode_image(payload)
            prompt = self.worker._prompt(payload)
        except Exception as e:
            return {"text": "", "error_code": 1, "error": str(e)}
        key = (int(payload.get("max_new_tokens", 32)), int(payload.get("num_beams", 1)))
        slot = {"event": threading.Event(), "result": None}
        with self.cv:
            self.pending.append((key, image, prompt, slot))
            self.cv.notify()
        slot["event"].wait()
        return slot["result"]

    def _take_group(self):
        """Block for the first request, linger `window` for more, then take
        up to max_batch entries sharing the oldest request's config. The
        early break counts only same-config entries, so other traffic cannot
        cut the oldest key's window into a near-empty batch."""
        with self.cv:
            while not self.pending:
                self.cv.wait()
            key = self.pending[0][0]
        deadline = time.monotonic() + self.window
        while time.monotonic() < deadline:
            with self.cv:
                if sum(1 for p in self.pending if p[0] == key) >= self.max_batch:
                    break
            time.sleep(min(0.002, self.window))
        with self.cv:
            grp = [p for p in self.pending if p[0] == key][: self.max_batch]
            taken = set(map(id, grp))
            self.pending = [p for p in self.pending if id(p) not in taken]
        return key, grp

    def _loop(self):
        while True:
            key, grp = self._take_group()
            xs = [g[1] for g in grp]
            prompts = [g[2] for g in grp]
            n = len(xs)
            while len(xs) < self.max_batch:  # pad to the one batch shape
                xs.append(xs[-1])
                prompts.append(prompts[-1])
            try:
                x = torch.from_numpy(np.stack(xs)).to(self.worker.device)
                outs = self.worker.model.get_outputs(
                    x, prompts, max_new_tokens=key[0], num_beams=key[1])[:n]
                results = [{"text": t, "error_code": 0} for t in outs]
            except Exception as e:  # pragma: no cover
                results = [{"text": "", "error_code": 1, "error": str(e)}] * n
            for g, r in zip(grp, results):
                g[3]["result"] = r
                g[3]["event"].set()


class ModelWorker:
    def __init__(self, eval_model, model_name: str, *, worker_address: str,
                 controller_address: Optional[str] = None, image_size: int = 224,
                 batch_window_ms: float = 0.0, max_batch: int = 8, continuous=None,
                 speculate: int = 0):
        self.model = eval_model
        self.model_name = model_name
        self.worker_address = worker_address
        self.controller_address = controller_address
        self.image_size = image_size
        self.device = eval_model.device
        self.queue_length = 0
        self.lock = threading.Lock()
        self.batcher = _Batcher(self, batch_window_ms, max_batch) if batch_window_ms > 0 else None
        # continuous: a serve.continuous.ContinuousEngine; greedy requests
        # join its running decode batch instead of queueing behind it
        self.continuous = continuous
        # speculate: k > 0 serves /worker_generate_stream by prompt-lookup
        # speculative decoding (serve/speculative.py)
        self.speculate = speculate
        if controller_address:
            self.register()
            threading.Thread(target=self._heartbeat_loop, daemon=True).start()

    # ------------------------------------------------------------ controller
    def _post(self, url, payload):
        req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())

    def status(self):
        return {"model_names": [self.model_name], "speed": 1.0, "queue_length": self.queue_length}

    def register(self):
        self._post(self.controller_address + "/register_worker",
                   {"worker_name": self.worker_address, "check_heart_beat": True,
                    "worker_status": self.status()})

    def _heartbeat_loop(self):
        while True:
            time.sleep(HEARTBEAT_INTERVAL)
            try:
                self._post(self.controller_address + "/receive_heart_beat",
                           {"worker_name": self.worker_address, "queue_length": self.queue_length})
            except Exception:
                try:
                    self.register()
                except Exception:
                    pass

    # -------------------------------------------------------------- generate
    def decode_image(self, payload) -> np.ndarray:
        """(3, S, S) float32 in [0,1] at the worker's resolution, from a
        base64 image (resize + center crop) or a raw (3, H, W) array
        (bicubic resize), the same resolution either way."""
        from robustvlm_tpu_torch.data.loaders import default_image_transform

        if "image_b64" in payload:
            from PIL import Image

            raw = base64.b64decode(payload["image_b64"])
            with Image.open(io.BytesIO(raw)) as img:
                return default_image_transform(self.image_size)(img)
        arr = np.asarray(payload["image"], np.float32)
        if arr.ndim != 3 or arr.shape[0] != 3:
            raise ValueError(f"'image' must be (3, H, W) floats in [0,1]; got {arr.shape}")
        if float(arr.max(initial=0.0)) > 1.5 or float(arr.min(initial=0.0)) < -0.5:
            # a 0-255-scaled array would otherwise clip to near-white
            raise ValueError("'image' values must be in [0,1] (got range "
                             f"[{arr.min():.3g}, {arr.max():.3g}]; divide by 255?)")
        if arr.shape[1:] != (self.image_size, self.image_size):
            from robustvlm_tpu_torch.ops.image import resize_bicubic

            arr = resize_bicubic(torch.from_numpy(arr)[None], self.image_size)[0].numpy()
        return np.clip(arr, 0.0, 1.0)

    def _prompt(self, payload: dict) -> str:
        if payload.get("task", "caption") == "vqa":
            return self.model.get_vqa_prompt(payload["question"], None)
        return self.model.get_caption_prompt(None)

    def _pixels(self, payload) -> torch.Tensor:
        return torch.from_numpy(self.decode_image(payload))[None].to(self.device)

    def _submit(self, payload: dict):
        return self.continuous.submit(self.decode_image(payload), self._prompt(payload),
                                      int(payload.get("max_new_tokens", 32)))

    def generate(self, payload: dict) -> dict:
        from robustvlm_tpu_torch.vlm_eval.eval_models import truncate_at_stops

        with self.lock:
            self.queue_length += 1
        try:
            if self.continuous is not None and int(payload.get("num_beams", 1)) == 1:
                text = self.model.tok.decode(self._submit(payload).wait_ids())
                return {"text": truncate_at_stops(text, self.model.DEFAULT_STOPS), "error_code": 0}
            if self.batcher is not None:
                return self.batcher.submit(payload)
            text = self.model.get_outputs(
                self._pixels(payload), [self._prompt(payload)],
                max_new_tokens=int(payload.get("max_new_tokens", 32)),
                num_beams=int(payload.get("num_beams", 1)))[0]
            return {"text": text, "error_code": 0}
        except Exception as e:  # pragma: no cover
            return {"text": "", "error_code": 1, "error": str(e)}
        finally:
            with self.lock:
                self.queue_length -= 1

    def generate_stream(self, payload: dict):
        """Yield {"text": cumulative, "error_code": 0} dicts as tokens arrive.
        Under --continuous the request's lane is cancelled when a stop
        string lands or the stream is closed early, which frees it for the
        next request."""
        from robustvlm_tpu_torch.vlm_eval.eval_models import stream_outputs, truncate_at_stops

        with self.lock:
            self.queue_length += 1
        try:
            if self.continuous is not None:
                req = self._submit(payload)
                stops = self.model.DEFAULT_STOPS
                ids = []
                try:
                    for t in req.token_stream():
                        ids.append(t)
                        raw = self.model.tok.decode(ids)
                        if any(st in raw for st in stops):
                            yield {"text": truncate_at_stops(raw, stops), "error_code": 0}
                            return
                        yield {"text": raw.strip(), "error_code": 0}
                finally:
                    req.cancel()  # a stop string or a closed stream frees the lane
                return
            for text in stream_outputs(self.model, self._pixels(payload), self._prompt(payload),
                                       max_new_tokens=int(payload.get("max_new_tokens", 32)),
                                       speculate=self.speculate):
                yield {"text": text, "error_code": 0}
        except Exception as e:  # pragma: no cover
            yield {"text": "", "error_code": 1, "error": str(e)}
        finally:
            with self.lock:
                self.queue_length -= 1


def make_handler(worker: ModelWorker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            path = self.path.rstrip("/")
            if path == "/worker_get_status":
                self._json(worker.status())
            elif path == "/worker_generate":
                self._json(worker.generate(payload))
            elif path == "/worker_generate_stream":
                # newline-delimited JSON chunks, flushed per token
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for chunk in worker.generate_stream(payload):
                    data = json.dumps(chunk).encode() + b"\n"
                    self.wfile.write(f"{len(data):X}\r\n".encode())
                    self.wfile.write(data + b"\r\n")
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
            else:
                self._json({"error": "unknown endpoint"}, 404)

    return Handler


def serve_worker(worker: ModelWorker, host: str, port: int) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), make_handler(worker))
    server.worker = worker
    return server


def build_parser():
    from robustvlm_tpu_torch.vlm_eval.run_evaluation import add_model_args

    p = argparse.ArgumentParser(description="VLM model worker (PyTorch/CUDA)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=21002)
    p.add_argument("--worker-address", default="http://localhost:21002")
    p.add_argument("--controller-address", default="http://localhost:21001")
    add_model_args(p)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="coalesce concurrent /worker_generate requests arriving within this "
                        "window into one batched call (0 = one request per call)")
    p.add_argument("--max-batch", type=int, default=8,
                   help="micro-batch cap; batches are padded to it")
    p.add_argument("--quantize-decode", action="store_true",
                   help="serve generation from weight-only quantized LM weights, quantized at "
                        "startup in place, leaf by leaf (serving-only: the fp weights are dropped)")
    p.add_argument("--quantize-bits", type=int, default=8, choices=(8, 4),
                   help="width for --quantize-decode: 8 = per-channel int8, 4 = packed int4 with "
                        "group-128 scales (the q4_matmul kernel)")
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching (serve/continuous.py): admit greedy requests into "
                        "the running decode batch at step boundaries (--cb-slots lanes)")
    p.add_argument("--cb-slots", type=int, default=4, help="decode lanes for --continuous")
    p.add_argument("--cb-width", type=int, default=32,
                   help="static post-prompt token width for --continuous (longer prompts are "
                        "rejected)")
    p.add_argument("--cb-max-new", type=int, default=64,
                   help="per-lane generation cap for --continuous (a request's max_new_tokens "
                        "clamps to it)")
    p.add_argument("--cb-chunk", type=int, default=1,
                   help="decode steps per dispatch for --continuous (admission waits up to "
                        "chunk-1 steps)")
    p.add_argument("--speculate", type=int, default=0,
                   help="k > 0: serve /worker_generate_stream by prompt-lookup speculative "
                        "decoding (serve/speculative.py), up to k+1 tokens a step; not with "
                        "--continuous")
    p.add_argument("--quantize-kv", action="store_true",
                   help="int8 KV cache with per-token scales (llama family)")
    return p


def build_worker(args) -> ModelWorker:
    """The worker `main` serves, built from parsed arguments: the adapter
    (`run_evaluation.build_eval_model`, bf16), quantized at startup under
    --quantize-decode, with its int8 KV cache, continuous engine and
    speculation as the flags ask."""
    if args.speculate and args.continuous:
        raise SystemExit("--speculate and --continuous cannot be combined: the continuous "
                         "engine serves every greedy request, so --speculate would never run")
    for flag, on in (("--quantize-decode", args.quantize_decode), ("--quantize-kv", args.quantize_kv),
                     ("--continuous", args.continuous)):
        if on and args.model != "llava":
            raise SystemExit(f"{flag} is not supported by the '{args.model}' adapter (llava only)")
    from robustvlm_tpu_torch.vlm_eval.run_evaluation import build_eval_model

    model = build_eval_model(args, "half")
    if args.quantize_decode:
        model.quantize_for_serving(args.quantize_bits)
    if args.quantize_kv:
        model.quantize_kv = True
    engine = None
    if args.continuous:
        from robustvlm_tpu_torch.serve.continuous import ContinuousEngine

        engine = ContinuousEngine(model, n_slots=args.cb_slots, width=args.cb_width,
                                  max_new=args.cb_max_new, chunk=args.cb_chunk)
    return ModelWorker(model, f"{args.model}-{args.model_size}",
                       worker_address=args.worker_address,
                       controller_address=args.controller_address or None,
                       image_size=model.cfg.vision.image_size,
                       batch_window_ms=args.batch_window_ms, max_batch=args.max_batch,
                       continuous=engine, speculate=args.speculate)


def main(argv=None):
    args = build_parser().parse_args(argv)
    worker = build_worker(args)
    server = serve_worker(worker, args.host, args.port)
    print(f"worker listening on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
