"""Serving controller: worker registry, heartbeats, request dispatch.

A copy of `robustvlm_tpu/serve/controller.py` (which has no JAX in it; the
port imports nothing of the JAX package): worker registration, heartbeat
expiry, dispatch by model name with lottery or shortest-queue policies, on
the stdlib http.server.

Endpoints (JSON over POST):
  /register_worker   {worker_name, check_heart_beat, worker_status}
  /receive_heart_beat {worker_name, queue_length}
  /refresh_all_workers {}
  /list_models       {} -> {models: [...]}
  /get_worker_address {model} -> {address}
  /worker_generate   {model, ...payload} -> proxied to the chosen worker
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

HEARTBEAT_EXPIRY = 90.0  # seconds, reference controller.py expiration


@dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float = 1.0
    queue_length: int = 0
    check_heart_beat: bool = True
    last_heart_beat: float = field(default_factory=time.time)


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        self.workers: Dict[str, WorkerInfo] = {}
        self.dispatch_method = dispatch_method
        self.lock = threading.Lock()

    def register_worker(self, name: str, check_heart_beat: bool,
                        status: Optional[dict]) -> bool:
        # the status fetch is a blocking HTTP call (up to 5 s) — do it
        # OUTSIDE the lock or an unreachable worker freezes every other
        # request thread for the duration
        status = status or self._request_status(name)
        if status is None:
            return False
        with self.lock:
            self.workers[name] = WorkerInfo(
                model_names=status["model_names"],
                speed=status.get("speed", 1.0),
                queue_length=status.get("queue_length", 0),
                check_heart_beat=check_heart_beat,
            )
        return True

    def _request_status(self, name: str) -> Optional[dict]:
        try:
            req = urllib.request.Request(
                name + "/worker_get_status", data=b"{}",
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=5) as r:
                return json.loads(r.read())
        except Exception:
            return None

    def heartbeat(self, name: str, queue_length: int) -> bool:
        with self.lock:
            if name not in self.workers:
                return False
            w = self.workers[name]
            w.queue_length = queue_length
            w.last_heart_beat = time.time()
        return True

    def expire_stale(self):
        now = time.time()
        with self.lock:
            dead = [
                n for n, w in self.workers.items()
                if w.check_heart_beat and now - w.last_heart_beat > HEARTBEAT_EXPIRY
            ]
            for n in dead:
                del self.workers[n]

    def refresh_all(self):
        with self.lock:
            names = list(self.workers)
        for n in names:
            status = self._request_status(n)
            with self.lock:
                if status is None:
                    self.workers.pop(n, None)
                elif n in self.workers:
                    self.workers[n].queue_length = status.get("queue_length", 0)

    def list_models(self) -> List[str]:
        # dead workers must not be advertised (the reference runs a
        # dedicated expiry thread; serve() starts one, and expiring here
        # keeps direct Controller users correct too)
        self.expire_stale()
        with self.lock:
            out = []
            for w in self.workers.values():
                out.extend(w.model_names)
        return sorted(set(out))

    def get_worker_address(self, model: str) -> str:
        self.expire_stale()
        with self.lock:
            cands = [
                (n, w) for n, w in self.workers.items()
                if model in w.model_names
            ]
            if not cands:
                return ""
            if self.dispatch_method == "shortest_queue":
                # queue normalized by speed (reference dispatch policy)
                name, w = min(cands, key=lambda nw: nw[1].queue_length / nw[1].speed)
            else:  # lottery by speed
                import random

                total = sum(w.speed for _, w in cands)
                r = random.uniform(0, total)
                acc = 0.0
                name, w = cands[0]
                for n2, w2 in cands:
                    acc += w2.speed
                    if r <= acc:
                        name, w = n2, w2
                        break
            w.queue_length += 1
            return name


def make_handler(controller: Controller):
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

        def do_GET(self):
            # browser UI (stdlib replacement for the reference's gradio
            # server, llava/serve/gradio_web_server.py) — see serve/web_ui.py
            if self.path.rstrip("/") in ("", "/web"):
                from robustvlm_tpu_torch.serve.web_ui import PAGE

                body = PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json({"error": "unknown endpoint"}, 404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            path = self.path.rstrip("/")
            if path == "/register_worker":
                ok = controller.register_worker(
                    payload["worker_name"],
                    payload.get("check_heart_beat", True),
                    payload.get("worker_status"),
                )
                self._json({"exist": ok})
            elif path == "/receive_heart_beat":
                ok = controller.heartbeat(
                    payload["worker_name"], payload.get("queue_length", 0)
                )
                self._json({"exist": ok})
            elif path == "/refresh_all_workers":
                controller.refresh_all()
                self._json({})
            elif path == "/list_models":
                self._json({"models": controller.list_models()})
            elif path == "/get_worker_address":
                self._json({"address": controller.get_worker_address(payload["model"])})
            elif path == "/worker_generate":
                addr = controller.get_worker_address(payload["model"])
                if not addr:
                    self._json({"error": "no worker for model"}, 503)
                    return
                req = urllib.request.Request(
                    addr + "/worker_generate",
                    data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"},
                )
                try:
                    with urllib.request.urlopen(req, timeout=300) as r:
                        self._json(json.loads(r.read()))
                except Exception as e:
                    self._json({"error": str(e)}, 502)
            elif path == "/worker_generate_stream":
                addr = controller.get_worker_address(payload["model"])
                if not addr:
                    self._json({"error": "no worker for model"}, 503)
                    return
                req = urllib.request.Request(
                    addr + "/worker_generate_stream",
                    data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"},
                )
                try:
                    with urllib.request.urlopen(req, timeout=300) as r:
                        self.send_response(200)
                        self.send_header(
                            "Content-Type", "application/x-ndjson"
                        )
                        self.send_header("Transfer-Encoding", "chunked")
                        self.end_headers()
                        for line in r:  # NDJSON lines as they arrive
                            self.wfile.write(f"{len(line):X}\r\n".encode())
                            self.wfile.write(line + b"\r\n")
                            self.wfile.flush()
                        self.wfile.write(b"0\r\n\r\n")
                except Exception as e:
                    self._json({"error": str(e)}, 502)
            else:
                self._json({"error": "unknown endpoint"}, 404)

    return Handler


def serve(host: str = "0.0.0.0", port: int = 21001,
          dispatch_method: str = "shortest_queue") -> ThreadingHTTPServer:
    controller = Controller(dispatch_method)
    server = ThreadingHTTPServer((host, port), make_handler(controller))
    server.controller = controller

    # background heartbeat expiry (reference llava/serve/controller.py
    # heart_beat_controller thread)
    def expiry_loop():
        while True:
            time.sleep(HEARTBEAT_EXPIRY / 2)
            controller.expire_stale()

    threading.Thread(target=expiry_loop, daemon=True).start()
    return server


def main(argv=None):
    p = argparse.ArgumentParser(description="serving controller")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=21001)
    p.add_argument("--dispatch-method", default="shortest_queue",
                   choices=["shortest_queue", "lottery"])
    args = p.parse_args(argv)
    server = serve(args.host, args.port, args.dispatch_method)
    print(f"controller listening on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
