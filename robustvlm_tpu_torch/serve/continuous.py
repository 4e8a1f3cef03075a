"""Continuous-batching serving engine: slot admission into a RUNNING decode.

Counterpart of `robustvlm_tpu/serve/continuous.py`, with its structure and
names. A request that arrives mid-decode joins the running batch at the next
step boundary instead of waiting out the batch (the window micro-batcher,
`serve/model_worker._Batcher`, only coalesces requests that arrive
together):

- one static decode shape for the engine's lifetime: `n_slots` lanes,
  prompts left-padded to `width` post tokens, a `width + max_new` post cache
  per lane;
- admission is one batch-1 prefill (vision tower and splice) whose KV rows
  are written straight into the lane of the batched caches
  (`LlavaEvalModel._continuous_cores`);
- each lane decodes at its own depth. The depths, pad counts and next
  tokens live on the host (`_pos`, `_npad`, `_nxt`) and go to the card as one
  small copy a dispatch; key masks and positions are made there, and the
  (n_slots, chunk) token ids come back as one copy;
- `chunk` decode steps run per dispatch, at the cost of up to `chunk - 1`
  steps of admission latency for a newly arrived request.

The loop thread owns all device work and runs it under `torch.no_grad()`
(grad mode is per thread). Greedy only, llama-family LLaVA only. Lane
isolation: attention masks confine each lane to its own cache rows, so a
lane's tokens do not depend on what its neighbours decode. Token equality
with the batch-1 stream is exact on the CPU in float32; on the card the
batched step can round differently from the batch-1 step (other GEMM
shapes, other key lengths), so an argmax can flip at a near-tie.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import List, Optional

import numpy as np
import torch


class CBRequest:
    """Handle for one submitted request: a host-side greedy token stream.

    Tokens arrive on `tokens` (a Queue of int ids; None terminates; EOS is
    consumed by the engine, never emitted). `cancel()` retires the lane at
    the engine's next emission point (the stream wrapper calls it when a
    stop string lands, so an abandoned lane does not decode to max_new)."""

    def __init__(self, image: np.ndarray, prompt: str, max_new: int):
        self.image = image
        self.prompt = prompt
        self.max_new = max_new
        self.tokens: "queue.Queue[Optional[int]]" = queue.Queue()
        self.error: Optional[str] = None
        self.cancelled = False
        # set at submit time (host tokenization)
        self._toks = None   # (1, width) np.int32
        self._n_pad = None  # (1,) np.int32

    def cancel(self):
        self.cancelled = True

    def token_stream(self):
        """Yield token ids as they arrive; raises RuntimeError on an engine
        error. Ends when the lane retires (EOS / max_new / cancel)."""
        while True:
            t = self.tokens.get()
            if t is None:
                if self.error:
                    raise RuntimeError(self.error)
                return
            yield t

    def wait_ids(self) -> List[int]:
        return list(self.token_stream())


class _DeviceFailure(RuntimeError):
    """A core raised while writing the batched caches: their contents are
    undefined, so the whole running batch is failed and the lanes rebuilt."""


class _Slot:
    __slots__ = ("req", "emitted", "cap")

    def __init__(self, req: CBRequest, cap: int):
        self.req = req
        self.emitted = 0
        self.cap = cap


class ContinuousEngine:
    """Slot scheduler over a LlavaEvalModel. One engine per worker process
    (one process per card); the loop thread owns all device state, `submit`
    only tokenizes and enqueues."""

    def __init__(self, model, *, n_slots: int = 4, width: int = 32,
                 max_new: int = 32, chunk: int = 1):
        if (not hasattr(model, "_continuous_cores")
                or getattr(model.cfg, "lm_family", None) != "llama"):
            raise ValueError(
                "continuous batching requires a llava adapter with the llama LM family "
                f"(per-lane cache writes; got {type(model).__name__} / "
                f"{getattr(model.cfg, 'lm_family', None)!r})")
        if n_slots < 1 or width < 1 or max_new < 1 or chunk < 1:
            raise ValueError("n_slots/width/max_new/chunk must be >= 1")
        self.model = model
        self.n_slots = n_slots
        self.width = width
        self.max_new = max_new
        self.chunk = chunk
        self._total = width + max_new
        self._pad = int(model.tok.pad_token_id)
        self._eos = int(model.tok.eos_token_id)

        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._slots: List[Optional[_Slot]] = [None] * n_slots
        self._stop = False

        # host mirrors of the per-lane device operands
        self._nxt = np.full((n_slots,), self._pad, np.int64)
        self._pos = np.full((n_slots,), width, np.int64)
        self._npad = np.zeros((n_slots,), np.int64)

        # device state, built at the first admission (and after a failure)
        self._cores = None     # (admit, step, lanes) of the adapter
        self._bcaches = None
        self._pre_dev = None   # pinned pre-image tokens (1, T_pre)
        self._pre_ids = None   # host tuple for the submit-side check

        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ submission
    def submit(self, image: np.ndarray, prompt: str,
               max_new: Optional[int] = None) -> CBRequest:
        """Tokenize and enqueue. Raises ValueError on the host for a prompt
        that does not fit the engine's static shapes (too many post tokens,
        or a pre-image segment other than the pinned one: every llava
        caption/VQA prompt shares the system-prompt pre segment)."""
        cap = self.max_new if max_new is None else int(max_new)
        req = CBRequest(image, prompt, min(cap, self.max_new))
        pre_ids, toks, n_pad = self.model._tokenize_gen([prompt])
        with self._cv:
            if self._pre_ids is None:
                self._pre_ids = tuple(pre_ids)
            elif tuple(pre_ids) != self._pre_ids:
                raise ValueError(
                    "pre-image segment differs from the engine's pinned prompt prefix "
                    "(continuous batching shares one prefix length)")
        toks = np.asarray(toks, np.int64)
        n_pad = np.asarray(n_pad, np.int64)
        t = toks.shape[1]
        if t > self.width:
            raise ValueError(f"prompt has {t} post tokens > engine width {self.width}")
        if t < self.width:
            extra = self.width - t
            toks = np.concatenate([np.full((1, extra), self._pad, np.int64), toks], axis=1)
            n_pad = n_pad + extra
        req._toks, req._n_pad = toks, n_pad
        with self._cv:
            if self._stop:
                raise RuntimeError("engine is shut down")
            self._queue.append(req)
            self._cv.notify()
        return req

    def shutdown(self):
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=30)
        for st in self._slots:
            if st is not None:
                st.req.error = "engine shut down"
                st.req.tokens.put(None)
        while self._queue:
            r = self._queue.popleft()
            r.error = "engine shut down"
            r.tokens.put(None)

    # ------------------------------------------------------------ scheduling
    def _emit(self, slot: int, tok: int):
        """Deliver one decoded token to lane `slot`'s request; retire the
        lane on EOS/pad, cap or cancellation. Pad terminates too, as on
        every other decode surface; the terminator itself is never
        emitted."""
        st = self._slots[slot]
        req = st.req
        if (req.cancelled or tok == self._eos or tok == self._pad
                or st.emitted >= st.cap):
            self._retire(slot)
            return
        req.tokens.put(tok)
        st.emitted += 1
        if st.emitted >= st.cap:
            self._retire(slot)

    def _retire(self, slot: int):
        st = self._slots[slot]
        self._slots[slot] = None
        self._nxt[slot] = self._pad
        st.req.tokens.put(None)

    def _admit(self, slot: int, req: CBRequest):
        dev = self.model.device
        x01 = torch.as_tensor(req.image, dtype=torch.float32)[None].to(dev)
        toks = torch.from_numpy(req._toks).to(dev)
        n_pad = torch.from_numpy(req._n_pad).to(dev)
        if self._bcaches is None:
            self._cores = self.model._continuous_cores(self.n_slots, self.width, self.max_new,
                                                       self.chunk)
            self._pre_dev = torch.tensor([list(self._pre_ids)], dtype=torch.long, device=dev)
            self._bcaches = self._cores[2](self._pre_dev)
        admit = self._cores[0]
        try:
            first = admit(x01, self._pre_dev, toks, n_pad, self._bcaches, slot)
            tok = int(first[0])
        except Exception as e:
            raise _DeviceFailure(f"{type(e).__name__}: {e}") from e
        self._pos[slot] = self.width
        self._npad[slot] = int(req._n_pad[0])
        self._nxt[slot] = tok
        self._slots[slot] = _Slot(req, req.max_new)
        self._emit(slot, tok)

    def _dispatch(self):
        step = self._cores[1]
        active_before = [i for i in range(self.n_slots) if self._slots[i] is not None]
        # one host-to-device copy of the three per-lane operands
        nxt, pos, npad = torch.from_numpy(
            np.stack([self._nxt, self._pos, self._npad])).to(self.model.device)
        t = step(nxt, self._bcaches, pos, npad).cpu().numpy()  # (n_slots, chunk)
        for j in range(self.chunk):
            for i in active_before:
                if self._slots[i] is not None:  # may retire mid-chunk
                    self._emit(i, int(t[i, j]))
        for i in range(self.n_slots):
            if self._slots[i] is not None:
                # an active lane's emitted tokens never come from a clamped
                # write: it retires in the dispatch that would reach total-1
                self._pos[i] += self.chunk
                self._nxt[i] = t[i, -1]
            else:
                # an idle lane decodes garbage at the last slot; admission
                # zeroes and rewrites the lane, so nothing leaks across reuse
                self._pos[i] = min(self._pos[i] + self.chunk, self._total - 1)

    def _loop(self):
        with torch.no_grad():
            while True:
                with self._cv:
                    while (not self._stop and not self._queue
                           and not any(s is not None for s in self._slots)):
                        self._cv.wait()
                    if self._stop:
                        return
                    admits = []
                    for i in range(self.n_slots):
                        if self._slots[i] is None and self._queue:
                            admits.append((i, self._queue.popleft()))
                for slot, req in admits:
                    try:
                        self._admit(slot, req)
                    except _DeviceFailure as e:
                        # the batched caches may be half written: fail the
                        # whole running batch and rebuild the lanes fresh
                        self._slots[slot] = None
                        req.error = str(e)
                        req.tokens.put(None)
                        self._fail_batch(str(e))
                    except Exception as e:  # host-side: surfaced per request
                        self._slots[slot] = None
                        req.error = f"{type(e).__name__}: {e}"
                        req.tokens.put(None)
                if any(s is not None for s in self._slots):
                    try:
                        self._dispatch()
                    except Exception as e:  # a device failure
                        self._fail_batch(f"{type(e).__name__}: {e}")

    def _fail_batch(self, msg: str):
        """Retire every active lane with `msg` and drop the batched caches,
        so the next admission allocates them anew."""
        for i in range(self.n_slots):
            if self._slots[i] is not None:
                self._slots[i].req.error = msg
                self._retire(i)
        self._bcaches = None
