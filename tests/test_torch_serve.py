"""The port's serving stack (robustvlm_tpu_torch.serve) and its quantized
decode against the JAX package's.

- Controller registry and dispatch, the web page, and the micro-batcher with
  a fake model (ports of tests/test_serve.py's unit tests).
- End to end on the CPU: the port's controller and a tiny int4 worker built
  as the CLI builds it, on ephemeral ports; caption, VQA and stream, the
  stream's last chunk equal to the non-streamed text.
- The slice against JAX: the tiny LLaVA's float32 weights quantized (int4
  and int8, every LM matrix) by the JAX package and carried across, and by
  the port from the same weights; greedy tokens equal to JAX's, prefill and
  first-step logits within 1e-4 of their largest magnitude (float32 on the
  CPU, the split dot in both packages).
- The serving-only errors, and the serving options that build their worker."""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.models import generation as JG
from robustvlm_tpu.models.llava import model as JV
from robustvlm_tpu.ops import quant as JQ
from robustvlm_tpu_torch.models import generation as PG
from robustvlm_tpu_torch.models.llava import model as PV
from robustvlm_tpu_torch.models.llava.convert import params_from_jax
from robustvlm_tpu_torch.ops import quant as PQ
from robustvlm_tpu_torch.serve import model_worker as MW
from robustvlm_tpu_torch.serve.controller import Controller, serve
from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel, WordTokenizer, stream_outputs

torch.set_num_threads(1)

CFG = JV.LLAVA_CONFIGS["test-tiny"]
PCFG = PV.LLAVA_CONFIGS["test-tiny"]
POSTS = [[5, 6, 7, 8], [9, 10]]
NEW = 6


def _post(url, payload, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _gen_inputs():
    rng = np.random.RandomState(2)
    x = rng.rand(2, 3, CFG.vision.image_size, CFG.vision.image_size).astype(np.float32)
    pre = rng.randint(3, 500, (2, 5))
    toks, n_pad = JG.left_pad(POSTS, pad_id=0)
    return x, pre, np.asarray(toks), np.asarray(n_pad)


def _jax_decode(tree):
    """Prefill logits, first-step logits and greedy tokens through the JAX
    package's decode fns."""
    x, pre, toks, n_pad = _gen_inputs()
    t = toks.shape[1]
    pf, df = JV.make_llava_decode_fns(tree, CFG, jnp.asarray(x), jnp.asarray(pre),
                                      max_total_len=t + NEW, compute_dtype=jnp.float32)
    kv0 = jnp.arange(t)[None, :] >= jnp.asarray(n_pad)[:, None]
    pos = jnp.maximum(jnp.arange(t)[None, :] - jnp.asarray(n_pad)[:, None], 0)
    l0, cache = pf(jnp.asarray(toks), kv0, pos)
    mask = jnp.concatenate([kv0, jnp.zeros((2, NEW), bool)], axis=1).at[:, t].set(True)
    l1, _ = df(jnp.argmax(l0, -1)[:, None], cache, t, mask, (t - jnp.asarray(n_pad))[:, None])
    res = JG.greedy_generate(pf, df, jnp.asarray(toks), jnp.asarray(n_pad), max_new_tokens=NEW,
                             eos_id=2, pad_id=0)
    return np.asarray(l0), np.asarray(l1[:, -1]), np.asarray(res.tokens)


def _port_decode(model):
    x, pre, toks, n_pad = _gen_inputs()
    t = toks.shape[1]
    tt, tn = torch.from_numpy(toks).long(), torch.from_numpy(n_pad).long()
    pf, df = PV.make_llava_decode_fns(model, torch.from_numpy(x), torch.from_numpy(pre),
                                      max_total_len=t + NEW, compute_dtype=torch.float32)
    with torch.no_grad():
        l0, cache, mask = PG._start(pf, tt, tn, NEW)
        mask[:, t] = True
        l1, _ = df(torch.argmax(l0, -1)[:, None], cache, t, mask, (t - tn)[:, None])
    res = PG.greedy_generate(pf, df, tt, tn, max_new_tokens=NEW, eos_id=2, pad_id=0)
    return l0.numpy(), l1[:, -1].numpy(), res.tokens.numpy()


@pytest.fixture(scope="module")
def jax_side():
    """The JAX tiny LLaVA (float32) and, per width, its quantized tree and
    decode results."""
    tree = jax.tree.map(np.asarray, JV.init_llava_params(jax.random.PRNGKey(0), CFG))
    out = {"tree": tree}
    for bits in (4, 8):
        qtree = jax.tree.map(np.asarray, JQ.quantize_llama_decode_params(tree, bits=bits, min_size=0))
        out[bits] = (qtree, _jax_decode(jax.tree.map(jnp.asarray, qtree)))
    return out


# ------------------------------------------------------------------ the slice
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("source", ["carried", "port_quantized"])
def test_quantized_decode_matches_jax(jax_side, bits, source):
    qtree, (ref0, ref1, ref_tokens) = jax_side[bits]
    if source == "carried":
        state = params_from_jax(qtree)
    else:
        state = PQ.quantize_llama_decode_params(params_from_jax(jax_side["tree"]), bits=bits,
                                                min_size=0)
    model = PV.Llava.from_state(PCFG, state)
    assert isinstance(model.llama.lm_head, PQ.PackedQ4Weight if bits == 4 else PQ.QuantizedWeight)
    l0, l1, tokens = _port_decode(model)
    for got, ref in ((l0, ref0), (l1, ref1)):
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    np.testing.assert_array_equal(tokens, ref_tokens)


def _adapter(jax_side, **kw):
    model = PV.Llava.from_state(PCFG, params_from_jax(jax_side["tree"]))
    return LlavaEvalModel(model, WordTokenizer(), compute_dtype=torch.float32, max_post_len=16, **kw)


def _image(n=1):
    return torch.from_numpy(np.random.RandomState(0).rand(n, 3, 32, 32).astype(np.float32))


def test_quantize_decode_is_lazy_and_keeps_the_fp_model(jax_side):
    m = _adapter(jax_side, quantize_decode=4)
    assert m._decode_model is None
    out = m.get_outputs(_image(), [m.get_caption_prompt()], max_new_tokens=3)
    assert len(out) == 1 and isinstance(out[0], str)
    bits, qmodel = m._decode_model
    assert bits == 4 and isinstance(qmodel.llama.lm_head, PQ.PackedQ4Weight)
    assert isinstance(m.model.llama.lm_head, torch.nn.Parameter)
    # the quantized model shares the fp tensors it does not quantize
    assert qmodel.llama.tok_embedding.data_ptr() == m.model.llama.tok_embedding.data_ptr()
    m.set_inputs([m.get_caption_prompt("a cat")])
    assert np.isfinite(float(m(_image())[0]))
    m.quantize_decode = 8  # the cache is keyed on the width
    m.get_outputs(_image(), [m.get_caption_prompt()], max_new_tokens=2)
    assert isinstance(m._decode_model[1].llama.lm_head, PQ.QuantizedWeight)


def test_quantize_for_serving_drops_fp_and_disables_the_loss(jax_side):
    m = _adapter(jax_side)
    m.quantize_for_serving(4)
    assert isinstance(m.model.llama.lm_head, PQ.PackedQ4Weight)
    assert m.model.llama.tok_embedding.dtype == torch.float32  # stays fp
    # the LM head is always quantized; the tiny blocks' matrices are under min_size
    assert "llama.lm_head" not in dict(m.model.named_parameters())
    ref = m.get_outputs(_image(), [m.get_caption_prompt()], max_new_tokens=4)
    streamed = list(m.stream_tokens(_image(), [m.get_caption_prompt()], 4))
    assert m.tok.decode([int(s[0]) for s in streamed]).startswith(ref[0])
    m.set_inputs([m.get_caption_prompt("a cat")])
    with pytest.raises(RuntimeError, match="serving-only"):
        m(_image())
    with pytest.raises(RuntimeError, match="fp weights are gone"):
        m.quantize_decode = 8
        m.get_outputs(_image(), [m.get_caption_prompt()], max_new_tokens=2)


def test_bf16_serving_holds_the_half_layout():
    args = MW.build_parser().parse_args(["--device", "cpu", "--model_size", "test-tiny",
                                         "--quantize-decode", "--quantize-bits", "4",
                                         "--controller-address", ""])
    w = MW.build_worker(args)
    sd = w.model.model.state_dict()
    assert sd["llama.lm_head.p"].dtype == torch.uint8
    assert sd["llama.tok_embedding"].dtype == torch.bfloat16
    assert sd["projector.w1"].dtype == torch.float32 and sd["llama.norm"].dtype == torch.float32
    assert "llama.lm_head" not in sd
    assert sd["llama.blocks.0.attn.wq"].dtype == torch.bfloat16  # under min_size: fp, held as bf16


# ---------------------------------------------------------------- end to end
def test_controller_worker_end_to_end():
    ctrl = serve(host="127.0.0.1", port=0)
    threading.Thread(target=ctrl.serve_forever, daemon=True).start()
    ctrl_addr = f"http://127.0.0.1:{ctrl.server_address[1]}"
    args = MW.build_parser().parse_args(["--device", "cpu", "--model_size", "test-tiny",
                                         "--quantize-decode", "--quantize-bits", "4",
                                         "--controller-address", ""])
    worker = MW.build_worker(args)
    wsrv = MW.serve_worker(worker, "127.0.0.1", 0)
    threading.Thread(target=wsrv.serve_forever, daemon=True).start()
    worker.worker_address = f"http://127.0.0.1:{wsrv.server_address[1]}"
    try:
        assert _post(ctrl_addr + "/register_worker",
                     {"worker_name": worker.worker_address, "check_heart_beat": False})["exist"]
        assert _post(ctrl_addr + "/list_models", {})["models"] == ["llava-test-tiny"]
        img = np.random.RandomState(0).rand(3, 40, 40).astype(np.float32)  # resized to 32
        cap = _post(ctrl_addr + "/worker_generate", {"model": "llava-test-tiny", "image": img.tolist(),
                                                     "task": "caption", "max_new_tokens": 4})
        assert cap["error_code"] == 0 and cap["text"].startswith("tok")
        x = torch.from_numpy(worker.decode_image({"image": img.tolist()}))[None]
        assert cap["text"] == worker.model.get_outputs(x, [worker.model.get_caption_prompt()],
                                                       max_new_tokens=4)[0]
        vqa = _post(ctrl_addr + "/worker_generate", {"model": "llava-test-tiny", "image": img.tolist(),
                                                     "task": "vqa", "question": "what is it",
                                                     "max_new_tokens": 4})
        assert vqa["error_code"] == 0
        req = urllib.request.Request(
            ctrl_addr + "/worker_generate_stream",
            data=json.dumps({"model": "llava-test-tiny", "image": img.tolist(), "task": "caption",
                             "max_new_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            chunks = [json.loads(line) for line in r]
        assert chunks and all(c["error_code"] == 0 for c in chunks)
        assert chunks[-1]["text"] == cap["text"]
    finally:
        ctrl.shutdown()
        wsrv.shutdown()


@pytest.mark.parametrize("flag", [["--continuous"], ["--speculate", "2"], ["--quantize-kv"]])
def test_unported_worker_options_raise(flag):
    """The three serving options that once refused to start now build their
    worker: a continuous engine, speculation at k, an int8 KV cache
    (tests/test_torch_continuous.py and test_torch_speculative.py hold what
    they serve against JAX)."""
    args = MW.build_parser().parse_args(["--device", "cpu", "--model_size", "test-tiny",
                                         "--controller-address", "", *flag])
    w = MW.build_worker(args)
    try:
        assert (w.continuous is not None) == (flag == ["--continuous"])
        assert w.speculate == (2 if flag[0] == "--speculate" else 0)
        assert w.model.quantize_kv == (flag == ["--quantize-kv"])
    finally:
        if w.continuous is not None:
            w.continuous.shutdown()


def test_stream_outputs_refuses_speculation(jax_side):
    """Speculation is ported: stream_outputs(speculate=2) streams the text of
    speculate=0, chunk for chunk."""
    m = _adapter(jax_side)
    x, prompt = _image(), m.get_caption_prompt()
    plain = list(stream_outputs(m, x, prompt, max_new_tokens=6))
    assert plain and list(stream_outputs(m, x, prompt, max_new_tokens=6, speculate=2)) == plain


def test_worker_cli_rejects_unsupported_adapter():
    with pytest.raises(SystemExit):
        MW.main(["--model", "open_flamingo", "--quantize-decode", "--model_size", "test-tiny",
                 "--device", "cpu", "--controller-address", ""])


# ------------------------------------------------------------ controller, UI
class TestControllerUnit:
    def test_register_and_dispatch(self):
        c = Controller()
        assert c.get_worker_address("m") == ""
        c.register_worker("http://w1", False, {"model_names": ["m"], "queue_length": 0})
        c.register_worker("http://w2", False, {"model_names": ["m"], "queue_length": 5})
        assert c.list_models() == ["m"]
        assert c.get_worker_address("m") == "http://w1"  # shortest queue

    def test_heartbeat_updates(self):
        c = Controller()
        c.register_worker("http://w1", False, {"model_names": ["m"]})
        assert c.heartbeat("http://w1", 3)
        assert c.workers["http://w1"].queue_length == 3
        assert not c.heartbeat("http://nope", 0)

    def test_controller_serves_the_page_and_404s(self):
        import urllib.error

        srv = serve(host="127.0.0.1", port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            with urllib.request.urlopen(base + "/", timeout=10) as r:
                assert r.headers["Content-Type"].startswith("text/html")
                body = r.read().decode()
            assert "worker_generate" in body and "list_models" in body
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(base + "/nope", timeout=10)
            assert ei.value.code == 404
        finally:
            srv.shutdown()


class TestMicroBatcher:
    """Concurrent same-config requests run as ONE padded batched call;
    different configs split; window 0 is one request per call."""

    class _FakeModel:
        device = torch.device("cpu")  # as every adapter has one

        def __init__(self):
            self.calls = []

        def get_caption_prompt(self, caption=None):
            return "<image>Output:"

        def get_vqa_prompt(self, q, a=None):
            return f"<image>Q:{q} A:"

        def get_outputs(self, x, prompts, max_new_tokens=32, num_beams=1):
            self.calls.append((int(x.shape[0]), tuple(prompts), max_new_tokens, num_beams))
            return [f"out:{p}:{max_new_tokens}" for p in prompts]

    def _worker(self, model, window_ms, max_batch=4):
        return MW.ModelWorker(model, "fake", worker_address="http://local", controller_address=None,
                              image_size=8, batch_window_ms=window_ms, max_batch=max_batch)

    def _payload(self, q=None, mnt=8):
        p = {"image": np.zeros((3, 8, 8), np.float32).tolist(), "max_new_tokens": mnt}
        if q is not None:
            p["task"], p["question"] = "vqa", q
        return p

    def _wait_pending(self, w, n):
        import time

        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            with w.batcher.cv:
                if len(w.batcher.pending) >= n:
                    return
            time.sleep(0.005)
        raise AssertionError(f"pending never reached {n}")

    def test_concurrent_requests_coalesce_into_one_padded_call(self):
        model = self._FakeModel()
        w = self._worker(model, window_ms=1500.0, max_batch=4)
        results = [None] * 3

        def call(i):
            results[i] = w.generate(self._payload(q=f"q{i}"))

        ts = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert all(r is not None and r["error_code"] == 0 for r in results)
        for i, r in enumerate(results):
            assert f"q{i}" in r["text"]
        assert len(model.calls) == 1 and model.calls[0][0] == 4 and model.calls[0][2] == 8

    def test_different_configs_split_into_separate_calls(self):
        model = self._FakeModel()
        w = self._worker(model, window_ms=300.0, max_batch=4)
        results = {}

        def call(name, mnt):
            results[name] = w.generate(self._payload(q=name, mnt=mnt))

        ts = [threading.Thread(target=call, args=("a", 8)), threading.Thread(target=call, args=("b", 16))]
        ts[0].start()
        self._wait_pending(w, 1)
        ts[1].start()
        for t in ts:
            t.join(timeout=60)
        assert results["a"]["text"].endswith(":8") and results["b"]["text"].endswith(":16")
        assert len(model.calls) == 2 and {c[2] for c in model.calls} == {8, 16}

    def test_window_zero_is_per_request(self):
        model = self._FakeModel()
        w = self._worker(model, window_ms=0.0)
        assert w.batcher is None
        assert w.generate(self._payload())["error_code"] == 0
        assert len(model.calls) == 1 and model.calls[0][0] == 1

    def test_mixed_config_traffic_waits_for_same_key_fill(self):
        model = self._FakeModel()
        w = self._worker(model, window_ms=5000.0, max_batch=2)
        results = {}

        def call(name, mnt):
            results[name] = w.generate(self._payload(q=name, mnt=mnt))

        t_a0 = threading.Thread(target=call, args=("a0", 8))
        t_a0.start()
        self._wait_pending(w, 1)
        ts = [threading.Thread(target=call, args=("b0", 16)), threading.Thread(target=call, args=("b1", 16))]
        for t in ts:
            t.start()
        self._wait_pending(w, 3)
        t_a1 = threading.Thread(target=call, args=("a1", 8))
        t_a1.start()
        for t in [t_a0, *ts, t_a1]:
            t.join(timeout=60)
        assert all(r["error_code"] == 0 for r in results.values())
        mnt8 = [c for c in model.calls if c[2] == 8]
        assert len(mnt8) == 1, model.calls
        assert {p.split("Q:")[1][:2] for p in mnt8[0][1]} == {"a0", "a1"}

    def test_invalid_max_batch_rejected(self):
        with pytest.raises(ValueError, match="max_batch"):
            self._worker(self._FakeModel(), window_ms=10.0, max_batch=0)
