"""The port's continuous-batching engine (robustvlm_tpu_torch.serve.continuous)
against the port's solo batch-1 stream and the JAX package's
`ContinuousEngine`, on the tiny LLaVA's float32 weights carried across from
JAX: every scenario of tests/test_continuous.py but the FSDP one (it waits
for parallelism) and the unstacked-layout one (the port has one layout),
token-exact on the CPU. Lane isolation is exact math here: attention masks
confine each lane to its own cache rows."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.models.llava import model as JV
from robustvlm_tpu.serve import continuous as JC
from robustvlm_tpu.vlm_eval import eval_models as JE
from robustvlm_tpu_torch.models.llava import model as PV
from robustvlm_tpu_torch.models.llava.convert import params_from_jax
from robustvlm_tpu_torch.serve import model_worker as MW
from robustvlm_tpu_torch.serve.continuous import CBRequest, ContinuousEngine, _Slot
from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel, WordTokenizer, truncate_at_stops

torch.set_num_threads(1)

CFG = JV.LLAVA_CONFIGS["test-tiny"]
PCFG = PV.LLAVA_CONFIGS["test-tiny"]


def _jax_engine_ids(model, imgs, prompt, **kw):
    eng = JC.ContinuousEngine(model, n_slots=2, width=8, max_new=8, **kw)
    try:
        rs = [eng.submit(im, prompt, 8) for im in imgs]
        return [r.wait_ids() for r in rs]
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def setup():
    """The port's adapter (and one with quantize_kv) on the JAX tiny LLaVA's
    weights, three images, the solo stream, and the JAX engine's tokens for
    the three images (float and int8 KV)."""
    tree = jax.tree.map(np.asarray, JV.init_llava_params(jax.random.PRNGKey(0), CFG))

    def adapter(kv):
        m = LlavaEvalModel(PV.Llava.from_state(PCFG, params_from_jax(tree)),
                           WordTokenizer(PCFG.llama.vocab_size), compute_dtype=torch.float32,
                           max_post_len=16)
        m.quantize_kv = kv
        return m

    model, model_kv = adapter(False), adapter(True)
    rng = np.random.RandomState(1)
    imgs = [rng.rand(3, 32, 32).astype(np.float32) for _ in range(3)]
    prompt = model.get_caption_prompt()

    def solo(m, img, max_new=8):
        ids = []
        for t in m.stream_tokens(torch.from_numpy(img)[None], [prompt], max_new):
            tid = int(t[0])
            if tid in (m.tok.eos_token_id, m.tok.pad_token_id):
                break
            ids.append(tid)
        return ids

    jax_ids = {}
    for kv in (False, True):
        jm = JE.LlavaEvalModel(jax.tree.map(jnp.asarray, tree), CFG,
                               JE.WordTokenizer(CFG.llama.vocab_size), compute_dtype=jnp.float32,
                               max_post_len=16)
        jm.quantize_kv = kv
        jax_ids[kv] = _jax_engine_ids(jm, imgs, prompt)
    return model, model_kv, imgs, prompt, solo, jax_ids


def test_solo_stream_equals_jax_engine(setup):
    model, model_kv, imgs, _, solo, jax_ids = setup
    assert [solo(model, im) for im in imgs] == jax_ids[False]
    assert [solo(model_kv, im) for im in imgs] == jax_ids[True]
    assert all(len(ids) > 2 for ids in jax_ids[False])


def test_single_request_matches_solo_stream(setup):
    model, _, imgs, prompt, solo, jax_ids = setup
    ref = solo(model, imgs[0])
    eng = ContinuousEngine(model, n_slots=2, width=8, max_new=8)
    try:
        assert eng.submit(imgs[0], prompt, 8).wait_ids() == ref == jax_ids[False][0]
    finally:
        eng.shutdown()


def test_staggered_admission_is_isolated(setup):
    """A request admitted into a RUNNING decode batch gets the tokens of a
    solo run."""
    model, _, imgs, prompt, solo, jax_ids = setup
    refs = [solo(model, im) for im in imgs[:2]]
    eng = ContinuousEngine(model, n_slots=2, width=8, max_new=8)
    try:
        ra = eng.submit(imgs[0], prompt, 8)
        first = next(iter(ra.token_stream()))  # ra is mid-decode before rb arrives
        rb = eng.submit(imgs[1], prompt, 8)
        ga = [first] + list(ra.token_stream())
        assert [ga, rb.wait_ids()] == refs == jax_ids[False][:2]
    finally:
        eng.shutdown()


def test_slot_reuse_overwrites_stale_cache(setup):
    """3 requests through 2 lanes: the third reuses a retired lane, and the
    previous occupant's KV rows do not touch its tokens."""
    model, _, imgs, prompt, solo, jax_ids = setup
    refs = [solo(model, im) for im in imgs]
    eng = ContinuousEngine(model, n_slots=2, width=8, max_new=8)
    try:
        rs = [eng.submit(im, prompt, 8) for im in imgs]
        assert [r.wait_ids() for r in rs] == refs == jax_ids[False]
    finally:
        eng.shutdown()


def test_chunked_dispatch_parity(setup):
    """chunk=3 (3 decode steps a dispatch, not dividing max_new - 1): the same
    tokens; the clamped writes of lanes past their cap stay in bounds."""
    model, _, imgs, prompt, solo, jax_ids = setup
    refs = [solo(model, im) for im in imgs]
    eng = ContinuousEngine(model, n_slots=2, width=8, max_new=8, chunk=3)
    try:
        rs = [eng.submit(im, prompt, 8) for im in imgs]
        assert [r.wait_ids() for r in rs] == refs == jax_ids[False]
    finally:
        eng.shutdown()


def test_int8_kv_cache_engine_parity(setup):
    """Under quantize_kv the engine holds int8 lanes and decodes the int8 solo
    stream's tokens, and JAX's int8 engine's."""
    _, model_kv, imgs, prompt, solo, jax_ids = setup
    refs = [solo(model_kv, im) for im in imgs]
    eng = ContinuousEngine(model_kv, n_slots=2, width=8, max_new=8)
    try:
        rs = [eng.submit(im, prompt, 8) for im in imgs]
        assert [r.wait_ids() for r in rs] == refs == jax_ids[True]
        assert eng._bcaches["k"].dtype == torch.int8 and eng._bcaches["ks"].dtype == torch.float32
        assert eng._bcaches["k"].shape[1] == 2  # lanes on axis 1
    finally:
        eng.shutdown()


def test_prompt_wider_than_engine_rejected(setup):
    model, _, imgs, prompt, _, _ = setup
    eng = ContinuousEngine(model, n_slots=1, width=2, max_new=4)
    try:
        with pytest.raises(ValueError, match="post tokens"):
            eng.submit(imgs[0], prompt + " a b c d e f g h", 4)
    finally:
        eng.shutdown()


def test_other_pre_image_segment_rejected(setup):
    model, _, imgs, prompt, _, _ = setup
    eng = ContinuousEngine(model, n_slots=1, width=8, max_new=4)
    try:
        eng.submit(imgs[0], prompt, 0).wait_ids()
        with pytest.raises(ValueError, match="pinned prompt prefix"):
            eng.submit(imgs[0], "other words " + prompt, 4)
    finally:
        eng.shutdown()


def test_cancel_frees_lane_for_next_request(setup):
    """cancel() retires the lane at the next emission point, and the freed
    lane serves the next request exactly; the retirement itself is checked
    on a quiesced engine, host-side."""
    model, _, imgs, prompt, solo, _ = setup
    ref1 = solo(model, imgs[1])
    eng = ContinuousEngine(model, n_slots=1, width=8, max_new=8)
    try:
        r = eng.submit(imgs[0], prompt, 8)
        r.cancel()  # may land before, during or after decode
        list(r.token_stream())
        assert eng.submit(imgs[1], prompt, 8).wait_ids() == ref1
    finally:
        eng.shutdown()
    eng2 = ContinuousEngine(model, n_slots=1, width=8, max_new=8)
    eng2.shutdown()
    dummy = CBRequest(imgs[0], prompt, 8)
    dummy.cancel()
    eng2._slots[0] = _Slot(dummy, 8)
    eng2._emit(0, 42)
    assert eng2._slots[0] is None  # retired
    assert dummy.tokens.get() is None  # nothing emitted, the stream ended


def test_dispatch_failure_fails_batch_then_recovers(setup):
    """A failed dispatch retires the running batch with the error on each
    stream, drops the lane caches, and the next admission rebuilds them."""
    model, _, imgs, prompt, solo, _ = setup
    ref = solo(model, imgs[1])
    eng = ContinuousEngine(model, n_slots=1, width=8, max_new=8)
    try:
        orig, fired = eng._dispatch, []

        def boom():
            if not fired:
                fired.append(1)
                raise RuntimeError("injected device failure")
            return orig()

        eng._dispatch = boom
        r1 = eng.submit(imgs[0], prompt, 8)
        with pytest.raises(RuntimeError, match="injected"):
            list(r1.token_stream())
        assert eng._bcaches is None
        assert eng.submit(imgs[1], prompt, 8).wait_ids() == ref
    finally:
        eng.shutdown()


def test_admission_failure_fails_batch_then_recovers(setup):
    """A core that raises during admission fails the batch the same way."""
    model, _, imgs, prompt, solo, _ = setup
    ref = solo(model, imgs[1])
    eng = ContinuousEngine(model, n_slots=2, width=8, max_new=8)
    try:
        orig = model._continuous_cores

        def broken(*a, **kw):
            admit, step, lanes = orig(*a, **kw)

            def bad_admit(*b):
                raise RuntimeError("injected admission failure")

            return bad_admit, step, lanes

        model._continuous_cores = broken
        try:
            r1 = eng.submit(imgs[0], prompt, 8)
            with pytest.raises(RuntimeError, match="injected admission"):
                list(r1.token_stream())
        finally:
            del model._continuous_cores
        assert eng._bcaches is None
        assert eng.submit(imgs[1], prompt, 8).wait_ids() == ref
    finally:
        eng.shutdown()


def test_max_new_zero_emits_nothing(setup):
    model, _, imgs, prompt, _, _ = setup
    eng = ContinuousEngine(model, n_slots=1, width=8, max_new=8)
    try:
        assert eng.submit(imgs[0], prompt, 0).wait_ids() == []
    finally:
        eng.shutdown()


def test_non_llama_family_rejected():
    class _Cfg:
        lm_family = "mpt"

    class _M:
        cfg = _Cfg()

        def _continuous_cores(self):
            pass

        class tok:
            pad_token_id = 0
            eos_token_id = 2

    with pytest.raises(ValueError, match="llama"):
        ContinuousEngine(_M())
    with pytest.raises(ValueError, match=">= 1"):
        ContinuousEngine(LlavaEvalModel(PV.Llava(PCFG), WordTokenizer(), compute_dtype=torch.float32),
                         n_slots=0)


def test_worker_routes_through_engine(setup):
    """/worker_generate collects the lane's stream and /worker_generate_stream
    yields cumulative text; both equal the solo greedy decode."""
    model, _, imgs, prompt, solo, _ = setup
    ref_text = truncate_at_stops(model.tok.decode(solo(model, imgs[0])), model.DEFAULT_STOPS)
    eng = ContinuousEngine(model, n_slots=2, width=8, max_new=8)
    try:
        w = MW.ModelWorker(model, "llava-tiny", worker_address="", controller_address=None,
                           image_size=32, continuous=eng)
        payload = {"image": imgs[0].tolist(), "task": "caption", "max_new_tokens": 8}
        out = w.generate(dict(payload))
        assert out["error_code"] == 0 and out["text"] == ref_text
        chunks = list(w.generate_stream(dict(payload)))
        assert all(c["error_code"] == 0 for c in chunks)
        assert chunks[-1]["text"] == ref_text
    finally:
        eng.shutdown()


def test_worker_stream_cancels_lane_at_stop_string(setup):
    """A stop string in the stream cancels the lane: the text ends before it
    and the single lane serves the next request."""
    model, _, imgs, prompt, solo, _ = setup
    ids = solo(model, imgs[0])
    stop = model.tok.decode(ids[1:2])
    eng = ContinuousEngine(model, n_slots=1, width=8, max_new=8)
    old = model.DEFAULT_STOPS
    try:
        model.DEFAULT_STOPS = (stop,)
        w = MW.ModelWorker(model, "llava-tiny", worker_address="", image_size=32, continuous=eng)
        payload = {"image": imgs[0].tolist(), "task": "caption", "max_new_tokens": 8}
        chunks = list(w.generate_stream(dict(payload)))
        assert chunks[-1]["text"] == model.tok.decode(ids[:1])
        model.DEFAULT_STOPS = old
        assert eng.submit(imgs[1], prompt, 8).wait_ids() == solo(model, imgs[1])
    finally:
        model.DEFAULT_STOPS = old
        eng.shutdown()


def test_concurrent_submissions_all_exact(setup):
    """Three threads submit at once against 2 lanes: queueing, staggered
    admission and reuse under racing submits."""
    model, _, imgs, prompt, solo, jax_ids = setup
    refs = [solo(model, im) for im in imgs]
    eng = ContinuousEngine(model, n_slots=2, width=8, max_new=8)
    got = [None] * 3

    def run(i):
        got[i] = eng.submit(imgs[i], prompt, 8).wait_ids()

    try:
        ts = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
            time.sleep(0.01)
        for t in ts:
            t.join(timeout=120)
        assert got == refs == jax_ids[False]
    finally:
        eng.shutdown()


def test_worker_cli_builds_the_engine():
    args = MW.build_parser().parse_args(["--device", "cpu", "--model_size", "test-tiny",
                                         "--controller-address", "", "--continuous", "--cb-slots",
                                         "3", "--cb-width", "16", "--cb-max-new", "5",
                                         "--cb-chunk", "2", "--quantize-kv"])
    w = MW.build_worker(args)
    try:
        eng = w.continuous
        assert isinstance(eng, ContinuousEngine) and w.speculate == 0
        assert (eng.n_slots, eng.width, eng.max_new, eng.chunk) == (3, 16, 5, 2)
        assert w.model.quantize_kv
        img = np.random.RandomState(0).rand(3, 32, 32).astype(np.float32)
        out = w.generate({"image": img.tolist(), "max_new_tokens": 3})
        assert out["error_code"] == 0 and len(out["text"].split()) <= 3
    finally:
        w.continuous.shutdown()
    defaults = MW.build_parser().parse_args([])
    assert (defaults.cb_slots, defaults.cb_width, defaults.cb_max_new, defaults.cb_chunk) == (4, 32, 64, 1)


def test_many_racing_submitters_under_fast_thread_switching(setup):
    """Twelve threads (more than the cores) submit against 2 lanes with the
    interpreter switching threads every 10 us: every request completes with
    its solo stream's tokens (a lost queue or slot update would drop or
    cross a request)."""
    import sys

    model, _, imgs, prompt, solo, _ = setup
    refs = [solo(model, im, 4) for im in imgs]
    eng = ContinuousEngine(model, n_slots=2, width=8, max_new=4)
    got = [None] * 12

    def run(i):
        got[i] = eng.submit(imgs[i % 3], prompt, 4).wait_ids()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=run, args=(i,)) for i in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        assert got == [refs[i % 3] for i in range(12)]
    finally:
        sys.setswitchinterval(old)
        eng.shutdown()


def test_worker_stream_closed_early_frees_the_lane(setup):
    """A client that stops reading the stream (the generator closed after
    its first chunk) cancels its request, and the single lane serves the
    next request exactly."""
    model, _, imgs, prompt, solo, _ = setup
    eng = ContinuousEngine(model, n_slots=1, width=8, max_new=8)
    submitted = []
    real_submit = eng.submit

    def submit(*a, **kw):
        submitted.append(real_submit(*a, **kw))
        return submitted[-1]

    eng.submit = submit
    try:
        w = MW.ModelWorker(model, "llava-tiny", worker_address="", image_size=32, continuous=eng)
        stream = w.generate_stream({"image": imgs[0].tolist(), "task": "caption", "max_new_tokens": 8})
        assert next(stream)["error_code"] == 0
        assert not submitted[0].cancelled
        stream.close()
        assert submitted[0].cancelled
        assert real_submit(imgs[1], prompt, 8).wait_ids() == solo(model, imgs[1])
    finally:
        eng.shutdown()
