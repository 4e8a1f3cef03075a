"""`scripts/bench_worker_torch.py` on the CPU at test-tiny size: the four
stages of `tests/test_bench_worker.py` (single request and stream, the
micro-batched concurrency stage, staggered arrivals against the continuous
engine and the window batcher) through real localhost HTTP via the port's
controller, and the served text equal to JAX's tiny worker's on the same
weights (float32)."""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import bench_worker  # noqa: E402
import bench_worker_torch as W  # noqa: E402

from robustvlm_tpu.models.llava.model import LLAVA_CONFIGS as JAX_CONFIGS  # noqa: E402
from robustvlm_tpu.models.llava.model import init_llava_params  # noqa: E402
from robustvlm_tpu.vlm_eval import eval_models as jax_eval_models  # noqa: E402
from robustvlm_tpu_torch.models.llava import LLAVA_CONFIGS, Llava, params_from_jax  # noqa: E402
from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel, WordTokenizer  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, init_llava_params(jax.random.PRNGKey(0), JAX_CONFIGS["test-tiny"]))


@pytest.fixture(scope="module")
def tiny_model(tree):
    cfg = LLAVA_CONFIGS["test-tiny"]
    return LlavaEvalModel(Llava.from_state(cfg, params_from_jax(tree)), WordTokenizer(cfg.llama.vocab_size),
                          compute_dtype=torch.float32, max_post_len=16)


@pytest.fixture(scope="module")
def img_b64(tiny_model):
    return W._png_b64(tiny_model.cfg.vision.image_size, seed=3)


def test_single_and_stream_stages(tiny_model, img_b64):
    size = tiny_model.cfg.vision.image_size
    stack, url = W._serve(tiny_model, image_size=size, window_ms=0.0, max_batch=1)
    try:
        single = W.bench_single(url, img_b64, max_new=3, reps=1)
        assert single["stage"] == "single_request"
        assert single["latency_s"] > 0 and single["tokens_per_sec"] > 0
        assert 0 < single["tokens_emitted"] <= 3
        stream = W.bench_stream(url, img_b64, max_new=3, reps=1)
        assert stream["stage"] == "stream_single"
        assert stream["total_s"] > 0
        assert 0 <= stream["n_chunks"] <= 3
    finally:
        stack.shutdown()


def test_served_text_equals_jax_tiny_worker(tree, tiny_model, img_b64):
    cfg = JAX_CONFIGS["test-tiny"]
    jax_model = jax_eval_models.LlavaEvalModel(jax.tree.map(jnp.asarray, tree), cfg,
                                               jax_eval_models.WordTokenizer(cfg.llama.vocab_size),
                                               compute_dtype=jnp.float32, max_post_len=16)
    payload = {"model": W.MODEL_NAME, "image_b64": img_b64, "task": "caption", "max_new_tokens": 5}
    jsrv, jurl = bench_worker._serve(jax_model, image_size=cfg.vision.image_size, window_ms=0.0, max_batch=1)
    try:
        want = W._post(jurl + "/worker_generate", payload)
    finally:
        jsrv.shutdown()
    stack, url = W._serve(tiny_model, image_size=cfg.vision.image_size, window_ms=0.0, max_batch=1)
    try:
        got = W._post(url + "/worker_generate", payload)
        vqa = {**payload, "task": "vqa", "question": "what is in image 0"}
        got_vqa = W._post(url + "/worker_generate", vqa)
    finally:
        stack.shutdown()
    jsrv, jurl = bench_worker._serve(jax_model, image_size=cfg.vision.image_size, window_ms=0.0, max_batch=1)
    try:
        want_vqa = W._post(jurl + "/worker_generate", vqa)
    finally:
        jsrv.shutdown()
    assert got["error_code"] == want["error_code"] == 0
    assert got["text"] == want["text"] and got["text"].startswith("tok")
    assert got_vqa["text"] == want_vqa["text"]


def test_concurrent_stage_batches_and_counts(tiny_model, img_b64):
    size = tiny_model.cfg.vision.image_size
    stack, url = W._serve(tiny_model, image_size=size, window_ms=20.0, max_batch=2)
    try:
        out = W.bench_concurrent(url, img_b64, max_new=3, conc=2, reqs=2)
        assert out["stage"] == "concurrent_batched"
        assert out["concurrency"] == 2 and out["tokens_counted"] == "emitted"
        # at most 2 clients x 2 requests x 3 tokens
        assert 0 < out["aggregate_tokens_per_sec"] <= 2 * 2 * 3 / out["wall_s"] * 1.01
    finally:
        stack.shutdown()


def test_staggered_stage_continuous_and_batcher(tiny_model, img_b64):
    size = tiny_model.cfg.vision.image_size
    stack, url, eng = W._serve_continuous(tiny_model, image_size=size, n_slots=2, max_new=3, chunk=2, width=16)
    try:
        out = W.bench_staggered(url, img_b64, 3, conc=2, reqs=2, stagger_s=0.05, mode="continuous")
        assert out["stage"] == "staggered_arrivals" and out["mode"] == "continuous"
        assert out["tokens_counted"] == "emitted"
        assert 0 < out["aggregate_tokens_per_sec"] <= 2 * 2 * 3 / out["wall_s"] * 1.01
    finally:
        stack.shutdown()
        eng.shutdown()
    stack, url = W._serve(tiny_model, image_size=size, window_ms=20.0, max_batch=2)
    try:
        out = W.bench_staggered(url, img_b64, 3, conc=2, reqs=2, stagger_s=0.05, mode="window_batcher")
        assert out["mode"] == "window_batcher" and out["aggregate_tokens_per_sec"] > 0
    finally:
        stack.shutdown()


def test_stream_times_counts_ndjson_chunks(tiny_model, img_b64):
    size = tiny_model.cfg.vision.image_size
    stack, url = W._serve(tiny_model, image_size=size, window_ms=0.0, max_batch=1)
    try:
        t_first, t_total, n = W._stream_times(url + "/worker_generate_stream",
                                              {"model": W.MODEL_NAME, "image_b64": img_b64, "task": "caption",
                                               "max_new_tokens": 4})
        assert t_total >= (t_first or 0)
        assert 0 <= n <= 4
    finally:
        stack.shutdown()


def test_run_stages_summary(tiny_model, capsys):
    summary = W.run_stages(tiny_model, max_new=3, stream_new=3, concs=[2], reqs=1, cb_concs=[2], cb_chunk=2,
                           stagger_s=0.02, cb_width=16)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [ln.get("stage") for ln in lines[:-1]] == ["single_request", "stream_single", "concurrent_batched",
                                                      "staggered_arrivals", "staggered_arrivals"]
    assert lines[-1]["metric"] == "llava7b_worker_e2e_tokens_per_sec"
    assert summary["failed"] == [] and summary["value"] > 0
    assert set(summary["staggered_aggregate"]) == {"continuous_c2", "window_batcher_c2"}
    for ln in lines[2:-1]:  # every point carries the count its rate is taken over
        assert ln["aggregate_tokens_per_sec"] == pytest.approx(ln["tokens_emitted"] / ln["wall_s"])
