"""The port's prompt-lookup speculative decoding
(robustvlm_tpu_torch.serve.speculative) against the port's plain stream and
the JAX package's `spec_stream_tokens`, on the tiny LLaVA's float32 weights
carried across from JAX: every scenario of tests/test_speculative.py but the
unstacked-layout one (the port has one layout). Greedy verification keeps
the stream token-exact on the CPU for any drafter; `draft_prompt_lookup`
equals JAX's on seeded and generated id sequences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from robustvlm_tpu.models.llava import model as JV
from robustvlm_tpu.serve import speculative as JS
from robustvlm_tpu.vlm_eval import eval_models as JE
from robustvlm_tpu_torch.models.llava import model as PV
from robustvlm_tpu_torch.models.llava.convert import params_from_jax
from robustvlm_tpu_torch.serve import model_worker as MW
from robustvlm_tpu_torch.serve.speculative import draft_prompt_lookup, spec_stream_tokens
from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel, WordTokenizer, truncate_at_stops

torch.set_num_threads(1)

CFG = JV.LLAVA_CONFIGS["test-tiny"]
PCFG = PV.LLAVA_CONFIGS["test-tiny"]


def _collect(gen, tok):
    ids = []
    for t in gen:
        tid = int(t[0])
        if tid in (tok.eos_token_id, tok.pad_token_id):
            break
        ids.append(tid)
    return ids


@pytest.fixture(scope="module")
def setup():
    """The port's adapters (float and int8 KV cache) and JAX's on the same
    weights, three images, and the port's plain stream."""
    tree = jax.tree.map(np.asarray, JV.init_llava_params(jax.random.PRNGKey(0), CFG))

    def adapter(kv):
        m = LlavaEvalModel(PV.Llava.from_state(PCFG, params_from_jax(tree)),
                           WordTokenizer(PCFG.llama.vocab_size), compute_dtype=torch.float32,
                           max_post_len=16)
        m.quantize_kv = kv
        return m

    jm = JE.LlavaEvalModel(jax.tree.map(jnp.asarray, tree), CFG, JE.WordTokenizer(CFG.llama.vocab_size),
                           compute_dtype=jnp.float32, max_post_len=16)
    rng = np.random.RandomState(1)
    imgs = [rng.rand(3, 32, 32).astype(np.float32) for _ in range(3)]
    model = adapter(False)
    prompt = model.get_caption_prompt()

    def solo(m, img, max_new=8):
        return _collect(m.stream_tokens(torch.from_numpy(img)[None], [prompt], max_new), m.tok)

    return model, adapter(True), jm, imgs, prompt, solo


def _x(img):
    return torch.from_numpy(img)[None]


# ---------------------------------------------------------------- drafter
def test_drafter_latest_ngram_wins():
    # [5, 6] occurs at 0 and 4; the most recent (4) supplies the draft
    assert draft_prompt_lookup([5, 6, 7, 9, 5, 6, 8, 5, 6], 2) == [8, 5]


def test_drafter_no_match_repeats_last():
    assert draft_prompt_lookup([1, 2, 3], 3) == [3, 3, 3]


def test_drafter_short_continuation_pads():
    assert draft_prompt_lookup([9, 5, 9, 5], 3) == [9, 5, 5]


def test_drafter_prefers_longer_ngram():
    # the 1-gram [6] would draft 9; the 2-gram [5, 6] match wins with 7
    assert draft_prompt_lookup([5, 6, 7, 3, 6, 9, 5, 6], 1)[0] == 7


def test_drafter_k_zero():
    assert draft_prompt_lookup([1, 2], 0) == []


@pytest.mark.parametrize("seed", range(4))
def test_drafter_equals_jax_on_seeded_ids(seed):
    rng = np.random.RandomState(seed)
    for _ in range(50):
        ids = rng.randint(0, 4 + seed, rng.randint(1, 30)).tolist()
        k, n = int(rng.randint(0, 9)), int(rng.randint(1, 5))
        assert draft_prompt_lookup(ids, k, max_ngram=n) == JS.draft_prompt_lookup(ids, k, max_ngram=n)


@settings(max_examples=150, deadline=None)
@given(ids=st.lists(st.integers(0, 5), min_size=1, max_size=40), k=st.integers(0, 10),
       n=st.integers(1, 5))
def test_drafter_equals_jax_generated(ids, k, n):
    assert draft_prompt_lookup(ids, k, max_ngram=n) == JS.draft_prompt_lookup(ids, k, max_ngram=n)


# ------------------------------------------------------------- exactness
@pytest.mark.parametrize("k", [1, 3, 8])
def test_token_exact_vs_stream(setup, k):
    model, _, jm, imgs, prompt, solo = setup
    for img in imgs[:2]:
        got = _collect(spec_stream_tokens(model, _x(img), [prompt], 8, k=k), model.tok)
        assert got == solo(model, img)


@pytest.mark.parametrize("k", [2, 5])
def test_tokens_and_stats_equal_jax(setup, k):
    """The port's speculative stream and its stats as JAX's, with the default
    drafter and with a drafter that copies from the true continuation."""
    model, _, jm, imgs, prompt, solo = setup
    ref = solo(model, imgs[0])
    pre_ids, toks, n_pad = model._tokenize_gen([prompt])
    n_prompt = len(pre_ids) + toks.shape[1] - int(n_pad[0])

    def partial(ids, kk):  # the true continuation but for its last draft
        g = len(ids) - n_prompt
        cont = list(ref[g: g + kk]) + [0] * kk
        return cont[:kk - 1] + [3]

    for drafter in (None, partial):
        js, ps = {}, {}
        want = _collect(JS.spec_stream_tokens(jm, jnp.asarray(imgs[0])[None], [prompt], 8, k=k,
                                              drafter=drafter, stats=js), jm.tok)
        got = _collect(spec_stream_tokens(model, _x(imgs[0]), [prompt], 8, k=k, drafter=drafter,
                                          stats=ps), model.tok)
        assert got == want == ref and ps == js


def test_token_exact_int8_kv(setup):
    _, model_kv, jm, imgs, prompt, solo = setup
    ref = solo(model_kv, imgs[0])
    got = _collect(spec_stream_tokens(model_kv, _x(imgs[0]), [prompt], 8, k=3), model_kv.tok)
    assert got == ref
    jm.quantize_kv = True
    try:
        want = _collect(JS.spec_stream_tokens(jm, jnp.asarray(imgs[0])[None], [prompt], 8, k=3), jm.tok)
    finally:
        jm.quantize_kv = False
    assert got == want


def test_adversarial_drafter_cannot_corrupt_output(setup):
    """Maximally wrong drafts (never accepted, every verify leaves k stale
    rows) still give the exact greedy stream: stale rows are never read."""
    model, _, _, imgs, prompt, solo = setup

    def hostile(ids, k):
        return [(7 + 13 * j + len(ids)) % 500 for j in range(k)]

    got = _collect(spec_stream_tokens(model, _x(imgs[0]), [prompt], 8, k=5, drafter=hostile),
                   model.tok)
    assert got == solo(model, imgs[0])


# ------------------------------------------------------------ acceptance
def test_oracle_drafter_full_acceptance(setup):
    """A drafter that proposes the true greedy continuation gets every draft
    accepted: bursts of k + 1 a verify step, accept_rate above 0.5."""
    model, _, _, imgs, prompt, solo = setup
    k, max_new = 3, 8
    for img in imgs:
        ref = solo(model, img, max_new)
        if len(ref) == max_new:  # no EOS inside the window
            break
    else:
        pytest.fail("every probe image hit EOS early")
    pre_ids, toks, n_pad = model._tokenize_gen([prompt])
    prompt_ids = list(pre_ids) + [int(v) for v in toks[0][int(n_pad[0]):]]

    def oracle(ids, kk):
        g = len(ids) - len(prompt_ids)
        cont = ref[g: g + kk]
        return list(cont) + [0] * (kk - len(cont))

    stats = {}
    got = _collect(spec_stream_tokens(model, _x(img), [prompt], max_new, k=k, drafter=oracle,
                                      stats=stats), model.tok)
    assert got == ref
    assert stats["verify_steps"] == -(-(max_new - 1) // (k + 1))
    assert stats["emitted"] == max_new
    assert stats["accept_rate"] > 0.5


def test_stats_counts_rejections(setup):
    model, _, _, imgs, prompt, _ = setup
    stats = {}
    _collect(spec_stream_tokens(model, _x(imgs[0]), [prompt], 6, k=2,
                                drafter=lambda ids, k: [499] * k, stats=stats), model.tok)
    assert stats["verify_steps"] >= 1
    assert stats["accept_rate"] == 0.0


# ------------------------------------------------------------------ edges
def test_max_new_cap_mid_burst(setup):
    """The cap lands inside an accepted burst: exactly max_new tokens, the
    plain stream's prefix."""
    model, _, _, imgs, prompt, solo = setup
    full = solo(model, imgs[0], 8)
    assert len(full) >= 5
    pre_ids, toks, n_pad = model._tokenize_gen([prompt])
    n_prompt = len(pre_ids) + (toks.shape[1] - int(n_pad[0]))

    def oracle(ids, kk):
        g = len(ids) - n_prompt
        cont = full[g: g + kk]
        return list(cont) + [0] * (kk - len(cont))

    got = _collect(spec_stream_tokens(model, _x(imgs[0]), [prompt], 5, k=8, drafter=oracle), model.tok)
    assert got == full[:5]


def test_max_new_zero_emits_nothing(setup):
    model, _, _, imgs, prompt, _ = setup
    stats = {}
    assert list(spec_stream_tokens(model, _x(imgs[0]), [prompt], 0, stats=stats)) == []
    assert stats == {"verify_steps": 0, "emitted": 0, "accept_rate": 0.0}


def test_batch_gt1_rejected(setup):
    model, _, _, imgs, prompt, _ = setup
    x = torch.from_numpy(np.stack(imgs[:2]))
    with pytest.raises(ValueError, match="single-stream"):
        next(iter(spec_stream_tokens(model, x, [prompt, prompt], 4)))


def test_bad_k_rejected(setup):
    model, _, _, imgs, prompt, _ = setup
    with pytest.raises(ValueError, match="k must be"):
        next(iter(spec_stream_tokens(model, _x(imgs[0]), [prompt], 4, k=0)))
    with pytest.raises(ValueError, match="drafter returned"):
        list(spec_stream_tokens(model, _x(imgs[0]), [prompt], 4, k=2, drafter=lambda ids, k: [5]))


def test_worker_stream_routes_through_speculative(setup, monkeypatch):
    """/worker_generate_stream of a worker with speculate=3 goes through the
    speculative decoder and ends on the plain stream's text."""
    from robustvlm_tpu_torch.serve import speculative

    model, _, _, imgs, prompt, solo = setup
    ref_text = truncate_at_stops(model.tok.decode(solo(model, imgs[0])), model.DEFAULT_STOPS)
    calls = []
    real = speculative.spec_stream_tokens

    def counted(*a, **kw):
        calls.append(kw["k"])
        return real(*a, **kw)

    monkeypatch.setattr(speculative, "spec_stream_tokens", counted)
    w = MW.ModelWorker(model, "llava-tiny", worker_address="", controller_address=None, image_size=32,
                       speculate=3)
    chunks = list(w.generate_stream({"image": imgs[0].tolist(), "task": "caption", "max_new_tokens": 8}))
    assert all(c["error_code"] == 0 for c in chunks)
    assert chunks[-1]["text"] == ref_text and calls == [3]


def test_worker_cli_speculate_and_its_refusal_with_continuous():
    base = ["--device", "cpu", "--model_size", "test-tiny", "--controller-address", ""]
    w = MW.build_worker(MW.build_parser().parse_args(base + ["--speculate", "4"]))
    assert w.speculate == 4 and w.continuous is None and not w.model.quantize_kv
    with pytest.raises(SystemExit, match="--speculate and --continuous"):
        MW.build_worker(MW.build_parser().parse_args(base + ["--speculate", "4", "--continuous"]))
