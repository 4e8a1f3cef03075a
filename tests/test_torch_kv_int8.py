"""The port's int8 KV cache (robustvlm_tpu_torch.models.llama `_quantize_kv`,
`_attn` with k/v scales, `init_cache(kv_bits=8)`, and
`LlavaEvalModel.quantize_kv`) against the JAX package's on the same inputs
and weights, float32 on the CPU:

- codes and scales bit-equal, exact .5 ties included (both round half to
  even);
- one cached decode step's attention within 1e-5 of JAX's largest |value|;
  a cached LLaMA decode's logits within 1e-4;
- the cache's shapes and dtypes;
- greedy and beam captions of the tiny LLaVA token-equal to JAX's;
- the int8 cache refused for the MPT family, as in JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.models.llama import model as JL
from robustvlm_tpu.models.llava import model as JV
from robustvlm_tpu.vlm_eval import eval_models as JE
from robustvlm_tpu_torch.models.llama import LLAMA_CONFIGS, Llama, init_cache, llama_forward
from robustvlm_tpu_torch.models.llama import model as PL
from robustvlm_tpu_torch.models.llama.convert import params_from_jax as llama_from_jax
from robustvlm_tpu_torch.models.llava import model as PV
from robustvlm_tpu_torch.models.llava.convert import params_from_jax
from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel, WordTokenizer

torch.set_num_threads(1)

CFG = JV.LLAVA_CONFIGS["test-tiny"]
PCFG = PV.LLAVA_CONFIGS["test-tiny"]


def _ties():
    """Rows whose scale is exactly 1 (absmax 127) holding exact .5 ties of
    both signs, beside zero rows (scale 1e-8 / 127)."""
    x = np.zeros((1, 2, 3, 8), np.float32)
    x[0, 0, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 63.5]
    x[0, 1, 1] = [-127.0, 126.5, -126.5, 3.5, -3.5, 0.0, 4.5, -64.5]
    return x


@pytest.mark.parametrize("case", ["normal", "wide", "ties"])
def test_quantize_kv_codes_and_scales_bit_equal_jax(case):
    rng = np.random.RandomState(0)
    if case == "normal":
        x = rng.randn(2, 4, 5, 16).astype(np.float32)
    elif case == "wide":
        x = (rng.randn(3, 2, 7, 128) * np.exp(rng.randn(3, 2, 7, 1) * 3)).astype(np.float32)
    else:
        x = _ties()
    jq, js = JL._quantize_kv(jnp.asarray(x))
    pq, ps = PL._quantize_kv(torch.from_numpy(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32 and tuple(ps.shape) == x.shape[:-1]
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy().view(np.int32), np.asarray(js).view(np.int32))
    if case == "ties":
        assert pq[0, 0, 0].tolist() == [127, 0, 2, 2, 0, -2, -2, 64]


@pytest.mark.parametrize("n_kv", [4, 2])
def test_cached_decode_attention_matches_jax(n_kv):
    """One decode query per example over an int8 cache of 12 slots, per-example
    query slots and key masks (GQA with 2 KV heads too)."""
    rng = np.random.RandomState(1)
    b, hq, n, hd = 2, 4, 12, 16
    q = rng.randn(b, hq, 1, hd).astype(np.float32)
    kv = rng.randn(2, b, n_kv, n, hd).astype(np.float32)
    qpos = np.asarray([[7], [10]])
    kv_mask = np.ones((b, n), bool)
    kv_mask[0, :2] = False  # left padding of the first example
    jk, jks = JL._quantize_kv(jnp.asarray(kv[0]))
    jv, jvs = JL._quantize_kv(jnp.asarray(kv[1]))
    ref = np.asarray(JL._attn(jnp.asarray(q), jk, jv, causal=True, flash=False,
                              q_positions=jnp.asarray(qpos), kv_mask=jnp.asarray(kv_mask),
                              k_scale=jks, v_scale=jvs))
    pk, pks = PL._quantize_kv(torch.from_numpy(kv[0]))
    pv, pvs = PL._quantize_kv(torch.from_numpy(kv[1]))
    got = PL._attn(torch.from_numpy(q), pk, pv, q_positions=torch.from_numpy(qpos),
                   kv_mask=torch.from_numpy(kv_mask), k_scale=pks, v_scale=pvs).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_init_cache_int8_shapes_and_dtypes():
    cfg = LLAMA_CONFIGS["test-tiny-gqa"]
    c = init_cache(cfg, 3, max_len=20, kv_bits=8)
    assert set(c) == {"k", "v", "ks", "vs"}
    for key in ("k", "v"):
        assert c[key].dtype == torch.int8 and tuple(c[key].shape) == (2, 3, 2, 20, 16)
    for key in ("ks", "vs"):
        assert c[key].dtype == torch.float32 and tuple(c[key].shape) == (2, 3, 2, 20)
    ref = JL.init_cache(JL.LLAMA_CONFIGS["test-tiny-gqa"], 3, max_len=20, kv_bits=8)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()} == {
        k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in c.items()}
    with pytest.raises(ValueError, match="kv_bits"):
        init_cache(cfg, 1, kv_bits=4)


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-gqa"])
def test_int8_cached_decode_matches_jax(name):
    """Prefill 6 tokens into an int8 cache of 12 slots, then 4 decode steps
    with per-example (vector) write offsets: logits within 1e-4 of JAX's,
    and the scales JAX's."""
    cfg = JL.LLAMA_CONFIGS[name]
    tree = jax.tree.map(np.asarray, JL.init_llama_params(jax.random.PRNGKey(0), cfg))
    model = Llama(LLAMA_CONFIGS[name])
    model.load_state_dict(llama_from_jax(tree))
    tokens = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 10))
    jc = JL.init_cache(cfg, 2, max_len=12, kv_bits=8)
    pc = init_cache(model.cfg, 2, max_len=12, kv_bits=8)
    jl, jc = JL.llama_forward(tree, jnp.asarray(tokens[:, :6]), cfg=cfg, compute_dtype=jnp.float32,
                              cache=jc, cache_pos=0)
    pl, pc = llama_forward(model, torch.from_numpy(tokens[:, :6]), compute_dtype=torch.float32,
                           cache=pc, cache_pos=0)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for pos in range(6, 10):
        tok = tokens[:, pos:pos + 1]
        vec = np.asarray([pos, pos])
        jl, jc = JL.llama_forward(tree, jnp.asarray(tok), cfg=cfg, compute_dtype=jnp.float32, cache=jc,
                                  cache_pos=jnp.asarray(vec), positions=jnp.asarray(vec)[:, None])
        pl, pc = llama_forward(model, torch.from_numpy(tok), compute_dtype=torch.float32, cache=pc,
                               cache_pos=torch.from_numpy(vec), positions=torch.from_numpy(vec)[:, None])
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for key in ("ks", "vs"):
        np.testing.assert_allclose(pc[key].numpy(), np.asarray(jc[key]), rtol=1e-5, atol=1e-9)
    assert pc["k"].dtype == torch.int8 and np.abs(pc["k"].numpy().astype(int)
                                                  - np.asarray(jc["k"]).astype(int)).max() <= 1


@pytest.fixture(scope="module")
def pair():
    """The tiny LLaVA's float32 weights in both packages, both adapters with
    quantize_kv set."""
    tree = jax.tree.map(np.asarray, JV.init_llava_params(jax.random.PRNGKey(0), CFG))
    jm = JE.LlavaEvalModel(jax.tree.map(jnp.asarray, tree), CFG, JE.WordTokenizer(CFG.llama.vocab_size),
                           compute_dtype=jnp.float32, max_post_len=16)
    jm.quantize_kv = True
    pm = LlavaEvalModel(PV.Llava.from_state(PCFG, params_from_jax(tree)),
                        WordTokenizer(PCFG.llama.vocab_size), compute_dtype=torch.float32,
                        max_post_len=16)
    pm.quantize_kv = True
    x = np.random.RandomState(4).rand(2, 3, 32, 32).astype(np.float32)
    return jm, pm, x


@pytest.mark.parametrize("num_beams", [1, 3])
def test_get_outputs_int8_kv_matches_jax(pair, num_beams):
    jm, pm, x = pair
    prompts = [pm.get_caption_prompt(), pm.get_vqa_prompt("what is on the table")]
    ref = jm.get_outputs(jnp.asarray(x), prompts, max_new_tokens=6, num_beams=num_beams)
    got = pm.get_outputs(torch.from_numpy(x), prompts, max_new_tokens=6, num_beams=num_beams)
    assert got == ref and all(t.startswith("tok") for t in got)


def test_int8_stream_matches_jax(pair):
    jm, pm, x = pair
    prompt = pm.get_caption_prompt()
    ref = [int(t[0]) for t in jm.stream_tokens(jnp.asarray(x[:1]), [prompt], 6)]
    got = [int(t[0]) for t in pm.stream_tokens(torch.from_numpy(x[:1]), [prompt], 6)]
    assert got == ref


def test_int8_cache_refused_for_mpt():
    cfg = PV.LLAVA_CONFIGS["test-tiny-mpt"]
    model = PV.Llava(cfg)
    x = torch.zeros(1, 3, cfg.vision.image_size, cfg.vision.image_size)
    with pytest.raises(ValueError, match="llama-family only"):
        PV.make_llava_decode_fns(model, x, torch.ones(1, 2, dtype=torch.long), max_total_len=4,
                                 compute_dtype=torch.float32, kv_bits=8)
    with pytest.raises(ValueError, match="llama-family only"):
        JV.make_llava_decode_fns(JV.init_llava_params(jax.random.PRNGKey(0), JV.LLAVA_CONFIGS["test-tiny-mpt"]),
                                 JV.LLAVA_CONFIGS["test-tiny-mpt"], jnp.asarray(x.numpy()),
                                 jnp.ones((1, 2), jnp.int32), max_total_len=4,
                                 compute_dtype=jnp.float32, kv_bits=8)
