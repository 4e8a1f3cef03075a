"""`scripts/bench_spec_torch.py` on the CPU at test-tiny size, float32: the
repaired reject-all drafter has an accept rate of exactly 0 on a tiny model
whose argmax is always `vocab - 1` (where the JAX bench's fixed `vocab - 1`
drafter is accepted every time), the accept-all oracle has an accept rate
of 1, and prompt lookup's tokens equal the plain stream's and JAX's
`spec_stream_tokens` on the same weights."""

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

import bench_spec_torch as S  # noqa: E402

from robustvlm_tpu.models.llava.model import LLAVA_CONFIGS as JAX_CONFIGS  # noqa: E402
from robustvlm_tpu.models.llava.model import init_llava_params  # noqa: E402
from robustvlm_tpu.serve.speculative import spec_stream_tokens as jax_spec  # noqa: E402
from robustvlm_tpu.vlm_eval import eval_models as jax_eval_models  # noqa: E402
from robustvlm_tpu_torch.models.llava import LLAVA_CONFIGS, Llava, params_from_jax  # noqa: E402
from robustvlm_tpu_torch.serve.speculative import spec_stream_tokens  # noqa: E402
from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel, WordTokenizer  # noqa: E402

torch.set_num_threads(2)
K, MAX_NEW = 3, 12


def _tree(argmax_last: bool):
    tree = jax.tree.map(np.asarray, init_llava_params(jax.random.PRNGKey(0), JAX_CONFIGS["test-tiny"]))
    if argmax_last:
        # every block adds nothing (wo and w_down zero), every token's
        # embedding has coordinate 0 at 1, and the LM head reads only that
        # coordinate into the last id: the argmax is vocab - 1 at every step
        lm = tree["llama"]
        lm["blocks"]["attn"]["wo"] = np.zeros_like(lm["blocks"]["attn"]["wo"])
        lm["blocks"]["mlp"]["w_down"] = np.zeros_like(lm["blocks"]["mlp"]["w_down"])
        lm["tok_embedding"] = lm["tok_embedding"].copy()
        lm["tok_embedding"][:, 0] = 1.0
        head = np.zeros_like(lm["lm_head"])
        head[0, -1] = 1.0
        lm["lm_head"] = head
    return tree


def _models(tree):
    cfg = LLAVA_CONFIGS["test-tiny"]
    port = LlavaEvalModel(Llava.from_state(cfg, params_from_jax(tree)), WordTokenizer(cfg.llama.vocab_size),
                          compute_dtype=torch.float32, max_post_len=16)
    jcfg = JAX_CONFIGS["test-tiny"]
    ref = jax_eval_models.LlavaEvalModel(jax.tree.map(jnp.asarray, tree), jcfg,
                                         jax_eval_models.WordTokenizer(jcfg.llama.vocab_size),
                                         compute_dtype=jnp.float32, max_post_len=16)
    return port, ref


def _image(size, seed=0):
    return np.random.RandomState(seed).rand(1, 3, size, size).astype(np.float32)


@pytest.fixture(scope="module")
def argmax_last():
    return _models(_tree(True))


@pytest.fixture(scope="module")
def random_tiny():
    return _models(_tree(False))


def test_reject_all_is_rejected_where_the_fixed_id_is_accepted(argmax_last, capsys):
    port, ref = argmax_last
    x = _image(port.cfg.vision.image_size)
    prompt = port.get_caption_prompt()
    vocab = port.tok.vocab_size
    plain = [int(t[0]) for t in port.stream_tokens(torch.from_numpy(x), [prompt], MAX_NEW)]
    assert plain == [vocab - 1] * MAX_NEW

    def fixed(ids, kk):  # the JAX bench's reject-all drafter (scripts/bench_spec.py)
        return [vocab - 1] * kk

    jstats, pstats = {}, {}
    list(jax_spec(ref, jnp.asarray(x), [prompt], MAX_NEW, k=K, drafter=fixed, stats=jstats))
    list(spec_stream_tokens(port, torch.from_numpy(x), [prompt], MAX_NEW, k=K, drafter=fixed, stats=pstats))
    assert jstats["accept_rate"] == pstats["accept_rate"] == 1.0

    reject_all, _ = S.drafters(port, prompt, plain)
    stats = {}
    got = [int(t[0]) for t in spec_stream_tokens(port, torch.from_numpy(x), [prompt], MAX_NEW, k=K,
                                                 drafter=reject_all, stats=stats)]
    assert got == plain
    assert stats["accept_rate"] == 0.0 and stats["verify_steps"] == MAX_NEW - 1


def test_run_configs_floor_ceiling_and_pld_equal_plain_and_jax(random_tiny, capsys):
    port, ref = random_tiny
    x = _image(port.cfg.vision.image_size, seed=1)
    prompt = port.get_caption_prompt()
    summary = S.run_configs(port, torch.from_numpy(x), prompt, MAX_NEW, K)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [ln.get("config") for ln in lines[:-1]] == ["plain_stream", "spec_reject_all", "spec_accept_all",
                                                       "spec_pld"]
    assert lines[-1]["metric"] == "llava7b_spec_decode_tokens_per_sec"
    rows = {r["config"]: r for r in summary["rows"]}
    plain = rows["plain_stream"]["ids"]
    assert len(plain) == MAX_NEW  # no EOS: the oracle covers every verify step
    assert summary["accept_rate"]["spec_reject_all"] == 0.0
    assert summary["accept_rate"]["spec_accept_all"] == 1.0
    for name in ("spec_reject_all", "spec_accept_all", "spec_pld"):
        assert rows[name]["ids"] == plain, name
    want = [int(t[0]) for t in jax_spec(ref, jnp.asarray(x), [prompt], MAX_NEW, k=K)]
    assert rows["spec_pld"]["ids"] == want
