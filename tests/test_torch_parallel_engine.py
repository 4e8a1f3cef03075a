"""The continuous engine on sharded parameters (the counterpart of
tests/test_continuous.py::test_fsdp_sharded_params_engine_parity): tiny
LLaVA sharded over a (1, 2, 2) mesh in a 4-rank gloo world, one engine a
rank (SPMD: rank 0's admissions, cancellations and tokens broadcast), 2
requests of 8 tokens on 2 lanes. Float32 on the CPU: the engine's tokens
and the sharded solo stream's equal the single-process solo stream's
exactly, on every rank."""

import jax
import numpy as np
import pytest
import torch

from robustvlm_tpu.models.llava import model as JV
from robustvlm_tpu_torch.models.llava import model as PV
from robustvlm_tpu_torch.models.llava.convert import params_from_jax
from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel, WordTokenizer

from _torch_parallel_workers import run_world

torch.set_num_threads(1)
MAX_NEW = 8


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tree = jax.tree.map(np.asarray, JV.init_llava_params(jax.random.PRNGKey(0), JV.LLAVA_CONFIGS["test-tiny"]))
    rng = np.random.RandomState(1)
    imgs = [rng.rand(3, 32, 32).astype(np.float32) for _ in range(2)]
    cfg = PV.LLAVA_CONFIGS["test-tiny"]
    m = LlavaEvalModel(PV.Llava.from_state(cfg, params_from_jax(tree)), WordTokenizer(cfg.llama.vocab_size),
                       compute_dtype=torch.float32, max_post_len=16)
    prompt = m.get_caption_prompt()
    solo = []
    for img in imgs:
        ids = []
        for t in m.stream_tokens(torch.from_numpy(img)[None], [prompt], MAX_NEW):
            if int(t[0]) in (m.tok.eos_token_id, m.tok.pad_token_id):
                break
            ids.append(int(t[0]))
        solo.append(ids)
    ranks = run_world(tmp_path_factory.mktemp("engine"), 4, "engine_world", tree=tree, imgs=imgs,
                      max_new=MAX_NEW)
    return solo, ranks


def test_fsdp_sharded_params_engine_parity(setup):
    solo, ranks = setup
    assert any(solo), "the solo streams are empty: nothing is compared"
    for r in ranks:
        assert r["sharded"]
        assert r["engine"] == solo
        assert r["solo"] == solo
