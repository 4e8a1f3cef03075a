"""Serving on a sharded and on a split model (robustvlm_tpu_torch.parallel
+ serve) in gloo worlds on the CPU, float32: tiny LLaVA sharded over
(1, 2, 1) (FSDP2, gathered on use) and split over (1, 1, 2) (Megatron
heads; `_torch_parallel_workers.tp_serve_world`). On every rank the plain
stream, the speculative stream (k = 3) and the continuous engine (2
lanes) give exactly the tokens of the single-process plain stream and of
JAX's `spec_stream_tokens` on the same weights.

The speculative stream builds its (prefill, verify) pair through
`sharded_call`, as the plain stream does: before that, a sharded model's
root parameters (the embeddings, the LM head, the tower's stem) reached it
as DTensor shards, and the first product raised `aten.mm.default got mixed
torch.Tensor and DTensor`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.models.llava import model as JV
from robustvlm_tpu.serve import speculative as JS
from robustvlm_tpu.vlm_eval import eval_models as JE
from robustvlm_tpu_torch.models.llava import model as PV
from robustvlm_tpu_torch.models.llava.convert import params_from_jax
from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel, WordTokenizer

from _torch_parallel_workers import run_world

torch.set_num_threads(1)
MAX_NEW, K = 8, 3
MESHES = {"sharded121": (1, 2, 1), "split112": (1, 1, 2)}


def _ids(gen, tok):
    out = []
    for t in gen:
        if int(t[0]) in (tok.eos_token_id, tok.pad_token_id):
            break
        out.append(int(t[0]))
    return out


@pytest.fixture(scope="module")
def reference():
    """The single-process port stream and JAX's speculative stream."""
    cfg = JV.LLAVA_CONFIGS["test-tiny"]
    tree = jax.tree.map(np.asarray, JV.init_llava_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(1)
    imgs = [rng.rand(3, 32, 32).astype(np.float32) for _ in range(2)]
    pcfg = PV.LLAVA_CONFIGS["test-tiny"]
    m = LlavaEvalModel(PV.Llava.from_state(pcfg, params_from_jax(tree)), WordTokenizer(pcfg.llama.vocab_size),
                       compute_dtype=torch.float32, max_post_len=16)
    prompt = m.get_caption_prompt()
    solo = [_ids(m.stream_tokens(torch.from_numpy(img)[None], [prompt], MAX_NEW), m.tok) for img in imgs]
    jm = JE.LlavaEvalModel(jax.tree.map(jnp.asarray, tree), cfg, JE.WordTokenizer(cfg.llama.vocab_size),
                           compute_dtype=jnp.float32, max_post_len=16)
    jspec = [_ids(JS.spec_stream_tokens(jm, jnp.asarray(img)[None], [prompt], MAX_NEW, k=K), jm.tok)
             for img in imgs]
    return tree, imgs, solo, jspec


@pytest.fixture(scope="module", params=sorted(MESHES))
def world(request, reference, tmp_path_factory):
    tree, imgs, _, _ = reference
    shape = MESHES[request.param]
    return shape, run_world(tmp_path_factory.mktemp(request.param), int(np.prod(shape)), "tp_serve_world",
                            timeout=120, mesh_shape=shape, tree=tree, imgs=imgs, max_new=MAX_NEW, k=K)


def test_spec_stream_on_sharded_and_split_model_is_exact(world, reference):
    _, _, solo, jspec = reference
    assert any(solo) and solo == jspec
    for r in world[1]:
        assert r["sharded"]
        assert r["verify_steps"] > 0
        assert r["spec"] == solo


def test_stream_and_engine_on_sharded_and_split_model_are_exact(world, reference):
    shape, ranks = world
    _, _, solo, _ = reference
    for r in ranks:
        assert all(r["split"]) == (shape[2] > 1) and any(r["split"]) == (shape[2] > 1)
        assert r["solo"] == solo
        assert r["engine"] == solo
