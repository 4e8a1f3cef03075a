"""`remat` for the port's VLM language models and adapters: LLaMA, MPT,
LLaVA, OpenFlamingo and BLIP-2. Each block is recomputed in the backward
(`torch.utils.checkpoint`), so on the CPU the output and its gradient with
`remat=True` are bit-equal to `remat=False`; and they agree with the JAX
function at `remat=True` (`jax.checkpoint`) on the same `test-tiny` weights
in float32: the output (per-sample losses, or weighted logits) and the
gradient each within 1e-5 of its largest element. LLaVA, OpenFlamingo and BLIP-2 go through their eval
adapters (`remat=` of `LlavaEvalModel`, `FlamingoEvalModel`,
`Blip2EvalModel`), the pixels' gradient; LLaMA and MPT through their
forwards, the input embeddings' gradient of a weighted logit sum."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

MEDIA = 511  # WordTokenizer(512).media_token_id
TOL = 1e-5


def _lm_case(family):
    """(jax weighted logits of the embeddings at remat=True, port's (e, remat), e)."""
    if family == "llama":
        from robustvlm_tpu.models.llama import model as J
        from robustvlm_tpu_torch.models.llama import model as P
        from robustvlm_tpu_torch.models.llama.convert import params_from_jax

        cfg, init, fwd, pfwd = J.LLAMA_CONFIGS["test-tiny"], J.init_llama_params, J.llama_forward, P.llama_forward
        model = P.Llama(P.LLAMA_CONFIGS["test-tiny"])
        width, jkw = cfg.dim, {"flash": False}
    else:
        from robustvlm_tpu.models.mpt import model as J
        from robustvlm_tpu_torch.models.mpt import model as P
        from robustvlm_tpu_torch.models.mpt.convert import params_from_jax

        cfg, init, fwd, pfwd = J.MPT_CONFIGS["test-tiny"], J.init_mpt_params, J.mpt_forward, P.mpt_forward
        model = P.MPT(P.MPT_CONFIGS["test-tiny"])
        width, jkw = cfg.d_model, {}
    tree = init(jax.random.PRNGKey(0), cfg)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)), strict=True)
    rng = np.random.RandomState(1)
    emb = rng.randn(2, 9, width).astype(np.float32) * 0.5
    w = rng.randn(2, 9, cfg.vocab_size).astype(np.float32)

    def jloss(e):  # the weighted logits: their sum is the loss differentiated
        return fwd(tree, cfg=cfg, inputs_embeds=e, compute_dtype=jnp.float32, remat=True, **jkw) * w

    def ploss(e, remat):
        return pfwd(model, inputs_embeds=e, compute_dtype=torch.float32, remat=remat) * torch.from_numpy(w)

    return jloss, ploss, emb


def _adapter_case(family):
    """(jax per-sample loss of the pixels at remat=True, port loss(x, remat), x)."""
    from robustvlm_tpu.vlm_eval import eval_models as JE
    from robustvlm_tpu_torch.vlm_eval import eval_models as PE

    rng = np.random.RandomState(2)
    if family == "llava":
        from robustvlm_tpu.models.llava import model as J
        from robustvlm_tpu_torch.models.llava import model as P
        from robustvlm_tpu_torch.models.llava.convert import params_from_jax

        cfg = J.LLAVA_CONFIGS["test-tiny"]
        tree = J.init_llava_params(jax.random.PRNGKey(0), cfg)
        model = P.Llava.from_state(P.LLAVA_CONFIGS["test-tiny"], params_from_jax(jax.tree.map(np.asarray, tree)))
        jad = JE.LlavaEvalModel(tree, cfg, JE.WordTokenizer(), compute_dtype=jnp.float32, remat=True)
        pads = {r: PE.LlavaEvalModel(model, PE.WordTokenizer(), compute_dtype=torch.float32, remat=r)
                for r in (False, True)}
        prompts = [jad.get_caption_prompt("two dogs on the grass"), jad.get_vqa_prompt("what is it?", "a cat")]
        x = rng.rand(2, 3, 32, 32).astype(np.float32)
    elif family == "open_flamingo":
        from robustvlm_tpu.models.flamingo import model as J
        from robustvlm_tpu_torch.models.flamingo import convert as PC
        from robustvlm_tpu_torch.models.flamingo import model as P

        cfg = dataclasses.replace(J.FLAMINGO_CONFIGS["test-tiny"], media_token_id=MEDIA)
        tree = jax.jit(J.init_flamingo_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
        for gate in ("attn_gate", "ff_gate"):  # open: a zero gate ignores the image
            tree["xattn"][gate] = jnp.full_like(tree["xattn"][gate], 0.5)
        pcfg = dataclasses.replace(P.FLAMINGO_CONFIGS["test-tiny"], media_token_id=MEDIA)
        model = P.Flamingo.from_state(pcfg, PC.params_from_jax(jax.tree.map(np.asarray, tree)))
        jad = JE.FlamingoEvalModel(tree, cfg, JE.WordTokenizer(), compute_dtype=jnp.float32, remat=True)
        pads = {r: PE.FlamingoEvalModel(model, PE.WordTokenizer(), compute_dtype=torch.float32, remat=r)
                for r in (False, True)}
        prompts = [jad.get_caption_prompt("two dogs"), jad.get_vqa_prompt("what is it?", "a cat")]
        x = rng.rand(2, 1, 1, 3, 32, 32).astype(np.float32)
    else:
        from robustvlm_tpu.models.blip2 import model as J
        from robustvlm_tpu_torch.models.blip2 import model as P
        from robustvlm_tpu_torch.models.blip2.convert import params_from_jax

        cfg = J.BLIP2_CONFIGS["test-tiny"]
        tree = J.init_blip2_params(jax.random.PRNGKey(0), cfg)
        model = P.Blip2.from_state(P.BLIP2_CONFIGS["test-tiny"], params_from_jax(jax.tree.map(np.asarray, tree)))
        vocab = cfg.opt.vocab_size
        jad = JE.Blip2EvalModel(tree, cfg, JE.WordTokenizer(vocab), compute_dtype=jnp.float32, remat=True,
                                max_len=16)
        pads = {r: PE.Blip2EvalModel(model, PE.WordTokenizer(vocab), compute_dtype=torch.float32, remat=r,
                                     max_len=16) for r in (False, True)}
        prompts = [jad.get_caption_prompt("two dogs"), jad.get_vqa_prompt("what is it?", "a cat")]
        x = rng.rand(2, 3, 40, 40).astype(np.float32)
    jad.set_inputs(prompts)
    for a in pads.values():
        a.set_inputs(prompts)
    bound = jad.bound_args

    def jloss(xx):
        return jad.pure(*bound, xx)

    return jloss, lambda xx, remat: pads[remat](xx), x


@functools.lru_cache(maxsize=None)
def _case(family):
    return (_lm_case if family in ("llama", "mpt") else _adapter_case)(family)


@pytest.mark.parametrize("family", ["llama", "mpt", "llava", "open_flamingo", "blip2"])
def test_remat_bit_equal_and_matches_jax(family):
    jloss, ploss, x = _case(family)
    ref, ref_g = map(np.asarray, jax.jit(lambda xx: (jloss(xx), jax.grad(lambda u: jnp.sum(jloss(u)))(xx)))(
        jnp.asarray(x)))
    out, grads = {}, {}
    for remat in (False, True):
        tx = torch.from_numpy(x).requires_grad_(True)
        out[remat] = ploss(tx, remat)
        (grads[remat],) = torch.autograd.grad(out[remat].sum(), tx)
    assert torch.equal(out[True], out[False]) and torch.equal(grads[True], grads[False])
    assert np.abs(out[True].detach().numpy() - ref).max() <= TOL * np.abs(ref).max()
    assert np.abs(ref_g).max() > 0
    assert np.abs(grads[True].numpy() - ref_g).max() <= TOL * np.abs(ref_g).max()


def test_remat_recomputes_the_blocks():
    """remat=True runs each block's forward again in the backward: the
    vision blocks and OPT blocks of BLIP-2 are called twice, the Q-Former's
    layers (not rematerialised, as in JAX) once."""
    from robustvlm_tpu_torch.models.blip2 import model as P
    from robustvlm_tpu_torch.models.opt import model as O

    _, ploss, x = _case("blip2")
    calls = {"vision": 0, "opt": 0}
    real_v, real_opt = P.VisionBlock.forward, O.Block.forward

    def v(self, h):
        calls["vision"] += 1
        return real_v(self, h)

    def o(self, *a, **k):
        calls["opt"] += 1
        return real_opt(self, *a, **k)

    P.VisionBlock.forward, O.Block.forward = v, o
    try:
        for remat in (False, True):
            calls.update(vision=0, opt=0)
            tx = torch.from_numpy(x).requires_grad_(True)
            torch.autograd.grad(ploss(tx, remat).sum(), tx)
            mult = 2 if remat else 1
            assert calls == {"vision": 2 * mult, "opt": 2 * mult}, (remat, calls)
    finally:
        P.VisionBlock.forward, O.Block.forward = real_v, real_opt
