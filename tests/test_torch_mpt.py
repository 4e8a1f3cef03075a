"""The port's MPT (robustvlm_tpu_torch.models.mpt) against the JAX package's
on the same `test-tiny` weights (the JAX init carried across by
`params_from_jax`), float32 on the CPU: ALiBi slopes exactly; logits and
the cached decode within 1e-5 abs; the gradient with respect to the input
embeddings within 1e-4 of its largest element; the layer hook's calls; the
mosaicml HF-layout importer leaf for leaf. The JAX side takes its XLA
attention on the CPU, the port's full-sequence path the plain version of
its flash kernel with the ALiBi slopes, so the comparison holds the port's
ALiBi function."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.models.mpt import import_torch as JI
from robustvlm_tpu.models.mpt import model as JM
from robustvlm_tpu_torch.models.mpt import import_torch as PI
from robustvlm_tpu_torch.models.mpt import model as PM
from robustvlm_tpu_torch.models.mpt.convert import params_from_jax

torch.set_num_threads(1)

CFG = JM.MPT_CONFIGS["test-tiny"]
PCFG = PM.MPT_CONFIGS["test-tiny"]


@pytest.fixture(scope="module")
def pair():
    tree = JM.init_mpt_params(jax.random.PRNGKey(0), CFG)
    model = PM.MPT.from_state(PCFG, params_from_jax(jax.tree.map(np.asarray, tree)))
    return tree, model


@pytest.mark.parametrize("n_heads", [4, 6, 32])
def test_alibi_slopes_equal_jax(n_heads):
    np.testing.assert_array_equal(PM.alibi_slopes(n_heads), JM.alibi_slopes(n_heads))


def _right_padded(seed):
    toks = np.random.RandomState(seed).randint(3, CFG.vocab_size, (2, 11))
    toks[1, 7:] = 0  # right padding: causal attention keeps it out of the real tokens
    return toks


def test_logits_match_jax(pair):
    tree, model = pair
    toks = _right_padded(0)
    ref = np.asarray(JM.mpt_forward(tree, jnp.asarray(toks), cfg=CFG, compute_dtype=jnp.float32))
    got = PM.mpt_forward(model, torch.from_numpy(toks), compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 11, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kv_positions", [False, True], ids=["slots", "kv_positions"])
def test_cached_prefill_and_decode_match_jax(pair, kv_positions):
    """A left-padded prefill (kv_mask, positions) and 3 greedy decode steps;
    with `kv_positions` the ALiBi distances come from the keys' true
    positions instead of their slots."""
    tree, model = pair
    rng = np.random.RandomState(1)
    t, total = 7, 12
    toks = rng.randint(3, CFG.vocab_size, (2, t))
    n_pad = np.array([0, 3])
    toks[1, :3] = 0
    kv_valid = np.arange(t)[None, :] >= n_pad[:, None]
    positions = np.maximum(np.arange(t)[None, :] - n_pad[:, None], 0)
    kvp = np.maximum(np.arange(total)[None, :] - n_pad[:, None], 0) if kv_positions else None
    jcache = JM.init_mpt_cache(CFG, 2, max_len=total, dtype=jnp.float32)
    pcache = PM.init_mpt_cache(PCFG, 2, max_len=total, dtype=torch.float32)

    @jax.jit
    def jstep(tok, cache, pos, kv, qpos):
        return JM.mpt_forward(tree, tok, cfg=CFG, compute_dtype=jnp.float32, cache=cache,
                              cache_pos=pos, kv_mask=kv, positions=qpos,
                              kv_positions=None if kvp is None else jnp.asarray(kvp))

    def pstep(tok, cache, pos, kv, qpos):
        return PM.mpt_forward(model, torch.from_numpy(tok), compute_dtype=torch.float32,
                              cache=cache, cache_pos=pos, kv_mask=torch.from_numpy(kv),
                              positions=torch.from_numpy(qpos),
                              kv_positions=None if kvp is None else torch.from_numpy(kvp))

    jl, jcache = jstep(jnp.asarray(toks), jcache, 0, jnp.asarray(kv_valid), jnp.asarray(positions))
    pl, pcache = pstep(toks, pcache, 0, kv_valid, positions)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    kv = np.concatenate([kv_valid, np.zeros((2, total - t), bool)], axis=1)
    nxt = np.asarray(jl)[:, -1].argmax(-1)
    for i in range(3):
        pos = t + i
        kv[:, pos] = True
        qpos = (pos - n_pad)[:, None]
        jl, jcache = jstep(jnp.asarray(nxt[:, None]), jcache, pos, jnp.asarray(kv), jnp.asarray(qpos))
        pl, pcache = pstep(nxt[:, None], pcache, pos, kv, qpos)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-5, rtol=0, err_msg=f"step {i}")
        nxt = np.asarray(jl)[:, -1].argmax(-1)
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(jcache["k"]), atol=1e-5)


def test_embedding_gradient_matches_jax(pair):
    tree, model = pair
    emb = np.random.RandomState(2).randn(2, 9, CFG.d_model).astype(np.float32) * 0.5
    w = np.random.RandomState(3).randn(2, 9, CFG.vocab_size).astype(np.float32)

    def jloss(e):
        return jnp.sum(JM.mpt_forward(tree, cfg=CFG, inputs_embeds=e, compute_dtype=jnp.float32) * w)

    ref = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(emb)))
    te = torch.from_numpy(emb).requires_grad_(True)
    out = PM.mpt_forward(model, inputs_embeds=te, compute_dtype=torch.float32)
    (g,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), te)
    assert np.abs(g.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_layer_hook_runs_before_each_block(pair):
    """The hook sees layer i's input once per layer; a hook that shifts the
    residual stream gives JAX's logits."""
    tree, model = pair
    toks = _right_padded(4)
    seen = []

    def phook(i, x):
        seen.append((i, x.detach().clone()))
        return x + 0.01 * (i + 1)

    ref = np.asarray(JM.mpt_forward(tree, jnp.asarray(toks), cfg=CFG, compute_dtype=jnp.float32,
                                    layer_hook=lambda i, x: x + 0.01 * (i + 1)))
    got = PM.mpt_forward(model, torch.from_numpy(toks), compute_dtype=torch.float32, layer_hook=phook)
    assert [i for i, _ in seen] == list(range(CFG.n_layers))
    torch.testing.assert_close(seen[0][1], model.tok_embedding[torch.from_numpy(toks)], rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def _within_rounding(a: torch.Tensor, r: torch.Tensor) -> bool:
    """a within float32 rounding of r: 1e-6 of r's largest magnitude, and
    one ulp of each value more where both are bf16."""
    rf = r.float()
    tol = 1e-6 * rf.abs().max()
    if a.dtype == torch.bfloat16:
        tol = tol + torch.exp2(torch.floor(torch.log2(rf.abs().clamp_min(2.0 ** -126))) - 7)
    return a.dtype == r.dtype and bool(((a.float() - rf).abs() <= tol).all())


def _jnp(t: torch.Tensor):
    return jnp.asarray(t.detach().float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _torch_like(r, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(r, np.float32)).to(like.dtype)


# MPT's LayerNorm calls: the bf16 attack at MPT-7B's width, the ensemble's
# float32 stage, and float32 at width 1024 (rows cut to 15)
LN_CALLS = [(torch.bfloat16, 4096), (torch.float32, 4096), (torch.float32, 1024)]


@pytest.mark.parametrize("dtype,w", LN_CALLS, ids=["bf16_4096", "fp32_4096", "fp32_1024"])
def test_layer_norm_cpu_matches_jax(dtype, w):
    """On the CPU, `layer_norm` (`block_ops`' plain LayerNorm with no bias)
    is the JAX model's bias-free LayerNorm to float32 rounding: the forward
    and the gradients in x and g."""
    gen = torch.Generator().manual_seed(w)
    x = (torch.randn(3, 5, w, generator=gen) * 2 + 0.5).to(dtype)
    g = 1 + 0.1 * torch.randn(w, generator=gen)
    dy = torch.randn(3, 5, w, generator=gen).to(dtype)
    xa, ga = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    y = PM.layer_norm(xa, ga, PCFG.norm_eps)
    got = (y.detach(), *torch.autograd.grad(y, (xa, ga), dy))
    yj, vjp = jax.vjp(lambda a, s: JM.layer_norm(a, s, None, PCFG.norm_eps), _jnp(x), _jnp(g))
    for a, r in zip(got, (yj, *vjp(_jnp(dy)))):
        assert _within_rounding(a, _torch_like(r, a))


@pytest.mark.cuda
def test_cuda_tiny_layer_norms_on_the_kernels(monkeypatch):
    """`test-tiny` in bf16 on the card at a head dim the flash kernels build
    (2 heads of 64), forward and the gradient in the input embeddings:
    2 L + 1 LayerNorm launches each way, through `block_ops.layer_norm` with
    no bias, each within the kernels' limits of this module's CPU arithmetic
    on its own inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from test_torch_block_ops import card_call_matches_cpu, record_layer_norms

    from robustvlm_tpu_torch.models.mpt.convert import init_random_state
    from robustvlm_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    cfg = dataclasses.replace(PCFG, d_model=128, n_heads=2)
    state = init_random_state(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for v in state.values():
        if v.dim() == 1:  # gains off 1, so the checks see them
            v.add_(0.2 * torch.randn(v.shape, generator=gen, device=dev))
    model = PM.MPT.from_state(cfg, state)
    calls = record_layer_norms(monkeypatch)
    emb = (0.5 * torch.randn(2, 9, cfg.d_model, generator=gen, device=dev)).requires_grad_(True)
    kernels.reset_launches()
    logits = PM.mpt_forward(model, inputs_embeds=emb, compute_dtype=torch.bfloat16)
    fwd = kernels.launches()
    (grad,) = torch.autograd.grad((logits * torch.randn_like(logits)).sum(), emb)
    both = kernels.launches()
    n = 2 * cfg.n_layers + 1
    assert len(calls) == fwd["layer_norm_fwd"] == n and fwd["layer_norm_bwd"] == 0
    assert both["layer_norm_bwd"] == n
    assert all(b is None and x.dtype == torch.bfloat16 for x, _, b, _ in calls)
    assert torch.isfinite(grad).all() and grad.abs().max() > 0
    monkeypatch.undo()  # stop recording: the CPU route calls `block_ops.layer_norm` too
    for i, call in enumerate(calls):
        assert card_call_matches_cpu(call, lambda x, g, b, eps: PM.layer_norm(x, g, eps), i), i
    assert all(x.shape[-1] == cfg.d_model for x, _, _, _ in calls)


def test_hf_importer_equals_jax_importer():
    """A random mosaicml-layout state dict through both importers: equal leaves."""
    gen = torch.Generator().manual_seed(0)
    d, f = CFG.d_model, CFG.expansion_ratio * CFG.d_model

    def r(*shape):
        return torch.randn(shape, generator=gen)

    sd = {"transformer.wte.weight": r(CFG.vocab_size, d), "transformer.norm_f.weight": r(d)}
    for i in range(CFG.n_layers):
        b = f"transformer.blocks.{i}."
        sd.update({b + "norm_1.weight": r(d), b + "norm_2.weight": r(d),
                   b + "attn.Wqkv.weight": r(3 * d, d), b + "attn.out_proj.weight": r(d, d),
                   b + "ffn.up_proj.weight": r(f, d), b + "ffn.down_proj.weight": r(d, f)})
    ref = params_from_jax(jax.tree.map(np.asarray, JI.import_mpt_state_dict(sd, CFG)))
    got = PI.import_mpt_state_dict(sd, PCFG)
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    PM.MPT.from_state(PCFG, got)  # loads strictly
