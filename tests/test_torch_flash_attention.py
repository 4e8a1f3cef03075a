"""The port's flash attention (robustvlm_tpu_torch.ops.kernels.flash_attention)
against the JAX package's: the Pallas kernels in interpret mode (block 32,
so sequences of 40 and 50 exercise the key padding) and its XLA reference
`attention_reference` (the only JAX path for causal with Nq < Nk).

On the CPU the wrapper runs the plain versions through the same
autograd.Function the CUDA kernels use. Limits: fp32 1e-5 (atol and rtol);
bf16 2e-2 of the reference tensor's largest magnitude (about two bf16 ulps
of it: both sides round P and the products' operands to bf16, in other
orders). The CUDA kernels run only on a card: those tests skip here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.ops.pallas.flash_attention import attention_reference
from robustvlm_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from robustvlm_tpu_torch.ops.kernels import flash_attention as F

torch.set_num_threads(1)

SLOPES = np.asarray([0.5, 0.125], np.float32)  # 2 heads

# (label, b, h, nq, nk, d, causal, alibi)
CASES = [
    ("noncausal_keypad", 1, 2, 50, 50, 64, False, False),
    ("causal", 2, 2, 40, 40, 64, True, False),
    ("causal_alibi", 1, 2, 40, 40, 64, True, True),
    ("noncausal_alibi_d128", 1, 2, 33, 33, 128, False, True),
]


def _inputs(seed, b, h, nq, nk, d):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, h, nq, d) * 0.5).astype(np.float32)
    k = (rng.randn(b, h, nk, d) * 0.5).astype(np.float32)
    v = (rng.randn(b, h, nk, d) * 0.5).astype(np.float32)
    g = rng.randn(b, h, nq, d).astype(np.float32)
    return q, k, v, g


def _jax_vjp(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(t, np.float32) for t in (out, *vjp(jnp.asarray(g).astype(out.dtype)))]


def _torch_fwd_bwd(q, k, v, g, *, causal, alibi, dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(t).to(dtype).requires_grad_(True) for t in (q, k, v))
    slopes = torch.from_numpy(SLOPES) if alibi else None
    out = F.flash_attention(tq, tk, tv, causal=causal, alibi_slopes=slopes)
    out.backward(torch.from_numpy(g).to(dtype))
    return [t.detach().float().numpy() for t in (out, tq.grad, tk.grad, tv.grad)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_and_grads_match_pallas_interpret(case):
    _, b, h, nq, nk, d, causal, alibi = case
    q, k, v, g = _inputs(0, b, h, nq, nk, d)
    slopes = jnp.asarray(SLOPES) if alibi else None

    def fn(q, k, v):
        return jax_flash(q, k, v, causal=causal, alibi_slopes=slopes,
                         block_q=32, block_k=32, interpret=True)

    ref = _jax_vjp(fn, q, k, v, g)
    got = _torch_fwd_bwd(q, k, v, g, causal=causal, alibi=alibi)
    for name, a, r in zip(("o", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, r, atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("causal,alibi", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("nq,nk", [(40, 40), (17, 45)])
def test_matches_attention_reference(nq, nk, causal, alibi):
    """Including causal with Nq < Nk, where the kernels take the diagonal
    offset Nk - Nq and the JAX function takes its reference."""
    q, k, v, g = _inputs(1, 1, 2, nq, nk, 64)
    slopes = jnp.asarray(SLOPES) if alibi else None
    ref = _jax_vjp(lambda q, k, v: attention_reference(q, k, v, causal=causal, alibi_slopes=slopes),
                   q, k, v, g)
    got = _torch_fwd_bwd(q, k, v, g, causal=causal, alibi=alibi)
    for name, a, r in zip(("o", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, r, atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_pallas_interpret(causal):
    q, k, v, g = _inputs(2, 1, 2, 40, 40, 64)
    bf = jnp.bfloat16

    def fn(q, k, v):
        return jax_flash(q.astype(bf), k.astype(bf), v.astype(bf), causal=causal,
                         block_q=32, block_k=32, interpret=True)

    ref = _jax_vjp(fn, q, k, v, g)
    got = _torch_fwd_bwd(q, k, v, g, causal=causal, alibi=False, dtype=torch.bfloat16)
    for name, a, r in zip(("o", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, r, atol=2e-2 * float(np.abs(r).max()), rtol=0, err_msg=name)


def test_lse_and_fully_masked_rows():
    """lse is logsumexp of the visible scaled scores; causal with Nq > Nk
    leaves rows with no visible key: O = 0, lse = -1e30, zero gradients."""
    q, k, v, _ = (torch.from_numpy(t).reshape(2, *t.shape[2:]) for t in _inputs(3, 1, 2, 24, 24, 64))
    o, lse = F.flash_fwd_plain(q, k, v, causal=True)
    s = (q * 0.125) @ k.transpose(-1, -2)
    s = s.masked_fill(torch.ones(24, 24).triu(1).bool(), float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), atol=2e-6, rtol=2e-6)
    qs, ks, vs = (t.requires_grad_(True) for t in (q[:, :24].clone(), k[:, :10].clone(), v[:, :10].clone()))
    o, lse = F.flash_fwd_plain(qs, ks, vs, causal=True)
    blind = slice(0, 24 - 10)  # row i sees key j <= i - 14
    assert torch.all(o[:, blind] == 0) and torch.all(lse[:, blind] == -1e30)
    assert torch.isfinite(o).all()
    out = F.flash_attention(qs[None], ks[None], vs[None], causal=True)
    out.sum().backward()
    assert torch.all(qs.grad[:, blind] == 0)
    for t in (qs, ks, vs):
        assert torch.isfinite(t.grad).all()


def test_cpu_counts_no_launch():
    q, k, v, _ = (torch.from_numpy(t).requires_grad_(True) for t in _inputs(5, 1, 2, 16, 16, 64))
    before = dict(F.LAUNCHES)
    F.flash_attention(q, k, v, causal=True).sum().backward()
    assert F.LAUNCHES == before


# ------------------------------------------------------------------ the card
def _card_inputs(bh, nq, nk, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(bh, nq, d, generator=g, device="cuda") * 0.5
    k, v = (torch.randn(bh, nk, d, generator=g, device="cuda") * 0.5 for _ in range(2))
    do = torch.randn(bh, nq, d, generator=g, device="cuda")
    return [t.to(dtype) for t in (q, k, v, do)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("bh,nq,nk,d,causal,alibi", [
    (32, 664, 664, 128, True, False),   # LLaVA-1.5-7B LM layer, batch 1
    (96, 77, 77, 64, True, False),      # CLIP text tower, 8 prompts x 12 heads
    (8, 200, 200, 128, True, True),     # ALiBi + causal (MPT)
    (8, 50, 50, 64, False, False),      # key padding
    (8, 70, 300, 128, True, False),     # causal with Nq < Nk
])
def test_cuda_kernels_match_plain(dtype, bh, nq, nk, d, causal, alibi):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    q, k, v, do = _card_inputs(bh, nq, nk, d, dtype, seed=nq + nk)
    slopes = (torch.rand(bh, device="cuda") * 0.2) if alibi else None
    kw = dict(causal=causal, slopes=slopes)
    before = dict(F.LAUNCHES)
    o, lse = F.flash_fwd(q, k, v, **kw)
    grads = F.flash_bwd(q, k, v, o, lse, do, **kw)
    assert F.LAUNCHES["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    assert F.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    o_ref, lse_ref = F.flash_fwd_plain(q, k, v, **kw)
    ref = (o_ref, *F.flash_bwd_plain(q, k, v, o_ref, lse_ref, do, **kw))
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-6)
    for got, r in zip((o, *grads), ref):
        lim = 1e-5 if dtype == torch.float32 else 2e-2 * float(r.float().abs().max())
        torch.testing.assert_close(got.float(), r.float(), atol=lim, rtol=0)
    again = F.flash_bwd(q, k, v, o, lse, do, **kw)  # no atomics: the same bits
    for a, b in zip(grads, again):
        assert torch.equal(a, b)
