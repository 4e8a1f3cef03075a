"""The port's ViT attention (robustvlm_tpu_torch.ops.kernels.vit_attention)
against the JAX package's Pallas kernel in interpret mode.

On the CPU the wrapper runs the plain versions through the same
autograd.Function the CUDA kernels use. Tolerances are those of
tests/test_vit_attention.py: fp32 atol=2e-6, rtol=2e-5; bf16 2e-2. The CUDA
kernels run only on a card: those tests skip here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.ops.pallas.vit_attention import vit_attention as jax_vit_attention
from robustvlm_tpu_torch.ops.kernels import vit_attention as A

torch.set_num_threads(1)

SHAPES = [(2, 4, 57, 64), (1, 2, 64, 32), (2, 2, 50, 64), (1, 4, 130, 64)]


def _qkv(rng, b, h, n, d):
    return [(rng.randn(b, h, n, d) * 0.5).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,h,n,d", SHAPES)
def test_forward_matches_jax(b, h, n, d):
    q, k, v = _qkv(np.random.RandomState(0), b, h, n, d)
    ref = np.asarray(jax_vit_attention(*map(jnp.asarray, (q, k, v)), interpret=True))
    out = A.vit_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=2e-5)


@pytest.mark.parametrize("b,h,n,d", SHAPES + [(2, 3, 57, 64)])
def test_gradients_match_jax(b, h, n, d):
    rng = np.random.RandomState(1)
    q, k, v = _qkv(rng, b, h, n, d)
    w = rng.randn(b, h, n, d).astype(np.float32)

    def f(q, k, v):
        return jnp.sum(jnp.sin(jax_vit_attention(q, k, v, interpret=True)) * w)

    ref = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    (torch.sin(A.vit_attention(tq, tk, tv)) * torch.from_numpy(w)).sum().backward()
    for got, r in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=2e-6, rtol=2e-5)


def test_residual_lse_is_finite_and_consistent():
    q, k, v = (torch.from_numpy(t).reshape(8, 57, 64) for t in _qkv(np.random.RandomState(2), 2, 4, 57, 64))
    o, lse = A.attention_fwd_plain(q, k, v)
    s = (q * (1 / 8.0)) @ k.transpose(-1, -2)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, dim=-1).numpy(), atol=2e-6, rtol=2e-6)
    assert lse.dtype == torch.float32 and lse.shape == (8, 57)


def test_extreme_scores_stay_finite():
    """Rows whose scaled scores all sit at -800 (below exp's underflow
    point) stay finite, forward and backward."""
    b, h, n, d = 1, 1, 57, 64
    q = np.full((b, h, n, d), 10.0, np.float32)
    k = np.full((b, h, n, d), -10.0, np.float32)
    v = np.random.RandomState(0).randn(b, h, n, d).astype(np.float32)
    ref = np.asarray(jax_vit_attention(*map(jnp.asarray, (q, k, v)), interpret=True))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    out = A.vit_attention(tq, tk, tv)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=2e-5, rtol=2e-4)
    (out ** 2).sum().backward()
    for g in (tq.grad, tk.grad, tv.grad):
        assert torch.isfinite(g).all()


def test_bf16_matches_jax():
    q, k, v = _qkv(np.random.RandomState(4), 1, 2, 57, 64)
    ref = jax_vit_attention(*[jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)], interpret=True)
    out = A.vit_attention(*[torch.from_numpy(t).bfloat16() for t in (q, k, v)])
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def test_cpu_counts_no_launch():
    q, k, v = (torch.from_numpy(t).requires_grad_(True) for t in _qkv(np.random.RandomState(5), 1, 2, 16, 32))
    before = dict(A.LAUNCHES)
    A.vit_attention(q, k, v).sum().backward()
    assert A.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0), (torch.bfloat16, 2e-2, 2e-2)])
@pytest.mark.parametrize("n", [50, 257, 577])
def test_cuda_kernels_match_plain(dtype, atol, rtol, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(n)
    q, k, v, do = (torch.randn(16, n, 64, generator=g, device="cuda").to(dtype) for _ in range(4))
    before = dict(A.LAUNCHES)
    o, lse = A.attention_fwd(q, k, v)
    grads = A.attention_bwd(q, k, v, o, lse, do)
    assert A.LAUNCHES["vit_attention_fwd"] == before["vit_attention_fwd"] + 1
    assert A.LAUNCHES["vit_attention_bwd"] == before["vit_attention_bwd"] + 1
    o_ref, lse_ref = A.attention_fwd_plain(q, k, v)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
    for got, ref in zip(grads, A.attention_bwd_plain(q, k, v, o, lse, do)):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
    # deterministic backward: no atomics, so two runs give the same bits
    again = A.attention_bwd(q, k, v, o, lse, do)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)
