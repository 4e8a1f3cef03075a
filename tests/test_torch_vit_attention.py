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
from robustvlm_tpu_torch.ops.kernels import flash_attention as F
from robustvlm_tpu_torch.ops.kernels import vit_attention as A

torch.set_num_threads(1)

SHAPES = [(2, 4, 57, 64), (1, 2, 64, 32), (2, 2, 50, 64), (1, 4, 130, 64), (1, 2, 57, 88)]


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


@pytest.mark.parametrize("d", [64, 88])
def test_bf16_matches_jax(d):
    q, k, v = _qkv(np.random.RandomState(4), 1, 2, 57, d)
    ref = jax_vit_attention(*[jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)], interpret=True)
    out = A.vit_attention(*[torch.from_numpy(t).bfloat16() for t in (q, k, v)])
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [50, 57])
@pytest.mark.parametrize("d", [64, 80, 88])
def test_plain_forward_is_the_flash_plain_forward_noncausal(n, d, dtype):
    """On the card the ViT forward is the flash forward kernel launched
    non-causal: in float32 csrc/attn_f32_tile.cuh, in bf16
    csrc/attn_bf16_fwd.cuh. That rests on the two plain versions being one
    function: bit for bit here, in both dtypes, and both within the file's
    tolerance of the JAX kernel in interpret mode (fp32 atol 2e-6, rtol
    2e-5; bf16 2e-2)."""
    q, k, v = _qkv(np.random.RandomState(6), 1, 2, n, d)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = np.asarray(jax_vit_attention(*(jnp.asarray(t).astype(jdt) for t in (q, k, v)),
                                       interpret=True).astype(jnp.float32)).reshape(2, n, d)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(t).reshape(2, n, d).to(tdt) for t in (q, k, v))
    o_vit, lse_vit = A.attention_fwd_plain(tq, tk, tv)
    o_flash, lse_flash = F.flash_fwd_plain(tq, tk, tv, causal=False)
    assert o_vit.dtype == tdt
    assert torch.equal(o_vit, o_flash) and torch.equal(lse_vit, lse_flash)
    tol = dict(atol=2e-6, rtol=2e-5) if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(o_vit.float().numpy(), ref, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [50, 57])
@pytest.mark.parametrize("d", [64, 80, 88])
def test_plain_backward_is_the_flash_plain_backward_noncausal(d, n, dtype):
    """On the card the float32 ViT backward is the flash dQ and dK/dV
    kernels launched non-causal (csrc/attn_f32_tile.cuh). That rests on the
    two plain backwards being one function: bit for bit here, in both
    dtypes, and both within the file's tolerance of the JAX kernel's vjp in
    interpret mode (fp32 atol 2e-6, rtol 2e-5; bf16 2e-2)."""
    rng = np.random.RandomState(7)
    q, k, v = _qkv(rng, 1, 2, n, d)
    g = rng.randn(1, 2, n, d).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    _, vjp = jax.vjp(lambda q, k, v: jax_vit_attention(q, k, v, interpret=True),
                     *(jnp.asarray(t).astype(jdt) for t in (q, k, v)))
    ref = [np.asarray(t.astype(jnp.float32)).reshape(2, n, d) for t in vjp(jnp.asarray(g).astype(jdt))]
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = (torch.from_numpy(t).reshape(2, n, d).to(tdt) for t in (q, k, v, g))
    o, lse = A.attention_fwd_plain(tq, tk, tv)
    vit = A.attention_bwd_plain(tq, tk, tv, o, lse, tg)
    flash = F.flash_bwd_plain(tq, tk, tv, o, lse, tg, causal=False)
    tol = dict(atol=2e-6, rtol=2e-5) if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    for name, a, b, r in zip(("dq", "dk", "dv"), vit, flash, ref):
        assert a.dtype == tdt and torch.equal(a, b), name
        np.testing.assert_allclose(a.float().numpy(), r, err_msg=name, **tol)


def test_cpu_counts_no_launch():
    q, k, v = (torch.from_numpy(t).requires_grad_(True) for t in _qkv(np.random.RandomState(5), 1, 2, 16, 32))
    before = dict(A.LAUNCHES)
    A.vit_attention(q, k, v).sum().backward()
    assert A.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0), (torch.bfloat16, 2e-2, 2e-2)])
@pytest.mark.parametrize("d", [64, 80, 88])
@pytest.mark.parametrize("n", [50, 257, 577])
def test_cuda_kernels_match_plain(dtype, atol, rtol, n, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(n + d)
    q, k, v, do = (torch.randn(16, n, d, generator=g, device="cuda").to(dtype) for _ in range(4))
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("bh,n,d", [(128, 257, 64), (16, 577, 80), (128, 257, 88)])
def test_cuda_backward_bitwise_repeatable(dtype, bh, n, d):
    """The backward at the ViT-L/14 main path's shape (batch 8 x 16 heads)
    and at ViT-H/14-like head dim 80 and the longest sequence, and at
    ViT-g/14's (head dim 88, batch 8): no atomics, so two launches on the
    same inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(bh + n + d)
    q, k, v, do = (torch.randn(bh, n, d, generator=g, device="cuda").to(dtype) for _ in range(4))
    o, lse = A.attention_fwd(q, k, v)
    first = A.attention_bwd(q, k, v, o, lse, do)
    for _ in range(2):
        for a, b in zip(first, A.attention_bwd(q, k, v, o, lse, do)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,n", [(128, 257), (16, 577)])
def test_cuda_bf16_forward_head_dim_80(bh, n):
    """The bf16 forward at head dim 80 (ViT-H/14): the tensor maps' second
    box is zero-filled past column 80 and O = P V runs at wgmma's n = 80.
    Held at chip_smoke.py's limits: O within 2e-2 of its largest value, lse
    within 1e-5 + 1e-6 relative; one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(bh + n)
    q, k, v = ((torch.randn(bh, n, 80, generator=g, device="cuda") * 0.5).bfloat16() for _ in range(3))
    before = A.LAUNCHES["vit_attention_fwd"]
    o, lse = A.attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert A.LAUNCHES["vit_attention_fwd"] == before + 1
    o_ref, lse_ref = A.attention_fwd_plain(q, k, v)
    assert float((o.float() - o_ref.float()).abs().max()) <= 2e-2 * float(o_ref.float().abs().max())
    assert bool(((lse - lse_ref).abs() <= 1e-5 + 1e-6 * lse_ref.abs()).all())


def test_bf16_gradients_head_dim_88_match_jax():
    """ViT-g/14's head dim in bf16, backward: the port's autograd path
    against the JAX kernel's vjp in interpret mode, within 2e-2 (the bf16
    tolerance of this file)."""
    rng = np.random.RandomState(8)
    q, k, v = _qkv(rng, 1, 2, 57, 88)
    g = rng.randn(1, 2, 57, 88).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jax_vit_attention(q, k, v, interpret=True),
                     *(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)))
    ref = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    tq, tk, tv = (torch.from_numpy(t).bfloat16().requires_grad_(True) for t in (q, k, v))
    A.vit_attention(tq, tk, tv).backward(torch.from_numpy(g).bfloat16())
    for name, got, r in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(r.astype(jnp.float32)),
                                   atol=2e-2, rtol=2e-2, err_msg=name)


def test_head_dim_88_is_built():
    """ViT-g/14 (width 1408, 16 heads) runs at head dim 88: the CUDA kernels
    are built for it."""
    assert 88 in A.HEAD_DIMS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("bh,n", [(128, 257), (16, 129), (1024, 257)])  # the last: BLIP-2's EVA at 64 images
def test_cuda_head_dim_88(dtype, bh, n):
    """Head dim 88 (ViT-g/14) forward and backward, at chip_smoke.py's
    limits: float32 within 1e-5 abs; bf16 within 2e-2 of each tensor's
    largest value; lse within 1e-5 + 1e-6 relative. In bf16 the tensor
    maps' second box is zero-filled past column 88, S and dP take 6 k-steps
    (the sixth over zeros of both operands) and O = P V runs at wgmma's
    n = 88."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(bh + n)
    q, k, v, do = ((torch.randn(bh, n, 88, generator=g, device="cuda") * 0.5).to(dtype) for _ in range(4))
    o, lse = A.attention_fwd(q, k, v)
    grads = A.attention_bwd(q, k, v, o, lse, do)
    o_ref, lse_ref = A.attention_fwd_plain(q, k, v)
    refs = (o_ref, *A.attention_bwd_plain(q, k, v, o_ref, lse_ref, do))
    for got, ref in zip((o, *grads), refs):
        err = float((got.float() - ref.float()).abs().max())
        lim = 1e-5 if dtype == torch.float32 else 2e-2 * float(ref.float().abs().max())
        assert err <= lim
    assert bool(((lse - lse_ref).abs() <= 1e-5 + 1e-6 * lse_ref.abs()).all())
