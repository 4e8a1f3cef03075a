"""The port's l-inf APGD step (robustvlm_tpu_torch.ops.kernels.attack_step)
against the JAX package's.

The plain version must equal `_linf_step_jnp` bit for bit in float32 (NaN
gradients propagate to NaN at the same positions; NaN payload bits are not
compared). Against the Pallas kernel in interpret mode the tolerance is the
JAX test's own, atol=1e-6 (tests/test_apgd.py). The CUDA kernel runs only
on a card: that test skips here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.ops.pallas.attack_step import _linf_step_jnp
from robustvlm_tpu.ops.pallas.attack_step import fused_linf_apgd_step as jax_fused_step
from robustvlm_tpu_torch.ops.kernels import attack_step as K

torch.set_num_threads(1)


def _inputs(b=8, f=3072, seed=0, edge=True):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, (b, f)).astype(np.float32)
    xa = np.clip(x + rng.uniform(-0.03, 0.03, (b, f)), 0, 1).astype(np.float32)
    xo = np.clip(x + rng.uniform(-0.03, 0.03, (b, f)), 0, 1).astype(np.float32)
    g = rng.randn(b, f).astype(np.float32)
    if edge:
        x[:, :16] = 0.0
        x[:, 16:32] = 1.0
        xa[:, :8] = 0.0
        xa[:, 16:24] = 1.0
        g[:, 32:48] = 0.0
        g[:, 48:64] = -0.0
        g[:, 64:80] = np.nan
    step = rng.uniform(0.001, 0.03, b).astype(np.float32)
    return xa, xo, g, x, step


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    na, nb = np.isnan(a), np.isnan(b)
    if not np.array_equal(na, nb):
        return False
    return np.array_equal(a.view(np.int32)[~na], b.view(np.int32)[~nb])


def _plain(args, eps, a):
    return K.linf_step_plain(*[torch.from_numpy(t) for t in args], eps, a).numpy()


@pytest.mark.parametrize("a", [1.0, 0.75])
@pytest.mark.parametrize("eps", [2 / 255, 8 / 255, 0.03])
def test_plain_bitwise_equals_linf_step_jnp(a, eps):
    args = _inputs()
    ref = np.asarray(_linf_step_jnp(*[jnp.asarray(t) for t in args], eps, a))
    got = _plain(args, eps, a)
    assert np.isnan(got).sum() == 8 * 16  # NaN gradients propagate, as in JAX
    assert _bits_equal(got, ref)


@pytest.mark.parametrize("shape", [(8, 256), (3, 5, 7), (2, 3, 8, 8)])
def test_plain_bitwise_equals_jnp_any_shape(shape):
    b = shape[0]
    f = int(np.prod(shape[1:]))
    args = [t.reshape(shape) if t.ndim == 2 else t for t in _inputs(b, f, seed=3)]
    ref = np.asarray(_linf_step_jnp(*[jnp.asarray(t) for t in args], 2 / 255, 0.75))
    assert _bits_equal(_plain(args, 2 / 255, 0.75), ref)


@pytest.mark.parametrize("a", [1.0, 0.75])
def test_plain_matches_pallas_interpret(a):
    # the JAX test's own tolerance for its interpret-mode kernel
    args = _inputs(8, 1024, seed=1, edge=False)
    ref = np.asarray(jax_fused_step(*[jnp.asarray(t) for t in args], 0.03, a,
                                    use_pallas=True, interpret=True))
    np.testing.assert_allclose(_plain(args, 0.03, a), ref, atol=1e-6, rtol=0)


def test_jnp_sign_semantics():
    g = torch.tensor([2.0, -3.0, 0.0, -0.0, float("nan")])
    s = K.jnp_sign(g)
    ref = np.asarray(jnp.sign(jnp.asarray(g.numpy())))
    assert _bits_equal(s.numpy(), ref)
    assert torch.signbit(s[3]) and torch.isnan(s[4])


def test_cpu_wrapper_takes_plain_and_counts_no_launch():
    args = [torch.from_numpy(t) for t in _inputs(4, 512, seed=2)]
    before = dict(K.LAUNCHES)
    out = K.fused_linf_apgd_step(*args, 2 / 255, 0.75)
    assert K.LAUNCHES == before
    assert _bits_equal(out.numpy(), K.linf_step_plain(*args, 2 / 255, 0.75).numpy())


@pytest.mark.cuda
def test_cuda_kernel_bitwise_equals_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for f in (3 * 224 * 224, 1001):  # 16-byte path and scalar path
        args = [torch.from_numpy(t).cuda() for t in _inputs(8, f, seed=4)]
        before = K.LAUNCHES["linf_step"]
        for a in (1.0, 0.75):
            got = K.fused_linf_apgd_step(*args, 2 / 255, a).cpu().numpy()
            ref = K.linf_step_plain(*args, 2 / 255, a).cpu().numpy()
            assert _bits_equal(got, ref)
        assert K.LAUNCHES["linf_step"] == before + 2
