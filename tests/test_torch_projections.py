"""The port's norms and eps-ball projections (robustvlm_tpu_torch.ops.projections)
against the JAX package's, float32 on the CPU, within 1e-6.

`l1_ball_projection` is held on the inputs where its sort matters: breakpoint
ties (y = 0 gives u = l = 0; repeated magnitudes), all-zero rows, rows
already inside the ball, and points whose [0,1] box binds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.ops import projections as J
from robustvlm_tpu_torch.ops import projections as T

torch.set_num_threads(1)
TOL = 1e-6


def _pair(seed=0, b=4, shape=(3, 8, 8), scale=0.1):
    r = np.random.RandomState(seed)
    x = r.rand(b, *shape).astype(np.float32)
    y = (r.randn(b, *shape) * scale).astype(np.float32)
    return x, y


def _close(got: torch.Tensor, ref) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_norms_match_jax():
    _, y = _pair()
    y[1] = 0.0
    y[2, :, :4] = 0.0
    for name in ("l1_norm", "l2_norm", "linf_norm"):
        for keep in (False, True):
            _close(getattr(T, name)(torch.from_numpy(y), keepdims=keep), getattr(J, name)(jnp.asarray(y), keepdims=keep))
    assert np.array_equal(T.l0_norm(torch.from_numpy(y)).numpy(), np.asarray(J.l0_norm(jnp.asarray(y))))


@pytest.mark.parametrize("norm", ["linf", "l2", "l1", "L2"])
def test_lp_normalize_matches_jax(norm):
    _, y = _pair(1)
    y[0] = 0.0  # the 1e-12 guard
    _close(T.lp_normalize(torch.from_numpy(y), norm), J.lp_normalize(jnp.asarray(y), norm))


def _case(name):
    x, y = _pair(2)
    if name == "random":
        return x, y, 0.8
    if name == "ties":  # zeros everywhere but a few repeated magnitudes
        y = np.where(np.random.RandomState(3).rand(*y.shape) < 0.5, 0.0, np.sign(y) * 0.05).astype(np.float32)
        return x, y, 0.6
    if name == "zero_rows":
        y[0] = 0.0
        y[2] = 0.0
        return x, y, 0.5
    if name == "inside_ball":
        return x, y * 0.01, 50.0
    if name == "box":  # x at the box edges: the [0,1] box binds
        x = np.round(x).astype(np.float32)
        x[1] = np.clip(x[1] + 0.01, 0.0, 1.0)
        return x, y * 5.0, 3.0
    raise ValueError(name)


@pytest.mark.parametrize("case", ["random", "ties", "zero_rows", "inside_ball", "box"])
def test_l1_ball_projection_matches_jax(case):
    x, y, eps = _case(case)
    ref = np.asarray(J.l1_ball_projection(jnp.asarray(x), jnp.asarray(y), eps))
    got = T.l1_ball_projection(torch.from_numpy(x), torch.from_numpy(y), eps)
    _close(got, ref)
    z = torch.from_numpy(y) + got
    assert bool((T.l1_norm(z) <= eps * (1 + 1e-5)).all())
    p = torch.from_numpy(x) + z
    assert float(p.min()) >= -1e-6 and float(p.max()) <= 1 + 1e-6


def test_project_onto_l1_box_matches_jax():
    """The point x + delta + d sums terms up to 2.5 that cancel to values
    near 0, so its float32 rounding alone is about 1e-6: 2e-6 here, the
    correction d itself held at 1e-6 above."""
    x, y, eps = _case("box")
    np.testing.assert_allclose(T.project_onto_l1_box(torch.from_numpy(x), torch.from_numpy(y), eps).numpy(),
                               np.asarray(J.project_onto_l1_box(jnp.asarray(x), jnp.asarray(y), eps)),
                               atol=2e-6, rtol=TOL)


def test_normalize_and_project_refuse_l1_as_jax_does():
    g = torch.ones(2, 3)
    with pytest.raises(ValueError):
        T.normalize_grad(g, "l1")
    with pytest.raises(ValueError):
        T.project_perturbation(g, 0.1, "l1")
    with pytest.raises(ValueError):
        J.normalize_grad(jnp.ones((2, 3)), "l1")
