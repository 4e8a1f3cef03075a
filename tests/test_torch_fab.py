"""The port's FAB (robustvlm_tpu_torch.attacks.fab) against the JAX package's.

`projection_hyperplane_box` is held to JAX's within 1e-5 in each norm, on
rows that violate the hyperplane and rows that already satisfy it. Whole
`fab_attack` runs at n_restarts=1 draw nothing, so on a tiny linear
classifier (exact, equal gradients on both sides) x_adv and the norms
match JAX's within 1e-4 and `adv_found` exactly, targeted (FAB-T) and
untargeted, in each norm. Untargeted FAB takes its per-class gradients in
chunks of `GRAD_ROWS` rows; the chunking does not change the result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.attacks import fab as J
from robustvlm_tpu_torch.attacks import fab as T

torch.set_num_threads(1)


@pytest.mark.parametrize("norm", ["linf", "l2", "l1"])
def test_projection_hyperplane_box_matches_jax(norm):
    r = np.random.RandomState(0)
    u = r.rand(6, 48).astype(np.float32)
    w = r.randn(6, 48).astype(np.float32)
    wu = (w * u).sum(1)
    b = (wu - np.abs(r.randn(6)) * 2.0).astype(np.float32)
    b[1] = wu[1] + 1.0  # already feasible: returned as it is
    ref = np.asarray(J.projection_hyperplane_box(jnp.asarray(u), jnp.asarray(w), jnp.asarray(b), norm))
    got = T.projection_hyperplane_box(torch.from_numpy(u), torch.from_numpy(w), torch.from_numpy(b), norm)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * max(1.0, np.abs(ref).max()), rtol=0)
    assert torch.equal(got[1], torch.from_numpy(u[1]))
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def _linear(seed=0, n=4, n_cls=10):
    r = np.random.RandomState(seed)
    x = (r.rand(n, 3, 8, 8) * 0.6 + 0.2).astype(np.float32)
    w = (r.randn(3 * 64, n_cls) * 0.05).astype(np.float32)
    y = (x.reshape(n, -1) @ w).argmax(-1)
    return x, y, w


EPS = {"linf": 3 / 255, "l2": 0.13, "l1": 0.65}


@pytest.mark.parametrize("targeted", [True, False])
@pytest.mark.parametrize("norm", ["linf", "l2", "l1"])
def test_fab_matches_jax(norm, targeted):
    x, y, w = _linear()
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    kw = dict(norm=norm, n_iter=10, n_restarts=1, eps=EPS[norm], targeted=targeted, n_target_classes=3)
    ref = J.fab_attack(lambda a: a.reshape(a.shape[0], -1) @ jw, jnp.asarray(x), jnp.asarray(y), **kw)
    got = T.fab_attack(lambda a: a.reshape(a.shape[0], -1) @ tw, torch.from_numpy(x), torch.from_numpy(y), **kw)
    assert np.array_equal(got.adv_found.numpy(), np.asarray(ref.adv_found))
    assert 0 < int(got.adv_found.sum()) < len(y)  # a mixed outcome
    np.testing.assert_allclose(got.x_adv.numpy(), np.asarray(ref.x_adv), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.norms.numpy(), np.asarray(ref.norms), atol=1e-4, rtol=1e-4)
    fooled = (got.x_adv.reshape(len(y), -1) @ tw).argmax(-1).numpy() != y
    assert np.array_equal(fooled, got.adv_found.numpy())


def test_untargeted_class_chunks_do_not_change_the_result(monkeypatch):
    x, y, w = _linear(1)
    tw = torch.from_numpy(w)
    runs = []
    for rows in (1, 8, 64):
        monkeypatch.setattr(T, "GRAD_ROWS", rows)
        runs.append(T.fab_attack(lambda a: a.reshape(a.shape[0], -1) @ tw, torch.from_numpy(x),
                                 torch.from_numpy(y), norm="l2", n_iter=6, n_boundary_classes=5))
    for r in runs[1:]:
        assert torch.equal(r.adv_found, runs[0].adv_found)
        np.testing.assert_allclose(r.x_adv.numpy(), runs[0].x_adv.numpy(), atol=1e-6, rtol=0)
