"""The port's l-inf APGD (robustvlm_tpu_torch.attacks.apgd) against the JAX
package's.

The static schedule and the oscillation count must be equal exactly. On the
analytic toy of tests/test_apgd.py (exact gradients, no random start) whole
runs are compared: x_best, loss_best and acc. Through a CLIP model, sign()
amplifies last-bit gradient differences into different valid trajectories,
so there only outcomes are compared (test_torch_autoattack.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.attacks import apgd as japgd
from robustvlm_tpu.ops.losses import ce_loss as jax_ce_loss
from robustvlm_tpu_torch.attacks import apgd as tapgd
from robustvlm_tpu_torch.ops.losses import ce_loss

torch.set_num_threads(1)


@pytest.mark.parametrize("n_iter", [1, 5, 10, 23, 50, 100])
def test_checkpoint_schedule_equal(n_iter):
    jc, jw = japgd._checkpoint_schedule(n_iter, "linf")
    tc, tw = tapgd._checkpoint_schedule(n_iter, "linf")
    assert np.array_equal(np.asarray(jc), tc)
    assert np.array_equal(np.asarray(jw), tw)


def test_oscillation_count_equal_including_wraparound():
    rng = np.random.RandomState(0)
    n_iter, b = 12, 5
    hist = rng.randn(n_iter, b).astype(np.float32)
    hist[-1] = 0.0  # the still-zero last row the first checkpoint wraps onto
    for i in range(n_iter):
        for k in (1, 2, 3, 5):
            ref = np.asarray(japgd._oscillation_count(jnp.asarray(hist), jnp.int32(i), jnp.int32(k)))
            got = tapgd._oscillation_count(torch.from_numpy(hist), i, k).numpy()
            assert np.array_equal(ref, got)


def _toy(seed=1):
    """tests/test_apgd.py:121-130: model xa - t, loss -sum(out**2)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.1, 0.9, (8, 256)).astype(np.float32)
    t = np.clip(x + 0.05, 0, 1).astype(np.float32)
    return x, t


@pytest.mark.parametrize("n_iter", [10, 23])
def test_analytic_toy_matches_jax(n_iter):
    x, t = _toy()
    kw = dict(eps=0.03, n_iter=n_iter, norm="linf")
    ref = japgd.apgd_attack(
        lambda xa: xa - jnp.asarray(t), jnp.asarray(x), None,
        criterion=lambda out, y: -jnp.sum(out ** 2, axis=1), use_fused_kernel=False, **kw,
    )
    tt = torch.from_numpy(t)
    got = tapgd.apgd_attack(
        lambda xa: xa - tt, torch.from_numpy(x), None,
        criterion=lambda out, y: -(out ** 2).sum(dim=1), **kw,
    )
    np.testing.assert_allclose(got.x_best.numpy(), np.asarray(ref.x_best), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.loss_best.numpy(), np.asarray(ref.loss_best), atol=1e-5, rtol=1e-6)
    assert np.array_equal(got.acc.numpy(), np.asarray(ref.acc))


def test_linear_classifier_matches_jax_with_labels():
    """Accuracy tracking with labels: a linear 10-class model, CE loss."""
    rng = np.random.RandomState(0)
    x = rng.uniform(0.2, 0.8, (8, 32)).astype(np.float32)
    w = rng.randn(32, 10).astype(np.float32)
    y = np.argmax(x @ w, axis=1)
    kw = dict(eps=0.1, n_iter=10, norm="linf")
    ref = japgd.apgd_attack(
        lambda xa: xa @ jnp.asarray(w), jnp.asarray(x), jnp.asarray(y),
        criterion=lambda o, yy: jax_ce_loss(o, yy, reduction="none"), use_fused_kernel=False, **kw,
    )
    wt = torch.from_numpy(w)
    got = tapgd.apgd_attack(
        lambda xa: xa @ wt, torch.from_numpy(x), torch.from_numpy(y),
        criterion=lambda o, yy: ce_loss(o, yy, reduction="none"), **kw,
    )
    assert got.acc.dtype == torch.bool
    assert np.array_equal(got.acc.numpy(), np.asarray(ref.acc))
    np.testing.assert_allclose(got.loss_best.numpy(), np.asarray(ref.loss_best), atol=1e-4, rtol=1e-4)
    assert int(got.acc.sum()) < 8


def test_skip_last_grad_changes_nothing():
    x, t = _toy(2)
    tt = torch.from_numpy(t)
    kw = dict(criterion=lambda out, y: -(out ** 2).sum(dim=1), eps=0.03, n_iter=12)
    a = tapgd.apgd_attack(lambda xa: xa - tt, torch.from_numpy(x), None, skip_last_grad=True, **kw)
    b = tapgd.apgd_attack(lambda xa: xa - tt, torch.from_numpy(x), None, skip_last_grad=False, **kw)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_random_start_warm_start_and_ball():
    x, t = _toy(3)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    kw = dict(criterion=lambda out, y: -(out ** 2).sum(dim=1), eps=0.03, n_iter=6)
    r1 = tapgd.apgd_attack(lambda xa: xa - tt, xt, None, use_rs=True, rng=7, **kw)
    r2 = tapgd.apgd_attack(lambda xa: xa - tt, xt, None, use_rs=True, rng=7, **kw)
    r3 = tapgd.apgd_attack(lambda xa: xa - tt, xt, None, use_rs=True, rng=8, **kw)
    assert torch.equal(r1.x_best, r2.x_best)  # same seed, same run
    s7, s8 = tapgd._random_init(7, xt, 0.03), tapgd._random_init(8, xt, 0.03)
    assert not torch.equal(s7, s8)  # the seed picks the random start
    assert float((s7 - xt).abs().max()) <= 0.03 + 1e-6
    for r in (r1, r3):
        assert float((r.x_best_adv - xt).abs().max()) <= 0.03 + 1e-6
        assert float(r.x_best_adv.min()) >= 0 and float(r.x_best_adv.max()) <= 1
    warm = tapgd.apgd_attack(lambda xa: xa - tt, xt, None, x_init=(xt + 0.03).clamp(0, 1), **kw)
    assert warm.x_best.shape == xt.shape
    with pytest.raises(ValueError):
        tapgd.apgd_attack(lambda xa: xa - tt, xt, None, use_rs=True, **kw)
    with pytest.raises(ValueError):  # 0-255 pixels break the threat model
        tapgd.apgd_attack(lambda xa: xa - tt, xt * 255, None, **kw)
    with pytest.raises(NotImplementedError):
        tapgd.apgd_attack(lambda xa: xa - tt, xt, None, **dict(kw, norm="l2"))


def test_restarts_keep_first_success_and_best_loss():
    x, t = _toy(4)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    res = tapgd.apgd_restarts(lambda xa: xa - tt, xt, None, criterion=lambda o, y: -(o ** 2).sum(dim=1),
                              eps=0.03, n_iter=5, n_restarts=3, rng=1)
    singles = [tapgd.apgd_attack(lambda xa: xa - tt, xt, None, criterion=lambda o, y: -(o ** 2).sum(dim=1),
                                 eps=0.03, n_iter=5, use_rs=True, rng=tapgd.fold_in(1, r))
               for r in range(3)]
    best = torch.stack([s.loss_best for s in singles]).amax(dim=0)
    assert torch.equal(res.loss_best, best)
    assert torch.equal(res.x_best_adv, singles[0].x_best_adv)  # no labels: the first restart's


def test_fold_in_is_deterministic_and_spreads():
    assert tapgd.fold_in(0, 1) == tapgd.fold_in(0, 1)
    seeds = {tapgd.fold_in(s, d) for s in range(20) for d in range(20)}
    assert len(seeds) == 400
    assert all(0 <= s < 2 ** 63 for s in seeds)
