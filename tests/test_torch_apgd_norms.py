"""The port's l2 and l1 APGD, decr-eps schedule and EOT against the JAX package.

Steps: with the model the identity and the loss sum(x * G), the pixel
gradient is G exactly in both frameworks, so a run of 1-3 iterations holds
the l2 and l1 iterate updates (and, for l1, the top-k and step-size update
at the checkpoint after every iteration) to JAX's within 1e-6. Whole runs on
a tiny linear classifier are compared by outcome (robust flags), since
sign() turns last-bit gradient differences into different valid
trajectories. EOT is checked on its own: a deterministic model gives what
eot_iter=1 gives, and a seeded random model's gradient is the average of
its draws, in closed form.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.attacks import apgd as japgd
from robustvlm_tpu.ops.losses import ce_loss as jax_ce_loss
from robustvlm_tpu_torch.attacks import apgd as tapgd
from robustvlm_tpu_torch.ops.losses import ce_loss
from robustvlm_tpu_torch.ops.projections import l1_norm, l2_norm

torch.set_num_threads(1)
TOL = 1e-6
SHAPE = (4, 3, 8, 8)


def _inputs(seed=0):
    r = np.random.RandomState(seed)
    x = r.rand(*SHAPE).astype(np.float32)
    g = r.randn(*SHAPE).astype(np.float32)
    return x, g


def _jcrit(o, yy, g):
    return jnp.sum((o * g).reshape(o.shape[0], -1), axis=-1)


def _tcrit(o, yy, g):
    return (o * g).reshape(o.shape[0], -1).sum(dim=-1)


@pytest.mark.parametrize("norm,eps", [("l2", 0.5), ("l1", 6.0)])
@pytest.mark.parametrize("n_iter", [1, 2, 3])
def test_step_with_identical_gradients_matches_jax(norm, eps, n_iter):
    x, g = _inputs()
    kw = dict(eps=eps, n_iter=n_iter, norm=norm)
    ref = japgd.apgd_attack(lambda a: a, jnp.asarray(x), None, criterion=_jcrit,
                            criterion_args=(jnp.asarray(g),), **kw)
    got = tapgd.apgd_attack(lambda a: a, torch.from_numpy(x), None, criterion=_tcrit,
                            criterion_args=(torch.from_numpy(g),), **kw)
    for name in ("x_best_adv", "x_best"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.loss_best.numpy(), np.asarray(ref.loss_best), rtol=TOL)
    d = got.x_best_adv - torch.from_numpy(x)
    assert bool(((l2_norm(d) if norm == "l2" else l1_norm(d)) <= eps * (1 + 1e-5)).all())
    assert not torch.equal(got.x_best_adv, torch.from_numpy(x))


@pytest.mark.parametrize("n_iter", [1, 5, 25, 50, 100])
def test_l1_checkpoint_schedule_equal(n_iter):
    jc, jw = japgd._checkpoint_schedule(n_iter, "l1")
    tc, tw = tapgd._checkpoint_schedule(n_iter, "l1")
    assert np.array_equal(np.asarray(jc), tc) and np.array_equal(np.asarray(jw), tw)


def test_apgd_accepts_the_jax_keyword_set():
    jax_names = set(inspect.signature(japgd.apgd_attack).parameters)
    assert jax_names <= set(inspect.signature(tapgd.apgd_attack).parameters)
    x, g = _inputs()
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    res = tapgd.apgd_attack(lambda a: a, xt, None, criterion=_tcrit, criterion_args=(gt,), eps=4.0,
                            n_iter=3, norm="l1", topk_init=0.1, use_fused_kernel=False, eot_iter=1,
                            model_rng_fn=None, host_loop=True, skip_last_grad=None, rng=0)
    assert res.x_best.shape == xt.shape
    with pytest.raises(ValueError):
        tapgd.apgd_attack(lambda a: a, xt, None, criterion=_tcrit, criterion_args=(gt,), eps=1.0, norm="l0")


def _recorder(log, stage_points, as_array):
    def fake(model_fn, x, y, *, criterion, eps, n_iter, norm, x_init, rng, **kw):
        log.append((eps, n_iter, np.asarray(x_init).copy()))
        xb = as_array(stage_points[len(log) - 1])
        return (japgd if as_array is jnp.asarray else tapgd).APGDResult(xb, xb, None, None)
    return fake


@pytest.mark.parametrize("norm,eps", [("linf", 8 / 255), ("l1", 6.0)])
def test_decr_eps_stages_and_warm_starts_match_jax(monkeypatch, norm, eps):
    """The radii and iterations of the three stages, and each warm start:
    the previous stage's best point projected into the next, smaller ball
    (here a fixed point per stage, the same on both sides). The first
    stage's start is drawn (different numbers in the two frameworks), so it
    is checked to lie in its ball."""
    x, _ = _inputs(2)
    r = np.random.RandomState(5)
    pts = [np.clip(x + r.randn(*SHAPE).astype(np.float32) * 0.2, 0, 1) for _ in range(3)]
    jlog, tlog = [], []
    monkeypatch.setattr(japgd, "apgd_attack", _recorder(jlog, pts, jnp.asarray))
    monkeypatch.setattr(tapgd, "apgd_attack", _recorder(tlog, pts, torch.from_numpy))
    japgd.apgd_decr_eps(None, jnp.asarray(x), None, criterion=None, eps=eps, n_iter=20, norm=norm)
    tapgd.apgd_decr_eps(None, torch.from_numpy(x), None, criterion=None, eps=eps, n_iter=20, norm=norm,
                        use_rs=True)
    assert [(e, n) for e, n, _ in tlog] == [(e, n) for e, n, _ in jlog]
    assert [n for _, n, _ in tlog] == [6, 6, 8]
    assert tapgd.decr_eps_schedule(eps, 20) == ([3 * eps, 2 * eps, eps], [6, 6, 8])
    for (e, _, ti), (_, _, ji) in zip(tlog[1:], jlog[1:]):
        np.testing.assert_allclose(ti, ji, atol=2e-6, rtol=TOL)
    e0, _, t0 = tlog[0]
    d = torch.from_numpy(t0 - x)
    size = d.abs().amax() if norm == "linf" else l1_norm(d).max()
    assert float(size) <= e0 * (1 + 1e-5) and t0.min() >= -1e-6 and t0.max() <= 1 + 1e-6


def test_eot_with_a_deterministic_model_equals_one_draw():
    x, g = _inputs(3)
    for norm, eps in (("linf", 0.03), ("l2", 0.5), ("l1", 6.0)):
        kw = dict(criterion=_tcrit, criterion_args=(torch.from_numpy(g),), eps=eps, n_iter=4, norm=norm, rng=3)
        one = tapgd.apgd_attack(lambda a: a, torch.from_numpy(x), None, **kw)
        eot = tapgd.apgd_attack(lambda a: a, torch.from_numpy(x), None, eot_iter=2,
                                model_rng_fn=lambda a, seed: a, **kw)
        assert torch.equal(one.x_best, eot.x_best) and torch.equal(one.loss_best, eot.loss_best), norm


def _noisy_model(seen):
    def model_rng_fn(a, seed):
        seen.append(seed)
        m = 1.0 + 0.5 * torch.rand(a.shape[1:], generator=tapgd.generator(seed, "cpu"))
        return a * m
    return model_rng_fn


def test_eot_averages_a_seeded_random_model_in_closed_form():
    """loss_j = sum(x * m_j * G), grad_j = m_j * G: the EOT gradient is G
    times the mean of the draws' m_j, each draw seeded fold_in(seed, j)."""
    x, g = _inputs(4)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    seen = []
    loss, grad, _ = tapgd.eot_loss_grad(None, _tcrit, xt, None, (gt,), eot_iter=4,
                                        model_rng_fn=_noisy_model(seen), seed=11)
    assert seen == [tapgd.fold_in(11, j) for j in range(4)]
    ms = [1.0 + 0.5 * torch.rand(SHAPE[1:], generator=tapgd.generator(s, "cpu")) for s in seen]
    m_mean = sum(ms) / 4
    np.testing.assert_allclose(grad.numpy(), (gt * m_mean).numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(loss.numpy(), _tcrit(xt * m_mean, None, gt).numpy(), rtol=1e-5)
    assert not torch.allclose(grad, gt * ms[0])
    # inside the attack: the first evaluation draws from rng, iteration i
    # from fold_in(rng, i)
    seen.clear()
    tapgd.apgd_attack(lambda a: a, xt, None, criterion=_tcrit, criterion_args=(gt,), eps=0.5, norm="l2",
                      n_iter=2, eot_iter=2, model_rng_fn=_noisy_model(seen), rng=7)
    per_eval = [7, tapgd.fold_in(7, 0), tapgd.fold_in(7, 1)]
    assert seen == [tapgd.fold_in(s, j) for s in per_eval for j in range(2)]


def _linear(seed=0, n=8, n_cls=10):
    """logits = flat(x) @ W + b, with the clean point close to a boundary."""
    r = np.random.RandomState(seed)
    x = r.rand(n, 3, 8, 8).astype(np.float32) * 0.6 + 0.2
    w = (r.randn(3 * 64, n_cls) * 0.05).astype(np.float32)
    logits = x.reshape(n, -1) @ w
    y = logits.argmax(-1)
    return x, y, w


@pytest.mark.parametrize("norm,eps,largereps", [("l2", 0.35, False), ("l1", 1.0, False), ("l1", 1.5, True)])
def test_whole_runs_match_jax_outcomes(norm, eps, largereps):
    x, y, w = _linear()
    jw, tw = jnp.asarray(w), torch.from_numpy(w)

    def jfn(a):
        return a.reshape(a.shape[0], -1) @ jw

    def tfn(a):
        return a.reshape(a.shape[0], -1) @ tw

    kw = dict(eps=eps, n_iter=20, norm=norm, use_rs=False, use_largereps=largereps)
    ref = japgd.apgd_restarts(jfn, jnp.asarray(x), jnp.asarray(y),
                              criterion=lambda o, yy: jax_ce_loss(o, yy, reduction="none"), **kw)
    got = tapgd.apgd_restarts(tfn, torch.from_numpy(x), torch.from_numpy(y),
                              criterion=lambda o, yy: ce_loss(o, yy, reduction="none"), **kw)
    assert np.array_equal(got.acc.numpy(), np.asarray(ref.acc))
    assert 0 < int(got.acc.sum()) < len(y)  # a mixed outcome
    clean = ce_loss(tfn(torch.from_numpy(x)), torch.from_numpy(y), reduction="none")
    assert bool((got.loss_best >= clean).all())
    d = got.x_best_adv - torch.from_numpy(x)
    size = l2_norm(d) if norm == "l2" else l1_norm(d)
    assert bool((size <= eps * (1 + 1e-5)).all())
    fooled = tfn(got.x_best_adv).argmax(-1) != torch.from_numpy(y)
    assert torch.equal(fooled, ~got.acc)
