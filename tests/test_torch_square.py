"""The port's Square Attack (robustvlm_tpu_torch.attacks.square) against the
JAX package's.

The deterministic helpers (the p-schedule, the l2/l1 side schedule, the eta
patterns, the margin loss, the tiled init's magnitudes) are bit-equal to
JAX's. The searches draw different random numbers in the two frameworks, so
whole runs are compared by outcome on a small-margin linear classifier, in
each norm: every example fooled on both sides, x_adv in the eps ball and in
[0,1], the query budget kept.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.attacks import square as J
from robustvlm_tpu_torch.attacks import square as T
from robustvlm_tpu_torch.ops.projections import l1_norm, l2_norm, linf_norm

torch.set_num_threads(1)


@pytest.mark.parametrize("n_queries", [10, 100, 500, 5000, 10000])
@pytest.mark.parametrize("rescale", [True, False])
def test_p_schedule_bit_equal(n_queries, rescale):
    for it in range(0, n_queries, max(1, n_queries // 200)):
        assert T._p_schedule(it, n_queries, 0.8, rescale) == J._p_schedule(it, n_queries, 0.8, rescale)


@pytest.mark.parametrize("hw,c", [(16, 3), (32, 3), (224, 3), (17, 1)])
def test_l2_sides_bit_equal(hw, c):
    for n_queries in (50, 500):
        args = (n_queries, c * hw * hw, c, hw, hw, 0.8, True)
        assert T._l2_sides(*args) == J._l2_sides(*args)


@pytest.mark.parametrize("name", ["_eta", "_eta_l1", "_eta_rectangles", "_eta_l1_rectangles"])
def test_eta_patterns_bit_equal(name):
    for s in range(2, 30):
        args = (s,) if name in ("_eta", "_eta_l1") else (s, s + 1)
        assert np.array_equal(getattr(T, name)(*args), getattr(J, name)(*args))


def test_margin_loss_bit_equal():
    r = np.random.RandomState(0)
    logits = np.round(r.randn(16, 10), 1).astype(np.float32)  # ties
    y = r.randint(0, 10, 16)
    ref = np.asarray(J.margin_loss(jnp.asarray(logits), jnp.asarray(y)))
    assert np.array_equal(T.margin_loss(torch.from_numpy(logits), torch.from_numpy(y)).numpy(), ref)


@pytest.mark.parametrize("h", [16, 32])
def test_tiled_init_magnitudes_bit_equal(h):
    """The init pattern's magnitudes (its signs are random draws)."""
    s0 = max(h // 5, 1)
    sp = (h - s0 * 5) // 2 if h >= 5 * s0 else 0
    for eta in (J._eta, J._eta_l1):
        ref = np.asarray(J._tiled_init_delta(jax.random.PRNGKey(0), 2, 3, h, h, s0, sp, eta(s0), jnp.float32))
        got = T._tiled_init_delta(torch.Generator().manual_seed(0), 2, 3, h, h, s0, sp, eta(s0),
                                  torch.float32, "cpu")
        assert np.array_equal(np.abs(got.numpy()), np.abs(ref))


def _linear(seed=0, n=4, n_cls=10, size=16):
    """A linear classifier whose clean points sit close to a boundary."""
    r = np.random.RandomState(seed)
    x = (r.rand(n, 3, size, size) * 0.6 + 0.2).astype(np.float32)
    w = (r.randn(3 * size * size, n_cls) * 0.05).astype(np.float32)
    y = (x.reshape(n, -1) @ w).argmax(-1)
    return x, y, w


CASES = {"linf": (T.square_attack_linf, J.square_attack_linf, 16 / 255, linf_norm),
         "l2": (T.square_attack_l2, J.square_attack_l2, 3.0, l2_norm),
         "l1": (T.square_attack_l1, J.square_attack_l1, 30.0, l1_norm)}


def _in_ball(size, delta, eps) -> bool:
    """||delta|| <= eps up to float32 rounding of x + delta - x (absolute
    for l-inf, relative for the summed norms)."""
    tol = 1e-6 if size is linf_norm else eps * 1e-5
    return bool((size(delta) <= eps + tol).all())


@pytest.mark.parametrize("norm", ["linf", "l2", "l1"])
def test_square_outcomes_match_jax(norm):
    tfn_attack, jfn_attack, eps, size = CASES[norm]
    x, y, w = _linear()
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    n_queries = 300
    ref = jfn_attack(lambda a: a.reshape(a.shape[0], -1) @ jw, jnp.asarray(x), jnp.asarray(y),
                     eps=eps, n_queries=n_queries, rng=jax.random.PRNGKey(1))
    got = tfn_attack(lambda a: a.reshape(a.shape[0], -1) @ tw, torch.from_numpy(x), torch.from_numpy(y),
                     eps=eps, n_queries=n_queries, rng=1)
    jfooled = np.asarray(ref.margin) < 0
    tfooled = got.margin.numpy() < 0
    assert tfooled.all() and np.array_equal(tfooled, jfooled)
    logits = got.x_adv.reshape(len(y), -1) @ tw
    assert np.array_equal((logits.argmax(-1).numpy() != y), tfooled)  # fooled when re-run
    assert _in_ball(size, got.x_adv - torch.from_numpy(x), eps)
    # l1 returns x + delta + d unclipped, as JAX does: [0,1] up to its rounding
    box_tol = 1e-6 if norm == "l1" else 0.0
    assert float(got.x_adv.min()) >= -box_tol and float(got.x_adv.max()) <= 1.0 + box_tol
    q = got.n_queries.numpy()
    assert (q >= 1).all() and (q <= n_queries).all() and (q < n_queries).any()


def test_square_keeps_the_clean_point_of_a_robust_example_in_budget():
    """An example the search cannot fool uses the whole budget and stays
    in the ball."""
    x, y, w = _linear(1)
    tw = torch.from_numpy(w)
    res = T.square_attack_linf(lambda a: a.reshape(a.shape[0], -1) @ tw, torch.from_numpy(x),
                               torch.from_numpy(y), eps=1e-4, n_queries=40, rng=0)
    assert (res.margin.numpy() >= 0).all() and (res.n_queries.numpy() == 40).all()
    assert _in_ball(linf_norm, res.x_adv - torch.from_numpy(x), 1e-4)
