"""The port's training slice (robustvlm_tpu_torch.train and what it calls)
against the JAX package, float32 on the CPU, on the same numpy inputs and
weights (`params_from_jax`).

Tolerances:
- `cosine_warmup_lr`: rel 1e-6, and one float32 ulp of the cosine term
  times the base rate absolute (cancellation near the schedule's end);
- AdamW and SGD on identical gradients, 3 steps: each leaf rel 1e-6 in
  norm (both evaluate the same float32 formulas in another operation
  order, a few ulps apart per element);
- losses, l2 directions and projections: rel 1e-6; the l-inf direction
  and projection bitwise, -0.0 and NaN included;
- PGD on the analytic toy of tests/test_pgd.py from the same start: 1e-6;
- one FARE and one TeCoA step at test-tiny (`--attack none`, the frozen
  original perturbed so the loss is not 0): loss and metrics rel 1e-5,
  every gradient leaf rel 1e-5 in norm, the parameters after the AdamW
  update within 1e-2 * lr where the gradient is above that tolerance (the
  first Adam update is about lr * sign(g), so an exactly-zero gradient
  steps by +-lr on float noise: those elements are held to a step <= lr);
- `grad_accum=2` against the full batch and JAX's `grad_accum=2`, remat
  against none: rel 1e-5 in norm.

JAX's gradients are read through a stand-in optimizer patched into
`robustvlm_tpu.train.trainer` for the test only: its state is the gradient
tree the step hands it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from robustvlm_tpu.attacks.pgd import pgd_attack as jax_pgd
from robustvlm_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS
from robustvlm_tpu.models.clip import init_clip_params
from robustvlm_tpu.models.clip.import_torch import export_visual_state_dict as jax_export
from robustvlm_tpu.ops import losses as jl
from robustvlm_tpu.ops import projections as jp
from robustvlm_tpu.train import trainer as jt
from robustvlm_tpu.train.schedules import cosine_warmup_lr as jax_schedule
from robustvlm_tpu_torch.attacks.pgd import pgd_attack
from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, export_visual_state_dict, params_from_jax
from robustvlm_tpu_torch.models.clip.convert import visual_from_openai
from robustvlm_tpu_torch.ops import losses as tl
from robustvlm_tpu_torch.ops import projections as tp
from robustvlm_tpu_torch.train import trainer as tt
from robustvlm_tpu_torch.train.schedules import cosine_warmup_lr

torch.set_num_threads(1)
JCFG = JAX_CONFIGS["test-tiny"]
TCFG = CLIP_CONFIGS["test-tiny"]


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    na, nb = np.isnan(a), np.isnan(b)
    return np.array_equal(na, nb) and np.array_equal(a.view(np.int32)[~na], b.view(np.int32)[~nb])


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den > 0 else float(np.abs(a).max(initial=0.0))


# ------------------------------------------------------------------ schedule
def test_cosine_warmup_lr_matches_jax_at_steps_0_to_100():
    ours, theirs = cosine_warmup_lr(1e-3, 10, 100), jax_schedule(1e-3, 10, 100)
    for s in range(101):
        assert ours(s) == pytest.approx(float(theirs(s)), rel=1e-6, abs=1e-3 * 2.0 ** -23), s


# ---------------------------------------------------------------- optimizers
def _opt_leaves(seed=0):
    rng = np.random.RandomState(seed)
    params = {"a": rng.randn(6, 5).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 0.1).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_optimizer_three_steps_match_optax(opt):
    cfg = tt.TrainConfig(opt=opt, lr=1e-2, wd=0.1, warmup=2, steps=10, momentum_sgd=0.9)
    params, grads = _opt_leaves()
    jopt = jt.make_optimizer(jt.TrainConfig(**dataclasses.asdict(cfg)))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = tt.ScheduledOptimizer(cfg, tparams.values())
    for g in grads:
        updates, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
        for k, p in tparams.items():
            assert _rel(p.detach().numpy(), np.asarray(jparams[k])) <= 1e-6, k
    assert topt.count == 3


# ------------------------------------------------- losses and projections
def test_l2_embedding_and_targeted_ce_losses_match_jax():
    rng = np.random.RandomState(1)
    e, e0 = rng.randn(6, 16).astype(np.float32), rng.randn(6, 16).astype(np.float32)
    logits, y = rng.randn(6, 10).astype(np.float32), rng.randint(0, 10, 6)
    for red in ("mean", "none", "sum"):
        np.testing.assert_allclose(
            tl.l2_embedding_loss(torch.from_numpy(e), torch.from_numpy(e0), reduction=red).numpy(),
            np.asarray(jl.l2_embedding_loss(jnp.asarray(e), jnp.asarray(e0), reduction=red)), rtol=1e-6)
    np.testing.assert_allclose(
        tl.ce_loss_targeted(torch.from_numpy(logits), torch.from_numpy(y)).numpy(),
        np.asarray(jl.ce_loss_targeted(jnp.asarray(logits), jnp.asarray(y))), rtol=1e-6)
    for name, kw, jkw in (("l2", {"embedding_orig": torch.from_numpy(e0)}, {"embedding_orig": jnp.asarray(e0)}),
                          ("ce-targeted", {"y_target": torch.from_numpy(y)}, {"y_target": jnp.asarray(y)}),
                          ("ce", {}, {}), ("ce-targeted-cfts", {}, {}), ("dlr", {}, {})):
        out = e if name == "l2" else logits
        got = tl.make_loss_fn(name, **kw)(torch.from_numpy(out), torch.from_numpy(y))
        ref = jl.make_loss_fn(name, **jkw)(jnp.asarray(out), jnp.asarray(y))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        tl.make_loss_fn("nope")


def _edge_grad(seed=2):
    g = np.random.RandomState(seed).randn(4, 3, 8, 8).astype(np.float32)
    g[0, 0, 0, :4] = 0.0
    g[0, 0, 1, :4] = -0.0
    g[1, 0, 0, :4] = np.nan
    return g


def test_linf_direction_and_projection_bitwise_including_signed_zero_and_nan():
    g = _edge_grad()
    got = tp.normalize_grad(torch.from_numpy(g), "linf").numpy()
    assert _bits_equal(got, np.asarray(jp.normalize_grad(jnp.asarray(g), "linf")))
    assert np.signbit(got[0, 0, 1, 0]) and got[0, 0, 1, 0] == 0.0  # -0.0 keeps its sign
    d = g * 0.05
    for eps in (2 / 255, 4 / 255):
        got = tp.project_perturbation(torch.from_numpy(d), eps, "linf").numpy()
        assert _bits_equal(got, np.asarray(jp.project_perturbation(jnp.asarray(d), eps, "linf")))


def test_l2_norm_direction_and_projection_match_jax():
    g = np.random.RandomState(3).randn(4, 3, 8, 8).astype(np.float32)
    np.testing.assert_allclose(tp.l2_norm(torch.from_numpy(g), keepdims=True).numpy(),
                               np.asarray(jp.l2_norm(jnp.asarray(g), keepdims=True)), rtol=1e-6)
    np.testing.assert_allclose(tp.normalize_grad(torch.from_numpy(g), "l2").numpy(),
                               np.asarray(jp.normalize_grad(jnp.asarray(g), "l2")), rtol=1e-6, atol=1e-9)
    d = g * np.array([0.001, 0.01, 0.1, 1.0], np.float32)[:, None, None, None]  # inside and outside
    for eps in (0.5, 2.0):
        np.testing.assert_allclose(tp.project_perturbation(torch.from_numpy(d), eps, "l2").numpy(),
                                   np.asarray(jp.project_perturbation(jnp.asarray(d), eps, "l2")),
                                   rtol=1e-6, atol=1e-9)


# ------------------------------------------------------------------------ PGD
@pytest.mark.parametrize("norm,eps,stepsize,mode", [
    ("linf", 8 / 255, 2 / 255, "max"), ("linf", 8 / 255, 2 / 255, "min"), ("l2", 0.5, 0.1, "max")])
def test_pgd_matches_jax_on_the_analytic_toy(norm, eps, stepsize, mode):
    rng = np.random.RandomState(0)
    x = rng.rand(8, 3, 8, 8).astype(np.float32)
    target = np.clip(x + 0.3, 0, 1).astype(np.float32)
    start = (rng.uniform(-1, 1, x.shape) * eps * (1.0 if norm == "linf" else 0.01)).astype(np.float32)
    ref = jax_pgd(lambda xa: -jnp.sum((xa - jnp.asarray(target)) ** 2), jnp.asarray(x), eps=eps,
                  stepsize=stepsize, iterations=10, norm=norm, mode=mode,
                  perturbation=jnp.asarray(start))
    tgt = torch.from_numpy(target)
    got = pgd_attack(lambda xa: -((xa - tgt) ** 2).sum(), torch.from_numpy(x), eps=eps,
                     stepsize=stepsize, iterations=10, norm=norm, mode=mode,
                     perturbation=torch.from_numpy(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    if norm == "linf":
        assert float((got - torch.from_numpy(x)).abs().max()) <= eps + 1e-6


def test_pgd_random_start_is_seeded_and_inside_the_ball():
    x = torch.rand(4, 3, 8, 8, generator=torch.Generator().manual_seed(0))
    fn = lambda xa: (xa * 0.0).sum()  # zero gradient: the start is the result
    a = pgd_attack(fn, x, eps=0.03, stepsize=0.01, iterations=1, random_start=True, rng=5)
    b = pgd_attack(fn, x, eps=0.03, stepsize=0.01, iterations=1, random_start=True, rng=5)
    c = pgd_attack(fn, x, eps=0.03, stepsize=0.01, iterations=1, random_start=True, rng=6)
    assert torch.equal(a, b) and float((a - x).abs().max()) <= 0.03 + 1e-7
    assert not torch.equal(a, c)
    with pytest.raises(ValueError):
        pgd_attack(fn, x, eps=0.03, stepsize=0.01, iterations=1, random_start=True)


# ----------------------------------------------------------------- train step
def _capture_grads():
    """A stand-in optax optimizer whose state after an update is the
    gradient tree it was handed (and whose update leaves params alone)."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def tiny():
    params = init_clip_params(jax.random.PRNGKey(0), JCFG)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(0)
    tree_orig = jax.tree.map(lambda a: (a + rng.randn(*a.shape).astype(np.float32) * 0.02
                                        if a.ndim else a), tree)
    x = rng.rand(8, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 8)
    t = rng.randn(JCFG.embed_dim, 10).astype(np.float32)
    temb = t / np.linalg.norm(t, axis=0, keepdims=True)
    return tree, tree_orig, x, y, temb


def _jax_step(cfg, tiny, with_text=True):
    """JAX's metrics, gradient tree and AdamW-updated tree of one step."""
    tree, tree_orig, x, y, temb = tiny
    jcfg = jt.TrainConfig(**dataclasses.asdict(cfg))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jt, "make_optimizer", lambda c: _capture_grads())
        step = jax.jit(jt.make_train_step(jcfg, JCFG, jnp.asarray(temb) if with_text else None))
    params = jax.tree.map(jnp.asarray, tree)
    _, grads, metrics = step(params, jax.tree.map(jnp.asarray, tree_orig), jax.tree.map(jnp.zeros_like, params),
                             jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0), 0)
    opt = jt.make_optimizer(jcfg)
    updates, _ = opt.update(grads, opt.init(params), params)
    new = optax.apply_updates(params, updates)
    as_sd = lambda t: params_from_jax(jax.tree.map(np.asarray, t))
    return {k: float(v) for k, v in metrics.items()}, as_sd(grads), as_sd(new)


def _port_step(cfg, tiny, with_text=True, seed=0):
    tree, tree_orig, x, y, temb = tiny
    model, orig = CLIP(TCFG), CLIP(TCFG)
    model.load_state_dict(params_from_jax(tree))
    orig.load_state_dict(params_from_jax(tree_orig))
    step = tt.TrainStep(cfg, model, orig, torch.from_numpy(temb) if with_text else None)
    metrics = step(torch.from_numpy(x), torch.from_numpy(y), seed)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads, model, orig


STEP_CFGS = {
    "fare": tt.TrainConfig(loss="l2", inner_loss="l2", attack="none", lr=1e-3, warmup=1, steps=10),
    "tecoa": tt.TrainConfig(loss="ce", inner_loss="ce", attack="none", lr=1e-3, warmup=1, steps=10),
}


@pytest.mark.parametrize("kind", sorted(STEP_CFGS))
def test_one_train_step_matches_jax(tiny, kind):
    cfg = STEP_CFGS[kind]
    jm, jgrads, jnew = _jax_step(cfg, tiny)
    tm, tgrads, model, orig = _port_step(cfg, tiny)
    assert set(tm) == set(jm) == {"loss", "loss_total", "cos_sim", "cos_sim_clean", "racc", "acc"}
    assert jm["loss"] > 1e-3  # the perturbed original makes the loss non-zero
    for k in jm:
        assert tm[k] == pytest.approx(jm[k], rel=1e-5, abs=1e-7), k
    assert set(tgrads) == set(jgrads)
    for n in jgrads:
        assert _rel(tgrads[n].numpy(), jgrads[n].numpy()) <= 1e-5, n
    assert float(tgrads["text.token_embedding"].abs().max()) == 0.0  # whole tree, as JAX
    # Adam's first update is lr * g / (|g| + 1e-8): where the exact gradient
    # is 0 (the key bias: softmax ignores a constant added to a row of
    # scores), both sides hold float noise and its sign is arbitrary. Such
    # elements (|g| under the 1e-5 norm tolerance held above) are held to
    # one step of at most lr; every other element to 1e-2 * lr.
    lr0 = cosine_warmup_lr(cfg.lr, cfg.warmup, cfg.steps)(0)
    sd0 = params_from_jax(tiny[0])
    for n, p in model.named_parameters():
        g = jgrads[n].numpy()
        noise = np.abs(g) <= 1e-5 * np.linalg.norm(g)
        got, ref = p.detach().numpy(), jnew[n].numpy()
        np.testing.assert_allclose(got[~noise], ref[~noise], rtol=0, atol=1e-2 * lr0, err_msg=n)
        assert np.abs(got - sd0[n].numpy())[noise].max(initial=0.0) <= lr0 * (1 + 1e-3), n
    # the frozen original neither trained nor received gradients
    orig_sd = params_from_jax(tiny[1])
    for n, p in orig.named_parameters():
        assert p.grad is None and not p.requires_grad
        assert torch.equal(p.detach(), orig_sd[n]), n


def test_grad_accum_matches_full_batch_and_jax(tiny):
    cfg = dataclasses.replace(STEP_CFGS["fare"], grad_accum=2)
    jm, jgrads, _ = _jax_step(cfg, tiny, with_text=False)
    tm, tgrads, _, _ = _port_step(cfg, tiny, with_text=False)
    fm, fgrads, _, _ = _port_step(STEP_CFGS["fare"], tiny, with_text=False)
    for k in jm:
        assert tm[k] == pytest.approx(jm[k], rel=1e-5, abs=1e-7), k
        assert tm[k] == pytest.approx(fm[k], rel=1e-5, abs=1e-7), k
    for n in jgrads:
        assert _rel(tgrads[n].numpy(), jgrads[n].numpy()) <= 1e-5, n
        assert _rel(tgrads[n].numpy(), fgrads[n].numpy()) <= 1e-5, n


def test_grad_accum_requires_a_divisible_batch(tiny):
    with pytest.raises(ValueError, match="divisible"):
        _port_step(dataclasses.replace(STEP_CFGS["fare"], grad_accum=3), tiny)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_remat_matches_no_remat(tiny, compute_dtype):
    cfg = dataclasses.replace(STEP_CFGS["tecoa"], compute_dtype=compute_dtype)
    m0, g0, _, _ = _port_step(cfg, tiny)
    m1, g1, _, _ = _port_step(dataclasses.replace(cfg, remat=True), tiny)
    assert m0 == m1
    for n in g0:
        assert _rel(g1[n].numpy(), g0[n].numpy()) <= 1e-5, n


@pytest.mark.parametrize("attack,loss", [("pgd", "l2"), ("pgd", "ce"), ("apgd", "l2"), ("apgd", "ce")])
def test_inner_attack_stays_in_the_ball_and_raises_the_loss(tiny, attack, loss):
    tree, tree_orig, x, y, temb = tiny
    cfg = tt.TrainConfig(loss=loss, inner_loss=loss, attack=attack, eps=4 / 255, iterations_adv=3)
    model, orig = CLIP(TCFG), CLIP(TCFG)
    model.load_state_dict(params_from_jax(tree))
    orig.load_state_dict(params_from_jax(tree_orig))
    step = tt.TrainStep(cfg, model, orig, torch.from_numpy(temb))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    emb_orig = step.frozen_embedding(xt)
    x_adv = step.inner_attack(xt, yt, emb_orig, seed=3)
    assert not x_adv.requires_grad and all(p.requires_grad for p in model.parameters())
    assert float((x_adv - xt).abs().max()) <= cfg.eps + 1e-6
    assert float(x_adv.min()) >= 0.0 and float(x_adv.max()) <= 1.0
    with torch.no_grad():
        assert float(step.inner_loss(x_adv, yt, emb_orig)) > float(step.inner_loss(xt, yt, emb_orig))


def test_pgd_inner_attack_matches_jax_from_the_same_start(tiny):
    """The PGD dispatch with an explicit start against JAX's pgd_attack on
    JAX's encoder with the same weights and loss."""
    tree, tree_orig, x, y, temb = tiny
    cfg = tt.TrainConfig(loss="l2", inner_loss="l2", attack="pgd", eps=4 / 255, iterations_adv=3)
    start = np.random.RandomState(5).uniform(-cfg.eps, cfg.eps, x.shape).astype(np.float32)
    model, orig = CLIP(TCFG), CLIP(TCFG)
    model.load_state_dict(params_from_jax(tree))
    orig.load_state_dict(params_from_jax(tree_orig))
    step = tt.TrainStep(cfg, model, orig)
    xt = torch.from_numpy(x)
    got = step.inner_attack(xt, None, step.frozen_embedding(xt), 0, perturbation=torch.from_numpy(start))

    from robustvlm_tpu.models.clip import encode_image
    from robustvlm_tpu.ops.image import normalize_clip

    params, porig = jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, tree_orig)
    e0 = encode_image(porig, normalize_clip(jnp.asarray(x)), JCFG)
    ref = jax_pgd(lambda xa: jl.l2_embedding_loss(encode_image(params, normalize_clip(xa), JCFG), e0),
                  jnp.asarray(x), eps=cfg.eps, stepsize=cfg.stepsize_adv, iterations=3, norm="linf",
                  mode="max", perturbation=jnp.asarray(start))
    # sign() can turn a last-bit gradient difference into a step of the
    # other sign: hold the share of elements that moved alike
    same = np.isclose(got.numpy(), np.asarray(ref), atol=1e-6)
    assert same.mean() >= 0.99


def test_pgd_inner_attack_starts_from_pgd_attacks_draw(tiny):
    """Without an explicit start the PGD dispatch is pgd_attack's seeded
    random start, exactly; another seed gives another start."""
    tree, tree_orig, x, _, _ = tiny
    cfg = tt.TrainConfig(loss="l2", inner_loss="l2", attack="pgd", eps=4 / 255, iterations_adv=2)
    model, orig = CLIP(TCFG), CLIP(TCFG)
    model.load_state_dict(params_from_jax(tree))
    orig.load_state_dict(params_from_jax(tree_orig))
    step = tt.TrainStep(cfg, model, orig)
    xt = torch.from_numpy(x)
    emb_orig = step.frozen_embedding(xt)
    got = step.inner_attack(xt, None, emb_orig, 7)
    ref = pgd_attack(lambda xa: step.inner_loss(xa, None, emb_orig), xt, eps=cfg.eps,
                     stepsize=cfg.stepsize_adv, iterations=2, random_start=True, rng=7)
    assert torch.equal(got, ref)
    assert not torch.equal(got, step.inner_attack(xt, None, emb_orig, 8))


def test_eval_step_outcome_matches_jax(tiny):
    tree, _, x, y, temb = tiny
    cfg = tt.TrainConfig(eps=4 / 255)
    jev = jt.make_eval_step(jt.TrainConfig(eps=4 / 255), JCFG, jnp.asarray(temb), n_iter=3)
    jm = {k: float(v) for k, v in jev(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(y)).items()}
    model = CLIP(TCFG)
    model.load_state_dict(params_from_jax(tree))
    model.requires_grad_(True)
    tm = {k: float(v) for k, v in tt.make_eval_step(cfg, model, torch.from_numpy(temb), n_iter=3)(
        torch.from_numpy(x), torch.from_numpy(y)).items()}
    assert set(tm) == set(jm) == {"eval/racc", "eval/acc", "eval/cos_sim"}
    assert tm["eval/acc"] == jm["eval/acc"]
    assert tm["eval/racc"] == jm["eval/racc"] and tm["eval/racc"] <= tm["eval/acc"]
    assert tm["eval/cos_sim"] == pytest.approx(jm["eval/cos_sim"], abs=1e-3)
    assert all(p.requires_grad for p in model.parameters())  # restored after the attack


def test_export_visual_state_dict_matches_jax_and_round_trips(tiny):
    tree = tiny[0]
    model = CLIP(TCFG)
    model.load_state_dict(params_from_jax(tree))
    ours = export_visual_state_dict(model.state_dict(), TCFG)
    theirs = jax_export(tree["visual"], JCFG)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert np.array_equal(ours[k].numpy(), np.asarray(v)), k
    back = visual_from_openai(ours, TCFG)
    for k, v in back.items():
        assert torch.equal(v, model.state_dict()[k]), k
