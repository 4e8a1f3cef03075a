"""`utils/profiling`: spans that record only inside a profiler window, on the
profiler's own timeline, and the spans of the APGD loop and the training
step. The test marked `cuda` needs the card and skips without one."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from robustvlm_tpu_torch.attacks import apgd as apgd_mod
from robustvlm_tpu_torch.attacks.apgd import apgd_attack
from robustvlm_tpu_torch.models.clip.model import CLIP, CLIP_CONFIGS
from robustvlm_tpu_torch.ops.losses import ce_loss
from robustvlm_tpu_torch.train.trainer import TrainConfig, TrainStep
from robustvlm_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _empty_log():
    profiling.reset()
    yield
    profiling.reset()


def _by_name(log):
    out = {}
    for s in log:
        out.setdefault(s["name"], []).append(s)
    return out


def _linear(seed=0, d=3 * 4 * 4, classes=5, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn(d, classes, generator=g) * 0.5).to(device)
    return lambda x: x.flatten(1) @ w


def _apgd(model, x, y, n_iter, **kw):
    return apgd_attack(model, x, y, criterion=lambda o, t: ce_loss(o, t, reduction="none"),
                       eps=8 / 255, n_iter=n_iter, **kw)


def test_off_span_is_the_shared_noop_and_records_nothing():
    a, b = profiling.span("apgd.iter"), profiling.span("train.step")
    assert a is b
    with a:
        with profiling.span("apgd.update"):
            torch.ones(4).sum()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_span_is_a_cpu_range_with_parent_and_root_around_its_ops():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(64).sum()
    log = _by_name(profiling.spans())
    (outer,), (inner,) = log["outer"], log["inner"]
    assert outer["parent"] is None and outer["root"] == outer["id"]
    assert inner["parent"] == outer["id"] and inner["root"] == outer["id"]
    assert outer["complete"] and inner["complete"]
    assert inner["device_ms"] is None and outer["device_ms"] is None  # no CUDA work
    assert 0 <= inner["host_ms"] <= outer["host_ms"]
    assert outer["host_self_ms"] == pytest.approx(outer["host_ms"] - inner["host_ms"])
    events = prof.events()
    (rng,) = [e for e in events if e.name == "inner"]
    assert "CPU" in str(rng.device_type) and not rng.is_user_annotation
    ops = [e for e in events if e.name == "aten::sum"]
    assert ops and all(rng.time_range.start <= e.time_range.start <= e.time_range.end <= rng.time_range.end
                       for e in ops)
    assert not [e for e in events if "CUDA" in str(e.device_type)]


def test_spans_across_the_window_edges_do_not_raise():
    # opened before the window: off when it opened, so not in the log; the
    # spans it encloses inside the window are kept, complete, as roots
    with profiling.span("before"):
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        with profiling.span("inside"):
            torch.ones(4).sum()
        # opened inside the window, closed after it stopped: kept, incomplete
        late = profiling.span("late")
        late.__enter__()
        torch.ones(4).sum()
        prof.stop()
        late.__exit__(None, None, None)
    log = _by_name(profiling.spans())
    assert "before" not in log
    (inside,), (lat,) = log["inside"], log["late"]
    assert inside["complete"] and inside["parent"] is None
    assert not lat["complete"] and lat["host_ms"] > 0
    assert [e.name for e in prof.events() if e.name in ("inside", "late")] == ["inside", "late"]


def test_the_log_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with profiling.span("apgd.iter"):
                pass
    assert len(profiling.spans()) == 3 and profiling.dropped() == 2
    profiling.reset()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_apgd_iterations_carry_their_phases_and_the_result_is_unchanged():
    torch.manual_seed(0)
    x, y = torch.rand(4, 3, 4, 4), torch.tensor([0, 1, 2, 3])
    model = _linear()
    plain = _apgd(model, x, y, 6, use_rs=True, rng=3)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _apgd(model, x, y, 6, use_rs=True, rng=3)
    assert torch.equal(traced.x_best, plain.x_best) and torch.equal(traced.x_best_adv, plain.x_best_adv)
    log = profiling.spans()
    by_id = {s["id"]: s for s in log}
    names = _by_name(log)
    (attack,) = names["apgd.attack"]
    iters = names["apgd.iter"]
    assert len(iters) == 6 and all(s["parent"] == attack["id"] and s["complete"] for s in iters)
    # the first evaluation sits directly under the attack
    top = [s["name"] for s in log if s["parent"] == attack["id"] and s["name"] != "apgd.iter"]
    assert top == ["apgd.forward", "apgd.backward"]
    for k, it in enumerate(iters):
        kids = [s["name"] for s in log if s["parent"] == it["id"]]
        last = k == len(iters) - 1  # forward only: its gradient is never read
        assert kids == ["apgd.update", "apgd.forward"] + ([] if last else ["apgd.backward"]) + ["apgd.update"]
    assert all(by_id[s["parent"]]["root"] == attack["id"] == s["root"] for s in log if s["parent"])


def test_apgd_without_the_skipped_gradient_has_three_phases_every_iteration():
    x, y = torch.rand(2, 3, 4, 4), torch.tensor([0, 1])
    with profile(activities=[ProfilerActivity.CPU]):
        _apgd(_linear(1), x, y, 3, skip_last_grad=False)
    log = profiling.spans()
    for it in _by_name(log)["apgd.iter"]:
        assert sorted({s["name"] for s in log if s["parent"] == it["id"]}) == \
            ["apgd.backward", "apgd.forward", "apgd.update"]


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_records_its_four_phases_with_the_attack_inside(grad_accum):
    model = CLIP(CLIP_CONFIGS["test-tiny"]).init_random_(0)
    orig = CLIP(CLIP_CONFIGS["test-tiny"]).init_random_(1)
    cfg = TrainConfig(attack="apgd", iterations_adv=2, grad_accum=grad_accum, warmup=1, steps=10)
    step = TrainStep(cfg, model, orig)
    size = CLIP_CONFIGS["test-tiny"].image_size
    x = torch.rand(4, 3, size, size, generator=torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU]):
        step(x, None, 7)
    log = profiling.spans()
    by_id = {s["id"]: s for s in log}
    (root,) = _by_name(log)["train.step"]
    assert root["complete"] and all(s["root"] == root["id"] for s in log)
    kids = [s["name"] for s in log if s["parent"] == root["id"]]
    chunk = ["train.frozen_embedding", "train.inner_attack", "train.outer"]
    assert kids == chunk * grad_accum + ["train.optimizer"]
    attacks = _by_name(log)["apgd.attack"]
    assert len(attacks) == grad_accum
    assert all(by_id[a["parent"]]["name"] == "train.inner_attack" for a in attacks)
    assert len(_by_name(log)["apgd.iter"]) == 2 * grad_accum


@pytest.mark.cuda
def test_spans_leave_no_cuda_event_on_the_device_timeline(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the span's device interval and the kernels' trace")
    dev = torch.device("cuda")
    x = torch.rand(8, 3, 4, 4, device=dev)
    y = torch.arange(8, device=dev) % 5
    model = _linear(device=dev)
    names = ("apgd.attack", "apgd.iter", "apgd.forward", "apgd.backward", "apgd.update")

    def cuda_events():
        _apgd(model, x, y, 2)  # warm-up: the kernel build and the allocator
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _apgd(model, x, y, 2)
            torch.cuda.synchronize()
        return [e for e in prof.events() if "CUDA" in str(e.device_type)]

    spanned = cuda_events()
    log = profiling.spans()
    assert {s["name"] for s in log} == set(names)
    assert all(s["device_ms"] is not None and s["device_ms"] >= 0 for s in log)
    monkeypatch.setattr(apgd_mod, "span", lambda name: profiling._OFF)
    plain = cuda_events()
    assert len(spanned) == len(plain) > 0
    assert not [e for e in spanned if e.name in names or e.is_user_annotation]
