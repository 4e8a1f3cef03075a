"""The span readers' arithmetic on a made-up span log: complete spans only,
division by the complete iterations or steps, and None with no spans."""

import pytest

from harness import registry, spans


def sp(i, name, parent, ms, complete=True, root=None):
    return {"id": i, "name": name, "parent": parent, "root": root, "complete": complete, "device_ms": ms}


# three APGD iterations: the first straddles the window's start (its
# enclosing iteration was never recorded), 2 and 6 are complete, 10 straddles
# the stop; 6 is the forward-only last one
APGD = [
    sp(1, "apgd.update", None, 0.5), sp(2, "apgd.iter", None, 300.0),
    sp(3, "apgd.update", 2, 0.4), sp(4, "apgd.forward", 2, 100.0), sp(5, "apgd.backward", 2, 190.0),
    sp(7, "apgd.update", 2, 0.6),
    sp(6, "apgd.iter", None, 110.0), sp(8, "apgd.update", 6, 0.3), sp(9, "apgd.forward", 6, 99.0),
    sp(11, "apgd.update", 6, 0.7),
    sp(10, "apgd.iter", None, 50.0, complete=False), sp(12, "apgd.update", 10, 9.0),
]
TRAIN = [
    sp(1, "train.step", None, 4600.0), sp(2, "train.frozen_embedding", 1, 100.0),
    sp(3, "train.inner_attack", 1, 3800.0), sp(4, "apgd.iter", 3, 380.0), sp(5, "train.outer", 1, 650.0),
    sp(6, "train.frozen_embedding", 1, 110.0), sp(7, "train.inner_attack", 1, 3700.0),
    sp(8, "train.outer", 1, 640.0), sp(9, "train.optimizer", 1, 10.0),
    sp(10, "train.step", None, 900.0, complete=False), sp(11, "train.optimizer", 10, 99.0),
]


def read(name, log, monkeypatch):
    monkeypatch.setattr(spans, "log", lambda: log)
    return registry.metric(name).read({})


def test_apgd_readers_take_complete_iterations_only(monkeypatch):
    # (0.4 + 0.6 + 0.3 + 0.7) over iterations 2 and 6
    assert read("apgd_update_ms.attack", APGD, monkeypatch) == pytest.approx(1.0)
    assert read("apgd_update_ms.caption", APGD, monkeypatch) == pytest.approx(1.0)
    # one complete iteration took a gradient
    assert read("pixel_backward_ms.attack", APGD, monkeypatch) == pytest.approx(190.0)


def test_train_readers_divide_by_complete_steps(monkeypatch):
    # two chunks (grad_accum 2) in one complete step; the straddling step is left out
    assert read("inner_attack_ms.train", TRAIN, monkeypatch) == pytest.approx(7500.0)
    assert read("frozen_embedding_ms.train", TRAIN, monkeypatch) == pytest.approx(210.0)
    assert read("outer_backward_ms.train", TRAIN, monkeypatch) == pytest.approx(1290.0)
    assert read("optimizer_ms.train", TRAIN, monkeypatch) == pytest.approx(10.0)
    steps = TRAIN[:2] + [dict(TRAIN[0], id=20), sp(21, "train.frozen_embedding", 20, 50.0)]
    assert read("frozen_embedding_ms.train", steps, monkeypatch) == pytest.approx(75.0)


@pytest.mark.parametrize("name", ["apgd_update_ms.attack", "apgd_update_ms.caption", "pixel_backward_ms.attack",
                                  "inner_attack_ms.train", "outer_backward_ms.train",
                                  "frozen_embedding_ms.train", "optimizer_ms.train"])
def test_no_number_without_spans(name, monkeypatch):
    assert read(name, [], monkeypatch) is None
    # only incomplete wholes, or no device interval (a CPU run)
    assert read(name, [dict(s, complete=False) for s in APGD + TRAIN], monkeypatch) is None
    assert read(name, [dict(s, device_ms=None) for s in APGD + TRAIN], monkeypatch) is None


def test_the_log_is_empty_without_a_window():
    from robustvlm_tpu_torch.utils import profiling

    profiling.reset()
    assert spans.log() == []
