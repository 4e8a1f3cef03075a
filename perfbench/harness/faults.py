"""Faults planted in the program underneath a run, to show that the check
catches them (`calibrate.py` reads them on the card, `tests/` at a small
size on the CPU). Each is a context manager that patches the port's
module where the timed path looks the function up, and restores it.

- `step_unchanged`: the l-inf APGD step returns its state unchanged;
- `half_batch`: the attack (or the training step) works on the first half
  of its batch only and leaves the rest as it came;
- `answer_altered`: the attack's answer is altered where it is produced
  (one adversarial image moved off its ball);
- `caption_altered`: the first served token of every caption changed, on
  whichever adapter of `vlm_eval.eval_models` the runner captions with;
- `optimizer_unchanged`: the optimizer's step leaves the weights as they were;
- `loss_altered`: the training step's reported loss is off by a tenth.

Each is made by `fault(...)`, which names the check numbers it moves at
the small size (`caught_by`). An entry declares the faults its cells can
have in its `FAULTS`: these, or one defined by `fault` in its own file;
`declared(entry)` gives them by name.
"""

from __future__ import annotations

import contextlib
from types import ModuleType

import torch


def fault(*caught_by: str):
    """A fault: `fn`, a generator that patches the program around its
    `yield`, made a context manager that names the numbers it moves."""
    def make(fn):
        planted = contextlib.contextmanager(fn)
        planted.caught_by = caught_by
        return planted

    return make


def declared(entry: ModuleType) -> dict:
    """The faults an entry module declares in its `FAULTS`, by name."""
    return {f.__name__: f for f in entry.FAULTS}


@contextlib.contextmanager
def _patched(module, name: str, value):
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


@fault("robust_share", "attack_shortfall", "inner_weakness")
def step_unchanged():
    from robustvlm_tpu_torch.attacks import apgd

    with _patched(apgd, "fused_linf_apgd_step", lambda x_adv, *a, **k: x_adv):
        yield


def _attack_modules():
    from robustvlm_tpu_torch.attacks import apgd
    from robustvlm_tpu_torch.train import trainer
    from robustvlm_tpu_torch.vlm_eval import ensemble

    return apgd, ensemble, trainer


@contextlib.contextmanager
def _wrap_attack(wrap):
    """Every caller's `apgd_attack` (APGD's restarts, the ensemble runner,
    the trainer) replaced by `wrap(orig)`."""
    mods = _attack_modules()
    orig = mods[0].apgd_attack
    with contextlib.ExitStack() as stack:
        for m in mods:
            stack.enter_context(_patched(m, "apgd_attack", wrap(orig)))
        yield


def _half(orig):
    def attack(model_fn, x, y=None, **kw):
        h = x.shape[0] // 2
        if kw.get("x_init") is not None:
            kw["x_init"] = kw["x_init"][:h]
        if kw.get("mask") is not None and kw["mask"].shape[0] == x.shape[0]:
            kw["mask"] = kw["mask"][:h]

        def first_half(xa):
            return model_fn(torch.cat([xa, x[h:]]))[:h]

        res = orig(first_half, x[:h], None if y is None else y[:h], **kw)
        rest = x[h:]
        keep = torch.ones(x.shape[0] - h, dtype=torch.bool, device=x.device)
        return type(res)(torch.cat([res.x_best, rest]), torch.cat([res.x_best_adv, rest]),
                         torch.cat([res.loss_best, res.loss_best.new_zeros(x.shape[0] - h)]),
                         torch.cat([res.acc, keep]))

    return attack


@fault("robust_share", "attack_shortfall")
def half_batch():
    with _wrap_attack(_half):
        yield


def _altered(orig):
    def attack(model_fn, x, y=None, **kw):
        res = orig(model_fn, x, y, **kw)
        eps = kw["eps"]
        moved = res.x_best.clone()
        moved[0] = (x[0] + 2 * eps * torch.where(x[0] < 0.5, 1.0, -1.0)).clamp(0, 1)
        moved_adv = res.x_best_adv.clone()
        moved_adv[0] = moved[0]
        return type(res)(moved, moved_adv, res.loss_best, res.acc)

    return attack


@fault("ball_excess")
def answer_altered():
    with _wrap_attack(_altered):
        yield


def _captioning_adapters(eval_models) -> list:
    """Every class of `vlm_eval.eval_models` with a `get_outputs` of its
    own: the adapters the ensemble runner captions with."""
    return [c for c in vars(eval_models).values()
            if isinstance(c, type) and c.__module__ == eval_models.__name__ and "get_outputs" in vars(c)]


def _altered_outputs(orig):
    def get_outputs(self, *a, **k):
        other, again = self.tok.decode([3]), self.tok.decode([4])
        out = []
        for caption in orig(self, *a, **k):
            words = caption.split(" ")
            words[0] = other if words[0] != other else again
            out.append(" ".join(words))
        return out

    return get_outputs


@fault("token_gap_mean")
def caption_altered():
    from robustvlm_tpu_torch.vlm_eval import eval_models

    with contextlib.ExitStack() as stack:
        for cls in _captioning_adapters(eval_models):
            stack.enter_context(_patched(cls, "get_outputs", _altered_outputs(cls.get_outputs)))
        yield


@fault("change_gap")
def optimizer_unchanged():
    from robustvlm_tpu_torch.train import trainer

    with _patched(trainer.ScheduledOptimizer, "step", lambda self: None):
        yield


@fault("loss_gap", "grad_gap")
def train_half_batch():
    from robustvlm_tpu_torch.train import trainer

    orig = trainer.TrainStep.chunk_grads

    def chunk_grads(self, x, y, seed):
        h = x.shape[0] // 2
        return orig(self, x[:h], None if y is None else y[:h], seed)

    with _patched(trainer.TrainStep, "chunk_grads", chunk_grads):
        yield


@fault("loss_gap")
def loss_altered():
    from robustvlm_tpu_torch.train import trainer

    orig = trainer.TrainStep.__call__

    def call(self, x, y, seed):
        m = orig(self, x, y, seed)
        return dict(m, loss=m["loss"] * 1.1)

    with _patched(trainer.TrainStep, "__call__", call):
        yield

