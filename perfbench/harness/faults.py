"""Faults planted in the program underneath a run, to show that the check
catches them (`calibrate.py` reads them on the card, `tests/` at a small
size on the CPU). Each is a context manager that patches the port's
module where the timed path looks the function up, and restores it.

- `step_unchanged`: the l-inf APGD step returns its state unchanged;
- `half_batch`: the attack (or the training step) works on the first half
  of its batch only and leaves the rest as it came;
- `answer_altered`: the attack's answer is altered where it is produced
  (one adversarial image moved off its ball);
- `caption_altered`: the first served token of every caption changed;
- `optimizer_unchanged`: the optimizer's step leaves the weights as they were;
- `loss_altered`: the training step's reported loss is off by a tenth.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name: str, value):
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
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


@contextlib.contextmanager
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


@contextlib.contextmanager
def answer_altered():
    with _wrap_attack(_altered):
        yield


@contextlib.contextmanager
def caption_altered():
    from robustvlm_tpu_torch.vlm_eval import eval_models

    orig = eval_models.FlamingoEvalModel.get_outputs

    def alter(caption: str) -> str:
        words = caption.split(" ")
        words[0] = "tok3" if words[0] != "tok3" else "tok4"
        return " ".join(words)

    def get_outputs(self, *a, **k):
        return [alter(c) for c in orig(self, *a, **k)]

    with _patched(eval_models.FlamingoEvalModel, "get_outputs", get_outputs):
        yield


@contextlib.contextmanager
def optimizer_unchanged():
    from robustvlm_tpu_torch.train import trainer

    with _patched(trainer.ScheduledOptimizer, "step", lambda self: None):
        yield


@contextlib.contextmanager
def train_half_batch():
    from robustvlm_tpu_torch.train import trainer

    orig = trainer.TrainStep.chunk_grads

    def chunk_grads(self, x, y, seed):
        h = x.shape[0] // 2
        return orig(self, x[:h], None if y is None else y[:h], seed)

    with _patched(trainer.TrainStep, "chunk_grads", chunk_grads):
        yield


@contextlib.contextmanager
def loss_altered():
    from robustvlm_tpu_torch.train import trainer

    orig = trainer.TrainStep.__call__

    def call(self, x, y, seed):
        m = orig(self, x, y, seed)
        return dict(m, loss=m["loss"] * 1.1)

    with _patched(trainer.TrainStep, "__call__", call):
        yield


FAULTS = {
    "step_unchanged": step_unchanged,
    "half_batch": half_batch,
    "answer_altered": answer_altered,
    "caption_altered": caption_altered,
    "optimizer_unchanged": optimizer_unchanged,
    "train_half_batch": train_half_batch,
    "loss_altered": loss_altered,
}
