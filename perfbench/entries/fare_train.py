"""FARE fine-tuning of CLIP's vision tower: the training step.

The program under test is the port's `train.trainer.TrainStep`, built as
`train/driver.py` builds it (the model, a deep copy of it as the frozen
original, the traffic file's `TrainConfig`) and called as the driver calls
it, `step(x, y, fold_in(1, step))`; no checkpoint saves and no mid-run
eval. Set-up drives that one object through its first steps (three), on
fresh rows each, then hands it to the window. A unit is one step on a fresh
batch; its work is the batch's images.

The check, after the window, against `reference/fare.py` in float32, which
follows the first two steps at the program's adversarial images from the
same initial weights (made again from the seed):
- `loss_gap`: the widest relative gap of a step's loss;
- `grad_gap`: over the leaves, the widest gap between the norm of the first
  gradient as the optimizer got it (its first moment after one step, over
  1 - beta1) and the reference's, against the larger of the reference
  leaf's norm and the median leaf's;
- `change_gap`: the same for the weights' change over the two steps, over
  the entries whose reference gradient is at least a thousandth of the
  median leaf's root mean square (the others, as a key's bias under
  softmax inside the fused q|k|v bias, move under Adam by round-off alone);
- `inner_weakness`: the first step's inner loss gain at a random corner of
  the eps-ball over the gain at the program's adversarial images.
The adversarial images stay in their ball to 3e-8 on every seed read; no
fault of this cell moves them out, so that is not compared here (the attack
cells compare it).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from harness import faults, models, traffic, weights
from harness.traffic import fold
from reference import fare as R
from reference.common import full_fp32

# the faults a cell of this entry can have, planted by the tests and `calibrate.py --faults`
# (one chip: no exchange between chips to leave out)
FAULTS = (faults.step_unchanged, faults.train_half_batch, faults.optimizer_unchanged, faults.loss_altered)


class Cell:
    rate_metric = "train_imgs_per_s"

    def __init__(self, run):
        self.run = run
        self.cfg, self.tr = run.config, run.traffic
        self.dev = run.device
        self.train = self.tr["train"]
        self.batch = int(self.tr["images"]["batch"])
        self.attempted = self.failed = 0
        self.traced_steps = 0

    def _images(self, step: int):
        return traffic.images(self.tr["images"], self.run.seed, step, self.dev)

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        from robustvlm_tpu_torch.attacks.apgd import fold_in
        from robustvlm_tpu_torch.device import use_full_fp32
        from robustvlm_tpu_torch.train.trainer import TrainConfig, TrainStep

        use_full_fp32()
        self.fold_in = fold_in
        t = self.train
        tcfg = TrainConfig(loss=t["loss"], inner_loss=t["inner_loss"], attack=t["attack"], norm=t["norm"],
                           eps=t["eps_255"] / 255.0, iterations_adv=int(t["iterations_adv"]), opt=t["opt"],
                           lr=t["lr"], wd=t["wd"], warmup=int(t["warmup"]), steps=int(t["steps"]),
                           compute_dtype=t["compute_dtype"], remat=bool(t["remat"]),
                           grad_accum=int(t["grad_accum"]))
        self.eps = tcfg.eps
        model = models.build_clip(self.cfg, weights.make(self.specs(), self.run.seed, self.dev))
        self.step = TrainStep(tcfg, model, copy.deepcopy(model))
        self.n = 0
        self.setup_record()

    def specs(self):
        return models.clip_specs(self.cfg, torch.float32)

    def setup_record(self) -> None:
        """The first steps, through the window's own call, with what the
        check needs read on the way: each step's adversarial images and
        loss, the first gradient from the optimizer's state, the change
        after the steps the reference follows."""
        step = self.step
        orig = step.inner_attack
        self.x_advs, self.losses = [], []

        def record(*a, **k):
            out = orig(*a, **k)
            self.x_advs.append(out.detach().clone())
            return out

        step.inner_attack = record
        follow = int(self.tr["reference_steps"])
        params = step.optimizer.params
        orig_params = list(step.model_orig.parameters())
        try:
            for i in range(int(self.tr["setup_steps"])):
                metrics = self._step()
                self.losses.append(float(metrics["loss"]))
                if i == 0:
                    self.grad_norms = [first_gradient_norm(step.optimizer.opt, p) for p in params]
                if i + 1 == follow:  # kept on the host, out of the window's memory
                    self.changes = [(p.detach() - q).cpu() for p, q in zip(params, orig_params)]
        finally:
            del step.inner_attack
        self.names = [n for n, _ in step.model.named_parameters()]
        self.x_advs = self.x_advs[:follow]
        self.losses = self.losses[:follow]

    def _step(self):
        x = self._images(self.n)
        metrics = self.step(x, None, self.fold_in(1, self.n))
        self.n += 1
        return metrics

    def unit(self, i: int) -> float:
        tracer = self.run.tracer
        if i == 0:
            tracer.start()
        self._step()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        if tracer.open:
            tracer.stop()
            self.traced_steps += 1
        self.attempted += self.batch
        return float(self.batch)

    def layer_ctx(self) -> dict:
        c = self.run.counts
        return {"traced_steps": self.traced_steps,
                "traced_flops": self.traced_steps * c.fare_step_flops(self.cfg, self.batch,
                                                                     int(self.train["iterations_adv"])),
                "attention": {"vit": c.vit_attention_launch_counts(self.cfg, self.batch,
                                                                   self.train["compute_dtype"])}}

    def release(self) -> None:
        del self.step
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def check(self, limits: dict) -> list:
        from harness.core import reading

        full_fp32()
        r = self.readings()
        return [reading(k, r[k], float(limits[k])) for k in ("loss_gap", "grad_gap", "change_gap", "inner_weakness")]

    def _inputs(self):
        xs = [self._images(i) for i in range(len(self.x_advs))]
        advs = []
        for x, xa in zip(xs, self.x_advs):  # rows the program left unattacked stay clean
            advs.append(torch.cat([xa, x[xa.shape[0]:]]) if xa.shape[0] < x.shape[0] else xa)
        return xs, advs

    def readings(self, candidate=None) -> dict:
        """The compared numbers with the program's readings, or with the
        reference in `candidate`'s precision (the control) in their place."""
        w0 = weights.make(self.specs(), self.run.seed, self.dev)
        xs, advs = self._inputs()
        ref = R.follow(w0, self.cfg, self.train, xs, advs, "float32")
        ref_grad_norms = {k: float(g.norm()) for k, g in ref["grads"].items()}
        if candidate is None:
            losses, grad_norms = self.losses, dict(zip(self.names, self.grad_norms))
            changes = {k: c.to(self.dev) for k, c in zip(self.names, self.changes)}
        else:
            got = R.follow(w0, self.cfg, self.train, xs, advs, candidate)
            losses, changes = got["losses"], got["change"]
            grad_norms = {k: float(g.norm()) for k, g in got["grads"].items()}
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, ref["losses"]))
        grad_gap = _leaf_gap(grad_norms, ref_grad_norms)
        change_gap = _change_gap(changes, ref["change"], ref["grads"])
        gen = traffic.generator(fold(self.run.seed, 41), self.dev)
        x1 = xs[0]
        corner = (x1 + self.eps * torch.where(torch.rand(x1.shape, generator=gen, device=self.dev) < 0.5,
                                              -1.0, 1.0)).clamp(0, 1)
        gain_adv = R.inner_gain(w0, self.cfg, x1, advs[0])
        gain_rand = R.inner_gain(w0, self.cfg, x1, corner)
        inner_weakness = min(gain_rand / max(gain_adv, 1e-30), 1e6)
        return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
                "inner_weakness": inner_weakness}

    def control(self):
        return "fp8"

    def fresh(self) -> None:
        """Calibration: the next unit is a fresh object's first steps."""
        self.setup()

    def freeze(self) -> None:
        pass


def first_gradient_norm(opt, p) -> float:
    """The norm of the gradient AdamW got at its first step, from its first
    moment (1 - beta1) g; 0 where it holds no state for p."""
    m = opt.state.get(p, {}).get("exp_avg")
    return 0.0 if m is None else float(m.norm()) / (1.0 - opt.defaults["betas"][0])


def _leaf_gap(got: dict, ref: dict) -> float:
    """Over the leaves, the widest |got - ref| against the larger of the
    reference leaf's value and the median leaf's."""
    med = float(np.median(list(ref.values())))
    return max(abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref)


def _change_gap(got: dict, ref: dict, ref_grads: dict) -> float:
    """`_leaf_gap` of the changes' norms, each taken over the entries whose
    reference gradient is at least 1e-3 of the median leaf's root mean
    square."""
    rms = [float(g.norm()) / g.numel() ** 0.5 for g in ref_grads.values()]
    floor = 1e-3 * float(np.median(rms))
    got_n, ref_n = {}, {}
    for k, g in ref_grads.items():
        moved = g.abs() >= floor
        if bool(moved.any()):
            got_n[k], ref_n[k] = float(got[k][moved].norm()), float(ref[k][moved].norm())
    return _leaf_gap(got_n, ref_n)
