"""The robust-accuracy eval's hot loop: APGD on a zero-shot CLIP.

The program under test is the port's `attacks.apgd.apgd_restarts` (one
restart: `apgd_attack` from a random start), as the AutoAttack cascade of
`eval/robustbench.py` runs APGD-CE on one attack chunk, over the logits
module `eval/classifier.make_zero_shot_classifier` builds, with the tower
held as the CLI holds it under bf16 (matrices bf16, 1-D parameters
float32). The zero-shot head is 1000 random unit columns at logit scale
100, as `scripts/bench_torch.py` makes it. A unit is one chunk of fresh
images: their clean predictions (the labels), then the attack. Its work
is chunk x iterations example-steps.

The check, after the window, against `reference/clip.py` in float32:
- `logit_gap`: the widest gap between the program's logits and the
  reference's at the last iterate whose gradient the program took;
- `grad_gap`: the widest relative l2 gap of that iterate's pixel gradient,
  per example;
- `robust_share`: the share of the window's examples that the reference
  still gives their label at the program's adversarial image;
- `ball_excess`: how far any adversarial image leaves the eps-ball or [0, 1].
"""

from __future__ import annotations

import torch

from harness import faults, models, traffic, weights
from harness.probe import Probe
from harness.traffic import fold
from reference import clip as R
from reference.common import full_fp32

ROWS = 32  # the reference's block of rows

# the faults a cell of this entry can have, planted by the tests and `calibrate.py --faults`
# (one chip: no exchange between chips to leave out)
FAULTS = (faults.step_unchanged, faults.half_batch, faults.answer_altered)


class Cell:
    rate_metric = "attack_steps_per_s"

    def __init__(self, run):
        self.run = run
        self.cfg, self.tr = run.config, run.traffic
        self.dev = run.device
        self.attack = self.tr["attack"]
        self.eps = self.attack["eps_255"] / 255.0
        self.n_iter = int(self.attack["n_iter"])
        self.batch = int(self.tr["images"]["batch"])
        self.attempted = self.failed = 0
        self.kept = []

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        from robustvlm_tpu_torch.device import use_full_fp32
        from robustvlm_tpu_torch.eval.classifier import make_zero_shot_classifier

        use_full_fp32()
        seed = self.run.seed
        self.state = weights.make(models.clip_specs(self.cfg, torch.bfloat16), seed, self.dev)
        model = models.build_clip(self.cfg, self.state)
        a = self.cfg["assumed"]
        gen = traffic.generator(fold(seed, 7), self.dev)
        head = torch.randn(self.cfg["embed_dim"], a["zero_shot_classes"], generator=gen, device=self.dev)
        self.head = head / head.norm(dim=0, keepdim=True)
        self.scale = float(a["logit_scale"])
        logits_fn = make_zero_shot_classifier(model, self.head, logit_scale=self.scale,
                                              compute_dtype=torch.bfloat16)
        t = self.tr.get("trace", {})
        self.probe = Probe(logits_fn, self.run.tracer, int(t.get("first_call", 0)), int(t.get("calls", 1)))
        # warm-up at the cell's shapes: kernel builds, the allocator, cuBLAS
        self._attack(traffic.images(self.tr["images"], fold(seed, 99), 0, self.dev), fold(seed, 98), 3)
        self.probe.last = {}

    def _attack(self, x, rng: int, n_iter: int):
        from robustvlm_tpu_torch.attacks.apgd import apgd_restarts
        from robustvlm_tpu_torch.ops.losses import ce_loss

        with torch.no_grad():
            y = self.probe.fn(x).argmax(dim=-1)
        res = apgd_restarts(self.probe, x, y, criterion=lambda o, t: ce_loss(o, t, reduction="none"),
                            eps=self.eps, n_iter=n_iter, norm=self.attack["norm"],
                            n_restarts=int(self.attack["restarts"]),
                            use_rs=bool(self.attack["random_start"]), rng=rng)
        return y, res

    def unit(self, i: int) -> float:
        x = traffic.images(self.tr["images"], self.run.seed, i, self.dev)
        self.probe.begin_unit(i)
        y, res = self._attack(x, fold(self.run.seed, 10_000 + i), self.n_iter)
        self.probe.close()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.kept.append({"unit": i, "y": y, "x_adv": res.x_best_adv.detach()})
        self.attempted += x.shape[0]
        return float(x.shape[0] * self.n_iter)

    def layer_ctx(self) -> dict:
        c = self.run.counts
        traced = self.probe.traced_calls
        return {"traced_calls": traced,
                "traced_flops": traced * c.apgd_iteration_flops(self.cfg, self.batch,
                                                               self.cfg["assumed"]["zero_shot_classes"]),
                "attention": {"vit": c.vit_attention_launch_counts(self.cfg, self.batch, "bfloat16")}}

    def fresh(self) -> None:
        """Forget the units run so far (calibration runs several in one process)."""
        self.kept, self.probe.last = [], {}

    def freeze(self) -> None:
        """Keep the last pixel-gradient call for the check."""
        self.last = self.probe.last

    def release(self) -> None:
        self.freeze()
        del self.probe
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def check(self, limits: dict) -> list:
        from harness.core import reading

        full_fp32()
        gaps = self.readings()
        return [reading(k, gaps[k], float(limits[k])) for k in ("logit_gap", "grad_gap", "robust_share",
                                                                 "ball_excess")]

    def readings(self, candidate=None) -> dict:
        """The compared numbers with the program's outputs, or with
        `candidate(x, y) -> (logits, grad)` (the control) in the program's
        place for the two gaps."""
        w, cfg = self.state, self.cfg
        last = self.last
        x_k, y_k = last["x"], self.kept[-1]["y"]
        logit_gap, grad_gap = 0.0, 0.0
        for s in range(0, x_k.shape[0], ROWS):
            xs, ys = x_k[s:s + ROWS], y_k[s:s + ROWS]
            ref_logits, ref_grad = logits_and_grad(w, cfg, self.head, self.scale, xs, ys, "float32")
            if candidate is None:
                got_logits, got_grad = last["out"][s:s + ROWS].float(), last["grad"][s:s + ROWS].float()
            else:
                got_logits, got_grad = candidate(xs, ys)
            logit_gap = max(logit_gap, float((got_logits - ref_logits).abs().max()))
            num = (got_grad - ref_grad).flatten(1).norm(dim=1)
            den = ref_grad.flatten(1).norm(dim=1).clamp_min(1e-30)
            grad_gap = max(grad_gap, float((num / den).max()))
        robust, total, excess = 0, 0, 0.0
        with torch.no_grad():
            for k in self.kept:
                x = traffic.images(self.tr["images"], self.run.seed, k["unit"], self.dev)
                xa = k["x_adv"]
                excess = max(excess, float(((xa - x).abs() - self.eps).max()),
                             float((-xa).max()), float((xa - 1.0).max()))
                for s in range(0, x.shape[0], ROWS):
                    lg = R.zero_shot_logits(w, cfg, self.head, self.scale, xa[s:s + ROWS])
                    robust += int((lg.argmax(dim=-1) == k["y"][s:s + ROWS]).sum())
                total += x.shape[0]
        return {"logit_gap": logit_gap, "grad_gap": grad_gap, "robust_share": robust / total,
                "ball_excess": max(excess, 0.0)}

    def control(self):
        """The reference in fp8, put in the program's place."""
        w, cfg = self.state, self.cfg
        return lambda xs, ys: logits_and_grad(w, cfg, self.head, self.scale, xs, ys, "fp8")


def logits_and_grad(w, cfg, head, scale, x, y, precision: str):
    """The reference's logits at x and the pixel gradient of the summed CE."""
    xg = x.detach().float().requires_grad_(True)
    with torch.enable_grad():
        logits = R.zero_shot_logits(w, cfg, head, scale, xg, precision)
        (g,) = torch.autograd.grad(R.ce(logits, y).sum(), xg)
    return logits.detach(), g
