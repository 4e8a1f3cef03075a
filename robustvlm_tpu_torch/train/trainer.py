"""Adversarial fine-tuning of the CLIP vision encoder (TeCoA / FARE).

Counterpart of `robustvlm_tpu/train/trainer.py`. One step, per chunk of
the batch: the frozen original's embedding (no gradients), the inner
attack on the current model with respect to the pixels only (PGD, APGD or
none; FARE: squared l2 to the frozen embedding, TeCoA: cross-entropy
against the class-text embeddings at logit scale 100), the clean and
adversarial outer forwards, the outer loss (`clean_weight` mixing, TRADES)
and its backward into the weights; then one AdamW or SGD update at the
cosine-warmup learning rate. Under a profiler window (`utils/profiling.span`)
a step is a `train.step` span with `train.frozen_embedding`,
`train.inner_attack` (the attack's `apgd.*` spans inside) and `train.outer`
children a chunk, then `train.optimizer` (the all-reduce, if any, and the
update).

Differences from the JAX step that change no result:
- The model is an `nn.Module` updated in place: `TrainStep` (JAX's
  `make_train_step`) holds the model, the frozen original and the optimizer;
  calling it with `(x, y, seed)` runs one step and returns its metrics.
- `grad_accum` is a loop over equal chunks whose backward passes add into
  `.grad`, divided by the chunk count before the update: the mean of the
  chunk means, as the JAX scan computes it.
- The clean forward keeps no autograd graph unless `clean_weight > 0` (the
  only case in which the loss depends on it).
- Random starts draw from `torch.Generator`s seeded with integers: step
  seed `fold_in(1, step)`, chunk `i`'s `fold_in(seed, i)`, where JAX folds
  and splits PRNG keys.
- Data parallel (`mesh` over a process group): each rank holds its rows of
  every chunk (`parallel/mesh.batch_sharding(..., chunks=grad_accum)`),
  PGD's random start is drawn at the global chunk's shape and sliced to the
  rank's rows, the gradients are averaged by one all-reduce after the chunk
  loop and the metrics by another: the step computes what the
  single-process step computes on the global batch, as JAX's replicated
  parameters with a sharded batch do. FSDP-sharded parameters
  (`shard_params`) are reduced by FSDP itself, and the forwards go through
  `sharded_call`. On a CLIP split over `model` (Megatron heads) each rank
  holds its share of the split parameters and their gradients; every
  gradient is reduced over the batch peers only (ranks of one `model`
  index), since the `model` peers of a replicated parameter already agree.

Like JAX, the optimizer holds every parameter of the CLIP model, text tower
and `logit_scale` included: their gradients are zero, and AdamW's decoupled
decay still shrinks them each step (the upstream trains the vision tower
alone; ROADMAP §C).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch

from robustvlm_tpu_torch.attacks.apgd import apgd_attack, fold_in
from robustvlm_tpu_torch.attacks.pgd import pgd_attack, pgd_random_start
from robustvlm_tpu_torch.models.clip.model import CLIP
from robustvlm_tpu_torch.ops.image import normalize_clip
from robustvlm_tpu_torch.ops.losses import ce_loss, l2_embedding_loss
from robustvlm_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_grads_,
    batch_mean,
    batch_slice,
    sharded_call,
)
from robustvlm_tpu_torch.train.schedules import cosine_warmup_lr
from robustvlm_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference training flags; eps and stepsize in image units."""

    loss: str = "l2"            # outer loss: 'l2' (FARE) or 'ce' (TeCoA)
    inner_loss: str = "l2"      # attack loss
    loss_clean: str = "none"
    clean_weight: float = 0.0
    trades: bool = False
    attack: str = "apgd"        # 'pgd' | 'apgd' | 'none'
    norm: str = "linf"
    eps: float = 4.0 / 255.0
    iterations_adv: int = 10
    stepsize_adv: float = 1.0 / 255.0  # pgd only
    opt: str = "adamw"
    lr: float = 1e-5
    wd: float = 1e-4
    momentum_sgd: float = 0.9
    warmup: int = 1400
    steps: int = 20000
    output_normalize: bool = False
    compute_dtype: str = "float32"   # 'bfloat16' for throughput
    remat: bool = False
    grad_accum: int = 1              # equal chunks, one update


class ScheduledOptimizer:
    """JAX's `make_optimizer`: `torch.optim.AdamW` or `SGD` at `cosine_warmup_lr`, evaluated at the
    count of updates done so far (optax's schedule count: 0 at the first).

    AdamW: betas (0.9, 0.999), eps 1e-8 outside the square root, decay
    lr * wd * p, as `optax.adamw`. SGD: `add_decayed_weights(wd)` then
    `sgd(momentum)` is `torch.optim.SGD(weight_decay=wd, momentum=m,
    dampening=0)`. A parameter that received no gradient steps with a zero
    one, as every leaf of the JAX tree does."""

    def __init__(self, cfg: TrainConfig, params):
        self.params = list(params)
        self.schedule = cosine_warmup_lr(cfg.lr, cfg.warmup, cfg.steps)
        if cfg.opt == "adamw":
            self.opt = torch.optim.AdamW(self.params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                         weight_decay=cfg.wd)
        elif cfg.opt == "sgd":
            self.opt = torch.optim.SGD(self.params, lr=cfg.lr, momentum=cfg.momentum_sgd,
                                       dampening=0.0, weight_decay=cfg.wd)
        else:
            raise ValueError(f"unknown optimizer: {cfg.opt}")
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            if p.grad is not None:
                p.grad.zero_()

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.count = int(state["count"])


def _compute_loss(loss_str: str, embedding, targets, embedding_orig, text_embedding,
                  reduction: str = "mean", logit_scale: float = 100.0) -> torch.Tensor:
    """The reference `compute_loss`: 'l2' (FARE) or 'ce' (TeCoA)."""
    if loss_str == "l2":
        return l2_embedding_loss(embedding, embedding_orig, reduction=reduction)
    if loss_str == "ce":
        return ce_loss(embedding @ (logit_scale * text_embedding), targets, reduction=reduction)
    raise ValueError(f"loss {loss_str} not supported")


@contextlib.contextmanager
def no_weight_grads(model: torch.nn.Module):
    """Parameters frozen inside the block (the JAX `stop_gradient` on the
    parameters): autograd then differentiates with respect to pixels only."""
    flags = [p.requires_grad for p in model.parameters()]
    model.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(model.parameters(), flags):
            p.requires_grad_(flag)


def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    an = a / (torch.linalg.norm(a, dim=-1, keepdim=True) + 1e-12)
    bn = b / (torch.linalg.norm(b, dim=-1, keepdim=True) + 1e-12)
    return (an * bn).sum(dim=-1).mean()


def _l2n(e: torch.Tensor) -> torch.Tensor:
    return e / (torch.linalg.norm(e, dim=-1, keepdim=True) + 1e-12)


class TrainStep:
    """One TeCoA/FARE training step on `model`, in place. `model_orig` is
    the frozen original (no gradients); `text_embedding` the (D, classes)
    normalized class-text matrix (TeCoA, and the racc/acc metrics). `mesh`
    (data parallel over a process group) makes the step take this rank's
    rows and return global metrics."""

    def __init__(self, cfg: TrainConfig, model: CLIP, model_orig: CLIP,
                 text_embedding: Optional[torch.Tensor] = None, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.model = model.requires_grad_(True)
        self.model_orig = model_orig.requires_grad_(False)
        self.text_embedding = text_embedding
        self.compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.optimizer = ScheduledOptimizer(cfg, model.parameters())

    def embed(self, model: CLIP, x01: torch.Tensor, output_normalize: bool) -> torch.Tensor:
        return sharded_call(model, model.encode_image, normalize_clip(x01), normalize=output_normalize,
                            compute_dtype=self.compute_dtype, remat=self.cfg.remat)

    def pgd_start(self, x: torch.Tensor, seed: int) -> torch.Tensor:
        """PGD's random start for this rank's rows `x` of a chunk: drawn at
        the global chunk's shape from `seed` and sliced to the rank's rows
        (the draw of the single-process step)."""
        mesh = self.mesh
        shards = mesh.batch_shards if mesh is not None else 1
        n = x.shape[0] * shards
        full = pgd_random_start((n, *x.shape[1:]), self.cfg.eps, seed, x.device, x.dtype)
        return full if shards == 1 else full[batch_slice(mesh, n)]

    def inner_loss(self, xa, y, emb_orig) -> torch.Tensor:
        """The batch-mean loss the inner attack maximizes, at xa (APGD always
        normalizes the embedding)."""
        normalize = True if self.cfg.attack == "apgd" else self.cfg.output_normalize
        emb = self.embed(self.model, xa, normalize)
        return _compute_loss(self.cfg.inner_loss, emb, y, emb_orig, self.text_embedding)

    def inner_attack(self, x, y, emb_orig, seed: int, perturbation=None) -> torch.Tensor:
        """The reference's pgd/apgd dispatch on the current model, weights
        frozen; returns x_adv, detached. `perturbation` overrides PGD's
        random start U(-eps, eps) drawn from `seed`."""
        cfg = self.cfg
        if cfg.attack == "none":
            return x
        with no_weight_grads(self.model):
            if cfg.attack == "pgd":
                return pgd_attack(lambda xa: self.inner_loss(xa, y, emb_orig), x, eps=cfg.eps,
                                  stepsize=cfg.stepsize_adv, iterations=cfg.iterations_adv,
                                  norm=cfg.norm, mode="max", perturbation=perturbation,
                                  random_start=True, rng=seed)
            if cfg.attack == "apgd":
                # APGD always normalizes the inner embedding (the reference's
                # apgd_train wrapper)
                def criterion(out, yy):
                    return _compute_loss(cfg.inner_loss, out, yy, emb_orig, self.text_embedding,
                                         reduction="none")

                res = apgd_attack(lambda xa: self.embed(self.model, xa, True), x,
                                  y if cfg.inner_loss == "ce" else None, criterion=criterion,
                                  eps=cfg.eps, n_iter=cfg.iterations_adv, norm=cfg.norm)
                return res.x_best_adv.detach()
        raise ValueError(f"unknown attack: {cfg.attack}")

    def frozen_embedding(self, x) -> torch.Tensor:
        with torch.no_grad():
            return self.embed(self.model_orig, x, self.cfg.output_normalize)

    def outer_loss(self, x, y, x_adv, emb_orig):
        """(total loss, metrics) of the clean and adversarial outer forwards;
        the total carries the autograd graph into the weights."""
        cfg = self.cfg
        with torch.set_grad_enabled(torch.is_grad_enabled() and cfg.clean_weight > 0.0):
            emb_clean = self.embed(self.model, x, cfg.output_normalize)
        emb_adv = self.embed(self.model, x_adv, cfg.output_normalize)
        l_clean = (_compute_loss(cfg.loss_clean, emb_clean, y, emb_orig, None)
                   if cfg.clean_weight > 0.0 else 0.0)
        # TRADES: the adversarial embedding is pulled to the current model's
        # clean one instead of the frozen original's
        anchor = emb_clean.detach() if cfg.trades else emb_orig
        l_adv = _compute_loss(cfg.loss, emb_adv, y, anchor, self.text_embedding)
        total = cfg.clean_weight * l_clean + (1.0 - cfg.clean_weight) * l_adv
        emb_adv_d, emb_clean_d = emb_adv.detach(), emb_clean.detach()
        metrics = {"loss": l_adv.detach(), "loss_total": total.detach(),
                   "cos_sim": _cos(emb_adv_d, emb_orig), "cos_sim_clean": _cos(emb_clean_d, emb_orig)}
        if self.text_embedding is not None and y is not None:
            t = self.text_embedding
            metrics["racc"] = ((_l2n(emb_adv_d) @ t).argmax(-1) == y).float().mean()
            metrics["acc"] = ((_l2n(emb_clean_d) @ t).argmax(-1) == y).float().mean()
        return total, metrics

    def chunk_grads(self, x, y, seed: int) -> Dict[str, torch.Tensor]:
        """Attack and backward for one chunk: adds its gradients into the
        weights' `.grad` and returns its metrics."""
        with span("train.frozen_embedding"):
            emb_orig = self.frozen_embedding(x)
        with span("train.inner_attack"):
            start = self.pgd_start(x, seed) if self.cfg.attack == "pgd" else None
            x_adv = self.inner_attack(x, y, emb_orig, seed, perturbation=start).detach()
        with span("train.outer"):
            total, metrics = self.outer_loss(x, y, x_adv, emb_orig)
            total.backward()
        return metrics

    def __call__(self, x, y, seed: int) -> Dict[str, torch.Tensor]:
        with span("train.step"):
            k = self.cfg.grad_accum
            self.optimizer.zero_grad()
            if k <= 1:
                metrics = self.chunk_grads(x, y, seed)
            else:
                b = x.shape[0]
                if b % k:
                    raise ValueError(f"batch {b} not divisible by grad_accum {k}")
                xs = x.reshape(k, b // k, *x.shape[1:])
                ys = None if y is None else y.reshape(k, b // k)
                metrics = None
                for i in range(k):
                    m = self.chunk_grads(xs[i], None if ys is None else ys[i], fold_in(seed, i))
                    metrics = m if metrics is None else {n: metrics[n] + m[n] for n in m}
                # equal chunks: the mean of the chunk means is the batch mean
                metrics = {n: v / k for n, v in metrics.items()}
                for p in self.optimizer.params:
                    if p.grad is not None:
                        p.grad.div_(k)
            with span("train.optimizer"):
                if self.mesh is not None:
                    all_reduce_grads_(self.optimizer.params, self.mesh)
                    metrics = batch_mean(metrics, self.mesh)
                self.optimizer.step()
            return metrics


def make_eval_step(cfg: TrainConfig, model: CLIP, text_embedding: torch.Tensor,
                   n_iter: int = 50, initial_stepsize: Optional[float] = None):
    """The periodic supervised APGD-50 check: fn(x, y) -> {eval/racc,
    eval/acc, eval/cos_sim} on a validation batch, in float32 with
    normalized embeddings and logits 100 * e @ T."""

    def encode(xa):
        return model.encode_image(normalize_clip(xa), normalize=True)

    def eval_step(x, y) -> Dict[str, torch.Tensor]:
        with no_weight_grads(model):
            res = apgd_attack(lambda xa: encode(xa) @ (100.0 * text_embedding), x, y,
                              criterion=lambda o, yy: ce_loss(o, yy, reduction="none"),
                              eps=cfg.eps, n_iter=n_iter, norm=cfg.norm,
                              initial_stepsize=initial_stepsize)
            with torch.no_grad():
                emb_adv = encode(res.x_best_adv)
                emb = encode(x)
        return {"eval/racc": ((emb_adv @ text_embedding).argmax(-1) == y).float().mean(),
                "eval/acc": ((emb @ text_embedding).argmax(-1) == y).float().mean(),
                "eval/cos_sim": (emb_adv * emb).sum(dim=-1).mean()}

    return eval_step
