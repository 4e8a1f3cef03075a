"""AutoAttack orchestrator: run an attack cascade over still-robust examples.

Counterpart of `robustvlm_tpu/eval/autoattack.py` (`AutoAttackTPU`): the
versions `standard`, `plus`, `rand` and `custom` with their presets; the
stages apgd-ce, apgd-dlr, apgd-t, fab, fab-t and square in the l-inf, l2
and l1 norms (l1 runs APGD through the decr-eps schedule by default); EOT
(`eot_iter`, `model_rng_fn`); the robust-flags bookkeeping (an example is
attacked by a later stage only while it is still classified correctly),
per-attack robust accuracy, resumable `EvaluationState`, and the pre-run
sanity checks, with the Square-vs-white-box check after the cascade.

The data stays on the host; each attack batch is moved to the model's
device: `cuda` unless the caller passes `device="cpu"` (without a GPU the
constructor raises, as every entry point of the port does). PyTorch runs
eagerly, so batches are not padded to one static shape. Seeds follow the
JAX package's integers: the attack's base seed is
`seed + crc32(attack) % 2**16`, folded with the batch start, the target
class (APGD-T) and the restart (`attacks.apgd.fold_in`).
"""

from __future__ import annotations

import logging
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from robustvlm_tpu_torch.attacks.apgd import apgd_restarts, fold_in
from robustvlm_tpu_torch.attacks.fab import fab_attack
from robustvlm_tpu_torch.attacks.square import square_attack_l1, square_attack_l2, square_attack_linf
from robustvlm_tpu_torch.device import resolve_device
from robustvlm_tpu_torch.eval import checks
from robustvlm_tpu_torch.eval.state import EvaluationState
from robustvlm_tpu_torch.ops.losses import ce_loss, dlr_loss, dlr_loss_targeted
from robustvlm_tpu_torch.ops.projections import canonical_norm

log = logging.getLogger("robustvlm_tpu_torch.autoattack")

VERSIONS = {
    "standard": ["apgd-ce", "apgd-t", "fab-t", "square"],
    "plus": ["apgd-ce", "apgd-dlr", "fab", "square", "apgd-t", "fab-t"],
    "rand": ["apgd-ce", "apgd-dlr"],
    "custom": None,
}
ATTACKS = ("apgd-ce", "apgd-dlr", "apgd-t", "fab", "fab-t", "square")
SQUARE = {"linf": square_attack_linf, "l2": square_attack_l2, "l1": square_attack_l1}


def _ce_criterion(o, yy):
    return ce_loss(o, yy, reduction="none")


class AutoAttack:
    def __init__(
        self,
        logits_fn,
        *,
        norm: str = "linf",
        eps: float,
        seed: int = 0,
        version: str = "custom",
        attacks_to_run: Optional[Sequence[str]] = None,
        n_iter: int = 100,
        n_restarts: int = 1,
        n_target_classes: int = 9,
        square_n_queries: int = 5000,
        alpha: Optional[float] = None,
        use_rs: bool = True,
        use_largereps: Optional[bool] = None,
        verbose: bool = True,
        eot_iter: int = 1,
        model_rng_fn: Optional[Callable] = None,
        device=None,
    ):
        """`model_rng_fn(x, seed)` runs a randomized model with an integer
        seed (see `attacks.apgd.eot_loss_grad`)."""
        norm = canonical_norm(norm)
        if norm not in SQUARE:
            raise ValueError(f"AutoAttack: unsupported norm {norm}")
        if version not in VERSIONS:
            raise ValueError(f"unknown AutoAttack version {version!r}")
        self.logits_fn = logits_fn
        self.norm = norm
        self.eps = eps
        self.seed = seed
        self.n_iter = n_iter
        self.n_restarts = n_restarts
        self.n_target_classes = n_target_classes
        self.square_n_queries = square_n_queries
        self.alpha = alpha
        self.use_rs = use_rs
        # the decr-eps schedule is the reference default for l1
        self.use_largereps = (norm == "l1") if use_largereps is None else use_largereps
        self.verbose = verbose
        self.eot_iter = eot_iter
        self.model_rng_fn = model_rng_fn
        self.device = resolve_device(device)
        if version != "custom":
            if attacks_to_run:
                raise ValueError("attacks_to_run requires version='custom'")
            attacks_to_run = VERSIONS[version]
            if version == "standard":
                self.n_restarts = 5 if norm == "l1" else 1
                self.n_target_classes = 5 if norm == "l1" else 9
            elif version == "plus":
                self.n_restarts = 5
                self.n_target_classes = 9
            else:  # rand: EOT against randomized defenses
                self.n_restarts = 1
                self.eot_iter = max(eot_iter, 20)
        self.attacks_to_run: List[str] = list(attacks_to_run or [])
        self.version = version
        for a in self.attacks_to_run:
            if a not in ATTACKS:
                raise ValueError(f"unknown attack: {a}")
        if version == "rand" and model_rng_fn is None:
            log.warning(
                "version='rand' runs EOT (eot_iter=%d) but no model_rng_fn "
                "was given — a deterministic logits_fn makes EOT a no-op; "
                "pass model_rng_fn=(lambda x, seed: logits) for randomized "
                "defenses", self.eot_iter,
            )

    # ---------------------------------------------------------------- helpers
    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    @torch.no_grad()
    def predict(self, x: np.ndarray, bs: int) -> np.ndarray:
        preds = [
            self.logits_fn(self._to_device(x[i : i + bs])).argmax(dim=-1).cpu().numpy()
            for i in range(0, x.shape[0], bs)
        ]
        return np.concatenate(preds)

    def _run_attack(self, attack: str, xb: torch.Tensor, yb: torch.Tensor, rng: int) -> torch.Tensor:
        """Run one cascade stage on a batch; return candidate adversarials."""
        common = dict(eps=self.eps, n_iter=self.n_iter, norm=self.norm, alpha=self.alpha,
                      use_rs=self.use_rs, n_restarts=self.n_restarts,
                      use_largereps=self.use_largereps, eot_iter=self.eot_iter,
                      model_rng_fn=self.model_rng_fn)
        if attack == "apgd-ce":
            return apgd_restarts(self.logits_fn, xb, yb, criterion=_ce_criterion,
                                 rng=rng, **common).x_best_adv
        if attack == "apgd-dlr":
            return apgd_restarts(self.logits_fn, xb, yb, criterion=dlr_loss,
                                 rng=rng, **common).x_best_adv
        if attack in ("fab", "fab-t"):
            return fab_attack(self.logits_fn, xb, yb, norm=self.norm, n_iter=self.n_iter,
                              n_restarts=self.n_restarts, eps=self.eps, targeted=attack == "fab-t",
                              n_target_classes=self.n_target_classes, rng=rng).x_adv
        if attack == "square":
            return SQUARE[self.norm](self.logits_fn, xb, yb, eps=self.eps,
                                     n_queries=self.square_n_queries, rng=rng).x_adv
        # apgd-t: cycle over the 2nd..(n+1)-th most likely classes
        with torch.no_grad():
            logits = self.logits_fn(xb)
        order = torch.argsort(logits, dim=-1, stable=True)
        adv = xb
        still = (logits.argmax(dim=-1) == yb).cpu().numpy()
        for tc in range(2, self.n_target_classes + 2):
            if not still.any():
                break
            # with fewer than tc classes the index clamps to the least likely
            # class, as JAX's gather clamps an out-of-range index
            res = apgd_restarts(
                self.logits_fn, xb, yb, criterion=dlr_loss_targeted,
                criterion_args=(order[:, max(order.shape[1] - tc, 0)],), rng=fold_in(rng, tc), **common,
            )
            fooled = ~res.acc.cpu().numpy() & still
            mask = torch.as_tensor(fooled, device=xb.device)[:, None, None, None]
            adv = torch.where(mask, res.x_best_adv, adv)
            still = still & ~fooled
        return adv

    # ------------------------------------------------------------------- main
    def run_standard_evaluation(
        self,
        x,
        y,
        bs: int = 250,
        state_path=None,
        return_labels: bool = False,
        run_checks: bool = True,
        bs_forward: Optional[int] = None,
    ):
        """x (N, 3, H, W) in [0,1] and y (N,) on the host (numpy or CPU
        tensors). Returns x_adv (and the adversarial labels) on the host."""
        bs_fwd = bs_forward or max(bs, 128)
        x_np = np.asarray(x, dtype=np.float32)
        y_np = np.asarray(y).astype(np.int64)

        if state_path is not None:
            try:
                state = EvaluationState.from_disk(state_path)
                if state.attacks_to_run != set(self.attacks_to_run):
                    raise ValueError("state file was created with a different attack set")
                if self.verbose:
                    log.info("restored state from %s", state_path)
            except FileNotFoundError:
                state = EvaluationState(set(self.attacks_to_run), path=state_path)
        else:
            state = EvaluationState(set(self.attacks_to_run))
        todo = [a for a in self.attacks_to_run if a not in state.run_attacks]

        if run_checks:
            xb = self._to_device(x_np[:bs])
            checks.check_randomized(self.logits_fn, xb)
            n_cls = checks.check_range_output(self.logits_fn, xb)
            checks.check_n_classes(n_cls, self.attacks_to_run, self.n_target_classes)
            checks.check_dynamic(self.logits_fn, xb)

        preds = None
        if state.robust_flags is None:
            preds = self.predict(x_np, bs_fwd)
            robust = preds == y_np
            state.robust_flags = robust
            state.clean_accuracy = float(robust.mean())
            state.to_disk()
        robust = state.robust_flags.copy()
        racc: Dict[str, float] = {"clean": float(robust.mean())}
        if self.verbose:
            log.info("initial accuracy: %.2f%%", 100 * racc["clean"])

        x_adv = x_np.copy()
        y_adv = preds if preds is not None else self.predict(x_np, bs_fwd)
        t0 = time.time()
        for attack in todo:
            idcs = np.nonzero(robust)[0]
            if idcs.size == 0:
                break
            rng = self.seed + zlib.crc32(attack.encode()) % (1 << 16)
            for bstart in range(0, idcs.size, bs):
                batch_idx = idcs[bstart : bstart + bs]
                xb = self._to_device(x_np[batch_idx])
                yb = self._to_device(y_np[batch_idx])
                adv = self._run_attack(attack, xb, yb, fold_in(rng, bstart))
                with torch.no_grad():
                    out = self.logits_fn(adv).argmax(dim=-1).cpu().numpy()
                adv_np = adv.detach().cpu().numpy()
                fooled = out != y_np[batch_idx]
                robust[batch_idx[fooled]] = False
                x_adv[batch_idx[fooled]] = adv_np[fooled]
                y_adv[batch_idx[fooled]] = out[fooled]
                state.robust_flags = robust
                state.to_disk()
                if self.verbose:
                    log.info("%s: batch %d, %d/%d fooled", attack, bstart // bs,
                             int(fooled.sum()), batch_idx.size)
            racc[attack] = float(robust.mean())
            state.add_run_attack(attack)
            if self.verbose:
                log.info("robust accuracy after %s: %.2f%% (%.1f s)",
                         attack.upper(), 100 * racc[attack], time.time() - t0)

        checks.check_square_sr(racc)
        state.to_disk(force=True)
        self.robust_accuracy_dict = racc
        if return_labels:
            return torch.from_numpy(x_adv), torch.from_numpy(y_adv)
        return torch.from_numpy(x_adv)
