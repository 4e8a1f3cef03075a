"""AutoAttack orchestrator: run an attack cascade over still-robust examples.

Counterpart of `robustvlm_tpu/eval/autoattack.py` (`AutoAttackTPU`), l-inf:
the robust-flags bookkeeping (an example is attacked by a later stage only
while it is still classified correctly), per-attack robust accuracy,
resumable `EvaluationState`, and the pre-run sanity checks.

The data stays on the host; each attack batch is moved to the model's
device: `cuda` unless the caller passes `device="cpu"` (without a GPU the
constructor raises, as every entry point of the port does). PyTorch runs eagerly, so batches are not padded to one static
shape. Seeds follow the JAX package's integers: the attack's base seed is
`seed + crc32(attack) % 2**16`, folded with the batch start, the target
class (APGD-T) and the restart (`attacks.apgd.fold_in`).

Ported: apgd-ce, apgd-dlr, apgd-t. Square, FAB and the EOT ('rand')
version raise NotImplementedError naming their ROADMAP queue item.
"""

from __future__ import annotations

import logging
import time
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from robustvlm_tpu_torch.attacks.apgd import apgd_restarts, fold_in
from robustvlm_tpu_torch.device import resolve_device
from robustvlm_tpu_torch.eval import checks
from robustvlm_tpu_torch.eval.state import EvaluationState
from robustvlm_tpu_torch.ops.losses import ce_loss, dlr_loss, dlr_loss_targeted

log = logging.getLogger("robustvlm_tpu_torch.autoattack")

VERSIONS = {
    "standard": ["apgd-ce", "apgd-t", "fab-t", "square"],
    "plus": ["apgd-ce", "apgd-dlr", "fab", "square", "apgd-t", "fab-t"],
    "custom": None,
}
PORTED = ("apgd-ce", "apgd-dlr", "apgd-t")
NOT_PORTED = {
    "square": "ROADMAP queue A5 (attacks/square.py)",
    "fab": "ROADMAP queue A5 (attacks/fab.py)",
    "fab-t": "ROADMAP queue A5 (attacks/fab.py)",
}


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
        alpha: Optional[float] = None,
        use_rs: bool = True,
        verbose: bool = True,
        device=None,
    ):
        if norm.lower() != "linf":
            raise NotImplementedError(
                f"AutoAttack: norm {norm} is not ported yet (ROADMAP queue A3); l-inf only"
            )
        if version not in VERSIONS:
            raise NotImplementedError(
                f"AutoAttack version {version!r} is not ported (EOT 'rand' is ROADMAP queue A5)"
            )
        self.logits_fn = logits_fn
        self.norm = "linf"
        self.eps = eps
        self.seed = seed
        self.n_iter = n_iter
        self.n_restarts = n_restarts
        self.n_target_classes = n_target_classes
        self.alpha = alpha
        self.use_rs = use_rs
        self.verbose = verbose
        self.device = resolve_device(device)
        if version != "custom":
            if attacks_to_run:
                raise ValueError("attacks_to_run requires version='custom'")
            attacks_to_run = VERSIONS[version]
            self.n_restarts = 5 if version == "plus" else 1
            self.n_target_classes = 9
        self.attacks_to_run: List[str] = list(attacks_to_run or [])
        self.version = version
        for a in self.attacks_to_run:
            if a in NOT_PORTED:
                raise NotImplementedError(f"attack {a!r} is not ported yet: {NOT_PORTED[a]}")
            if a not in PORTED:
                raise ValueError(f"unknown attack: {a}")

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
        common = dict(eps=self.eps, n_iter=self.n_iter, norm=self.norm,
                      alpha=self.alpha, use_rs=self.use_rs, n_restarts=self.n_restarts)
        if attack == "apgd-ce":
            return apgd_restarts(self.logits_fn, xb, yb, criterion=_ce_criterion,
                                 rng=rng, **common).x_best_adv
        if attack == "apgd-dlr":
            return apgd_restarts(self.logits_fn, xb, yb, criterion=dlr_loss,
                                 rng=rng, **common).x_best_adv
        # apgd-t: cycle over the 2nd..(n+1)-th most likely classes
        with torch.no_grad():
            logits = self.logits_fn(xb)
        order = torch.argsort(logits, dim=-1, stable=True)
        adv = xb
        still = (logits.argmax(dim=-1) == yb).cpu().numpy()
        for tc in range(2, self.n_target_classes + 2):
            if not still.any():
                break
            res = apgd_restarts(
                self.logits_fn, xb, yb, criterion=dlr_loss_targeted,
                criterion_args=(order[:, -tc],), rng=fold_in(rng, tc), **common,
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
