"""Ensemble attack schedule with per-image worst-case selection.

Counterpart of `robustvlm_tpu/vlm_eval/ensemble.py`, the core of the
reference VLM harness:
- the captioning schedule `[(none, half), 5x(apgd, half, gt=0..4),
  (apgd, full, init=prev-best)]`; VQA appends targeted runs;
- per-image WORST-case selection by the score (CIDEr, VQA accuracy), with
  an early stop once an image's score falls below the threshold;
- adversarial images saved per image, with `left_to_attack`, `gt_dict` and
  a per-stage state file for resuming a crashed run;
- targeted mode: minimize the loss of a fixed target text (the attack
  maximizes its negation); success = the target in the generation.

Precision is a second adapter ('half' bf16 attack stages, 'full' float32
final stage), as in JAX. Batches above 1 apply to the untargeted stages
that start from the clean image; a ragged last group is padded by
repeating its last item, whose results are dropped.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from robustvlm_tpu_torch.attacks.apgd import apgd_attack, fold_in
from robustvlm_tpu_torch.vlm_eval.datasets import save_adv_image
from robustvlm_tpu_torch.utils.profiling import span
from robustvlm_tpu_torch.vlm_eval.eval_models import make_frame_mask


def _crit_untargeted(o, y):
    return o


def _crit_targeted(o, y):
    # minimize the loss of the target text == maximize its negation
    return -o


@dataclasses.dataclass(frozen=True)
class AttackSpec:
    kind: str = "apgd"            # 'none' | 'apgd'
    precision: str = "half"       # 'half' | 'full'
    gt_idx: Optional[int] = None  # which ground-truth caption/answer to target
    init_from_best: bool = False
    n_iter: int = 100
    targeted: bool = False
    target_str: Optional[str] = None


def default_captioning_schedule(n_iter: int = 100, target_str: Optional[str] = None) -> List[AttackSpec]:
    """With `target_str`, every attack stage teacher-forces the target and
    minimizes its loss."""
    tgt = dict(targeted=True, target_str=target_str) if target_str else {}
    return (
        [AttackSpec(kind="none", precision="half")]
        + [AttackSpec(gt_idx=i, n_iter=n_iter, **tgt) for i in range(5)]
        + [AttackSpec(precision="full", init_from_best=True, n_iter=n_iter, **tgt)]
    )


def default_vqa_schedule(n_iter: int = 100, target_str: Optional[str] = None) -> List[AttackSpec]:
    """Adds the targeted 'maybe' / 'Word' runs (the word teacher-forced as the
    answer, its loss minimized)."""
    tgt = dict(targeted=True, target_str=target_str) if target_str else {}
    return (
        [AttackSpec(kind="none", precision="half")]
        + [AttackSpec(gt_idx=i, n_iter=n_iter, **tgt) for i in range(5)]
        + [
            AttackSpec(targeted=True, target_str="maybe", n_iter=n_iter),
            AttackSpec(targeted=True, target_str="Word", n_iter=n_iter),
            AttackSpec(precision="full", init_from_best=True, n_iter=n_iter, **tgt),
        ]
    )


class EnsembleRunner:
    """Drives the schedule over a dataset for one eval-model pair.

    make_model(precision) -> eval-model adapter ('half' / 'full'; the
    contract is vlm_eval/base.py). score_fn(caption, item) -> float per-image
    metric (higher = the model does better; the attack keeps the WORST).
    threshold: stop attacking an image once its score < threshold.
    prompt_fn(model, item, spec, query_only) builds a stage's teacher-forcing
    prompt: spec.target_str for targeted specs, else the gt caption/answer
    selected by spec.gt_idx.

    `mask_out` ('context' / 'query') masks the gradient of few-shot media
    frames (`eval_models.make_frame_mask`) where the input has a media axis
    of more than one frame, (B, T > 1, F, C, H, W); at 0 shots there is
    none. `host_loop` is JAX machinery (a host-driven attack loop to bound
    compile time); the port's APGD is always a Python loop, so it is
    accepted and ignored. The JAX runner's pad-length bucketing of batched
    Flamingo stages, also a retrace bound, is not carried over (end padding
    leaves the loss unchanged).
    """

    def __init__(self, make_model: Callable[[str], object], *, eps: float, norm: str = "linf",
                 score_fn: Callable[[str, Dict], float],
                 prompt_fn: Callable[[object, Dict, AttackSpec, bool], str],
                 threshold: float = 10.0, out_dir: Optional[str] = None,
                 max_new_tokens: int = 32, num_beams: int = 1, verbose: bool = True,
                 host_loop: bool = False, mask_out: Optional[str] = None, batch_size: int = 1):
        self.mask_out = mask_out if mask_out not in (None, "none") else None
        self.make_model = make_model
        self.eps = eps
        self.norm = norm
        self.score_fn = score_fn
        self.prompt_fn = prompt_fn
        self.threshold = threshold
        self.out_dir = Path(out_dir) if out_dir else None
        self.max_new_tokens = max_new_tokens
        self.num_beams = num_beams
        self.verbose = verbose
        self.batch_size = max(int(batch_size), 1)
        self._models: Dict[str, object] = {}

    def _model(self, precision: str):
        if precision not in self._models:
            self._models[precision] = self.make_model(precision)
        return self._models[precision]

    def _state_fingerprint(self, ids, schedule, seed) -> Dict:
        """What a resumed run must hold constant: the eval subset, the seed,
        eps and the whole per-stage schedule."""
        return {
            "ids": [str(i) for i in ids],
            "seed": int(seed),
            "eps": self.eps,
            "schedule": [dataclasses.asdict(s) for s in schedule],
        }

    def _load_state(self, ids, schedule, seed, left_to_attack, best_scores, best_outputs,
                    best_adv, gt_dict) -> int:
        """Reload a prior run's per-stage checkpoint; returns the number of
        completed stages (0: nothing to resume). A crash mid-stage resumes
        from the last stage boundary; per-item worst-case bookkeeping makes
        the re-run idempotent."""
        if self.out_dir is None:
            raise ValueError("resume=True requires out_dir")
        sp = self.out_dir / "ensemble_state.json"
        if not sp.exists():
            return 0
        st = json.loads(sp.read_text())
        fp = self._state_fingerprint(ids, schedule, seed)
        if st.get("ids") != fp["ids"] or st.get("seed") != fp["seed"]:
            raise ValueError("ensemble resume state does not match the current eval subset/seed: "
                             "re-run with the same --seed/--num_samples (or clear the out dir)")
        if st.get("eps") != fp["eps"] or st.get("schedule") != fp["schedule"]:
            raise ValueError("ensemble resume state was written under a different attack "
                             "configuration (eps or stage schedule): re-run with the same flags, "
                             "or clear the out dir")
        by_str = {str(i): i for i in ids}
        for k, v in st["left_to_attack"].items():
            left_to_attack[by_str[k]] = v
        for k, v in st["best_scores"].items():
            best_scores[by_str[k]] = float(v)
        for k, v in st["best_outputs"].items():
            best_outputs[by_str[k]] = v
        gt_dict.update(st["gt_dict"])
        for k, iid in by_str.items():
            p = self.out_dir / "adv" / f"{k}.npy"
            if p.exists():
                best_adv[iid] = np.load(p).astype(np.float32)
        done = int(st["stages_done"])
        if self.verbose and done:
            print(f"[ensemble] resuming after stage {done}/{len(schedule)} "
                  f"({sum(left_to_attack.values())}/{len(ids)} still active)", flush=True)
        return done

    def _attack_one(self, model, x, spec: AttackSpec, x_init, rng: int):
        if spec.kind == "none":
            return x
        crit = _crit_targeted if spec.targeted else _crit_untargeted
        mask = None
        if self.mask_out and x.dim() == 6 and x.shape[1] > 1:
            mask = make_frame_mask(tuple(x.shape), self.mask_out).to(x.device)
        res = apgd_attack(
            model, x, None, criterion=crit, eps=self.eps, n_iter=spec.n_iter, norm=self.norm,
            mask=mask, x_init=x_init, rng=rng,
            # targeted stages all teacher-force the same target: a random
            # start (seeded per stage and item) makes the worst case over
            # stages more than one run repeated; untargeted stages start
            # from the clean image, each forcing a different gt
            use_rs=spec.targeted and x_init is None,
        )
        return res.x_best

    def run(self, dataset, schedule: Sequence[AttackSpec], *, seed: int = 0,
            n_samples: Optional[int] = None, save_adv: bool = True,
            indices: Optional[Sequence[int]] = None, resume: bool = False) -> Dict:
        """Returns scores, outputs and adversarial images per item, the items
        left to attack, wall seconds, the seconds and APGD iterations
        spent in attacks (`attack_s`, `attack_iters`), and the seconds spent
        captioning the attacked images and scoring the captions (`caption_s`,
        `score_s`), all on one clock. Under a profiler window each group is
        an `ensemble.group` span with `ensemble.attack`, `ensemble.caption`
        and `ensemble.score` children."""
        if indices is not None:
            items = [dataset[int(i)] for i in indices]
        else:
            n_take = min(len(dataset), n_samples or len(dataset))
            items = [dataset[i] for i in range(n_take)]
        n = len(items)
        # per-ITEM key: VQA items share images, question_id is unique
        ids = [it.get("question_id", it["image_id"]) for it in items]
        if len(set(ids)) != len(ids):
            raise ValueError("ensemble items must have unique ids")

        left_to_attack: Dict = {i: True for i in ids}
        best_scores: Dict = {i: float("inf") for i in ids}
        best_outputs: Dict = {i: None for i in ids}
        best_adv: Dict = {i: None for i in ids}
        gt_dict: Dict = {}  # which gt produced each image's worst score
        start_stage = 0
        if resume:
            start_stage = self._load_state(ids, schedule, seed, left_to_attack, best_scores,
                                           best_outputs, best_adv, gt_dict)
        t0 = time.perf_counter()
        attack_s, caption_s, score_s, attack_iters = 0.0, 0.0, 0.0, 0

        for a_idx, spec in enumerate(schedule):
            if a_idx < start_stage:
                continue
            model = self._model(spec.precision)
            active = [j for j in range(n) if left_to_attack[ids[j]]]
            batchable = self.batch_size > 1 and not spec.targeted and not spec.init_from_best
            if batchable:
                groups = [active[k:k + self.batch_size] for k in range(0, len(active), self.batch_size)]
            else:
                groups = [[j] for j in active]
            dirty = set()  # ids whose best_adv changed this stage
            for grp in groups:
                with span("ensemble.group"):
                    n_real = len(grp)
                    if batchable and n_real < self.batch_size:
                        grp = grp + [grp[-1]] * (self.batch_size - n_real)
                    # the prev-best stage re-attacks each image's best gt
                    eff_specs = []
                    for j in grp:
                        eff = spec
                        if spec.init_from_best and spec.gt_idx is None and not spec.targeted:
                            eff = dataclasses.replace(spec, gt_idx=gt_dict.get(str(ids[j]), 0))
                        eff_specs.append(eff)
                    model.set_inputs([self.prompt_fn(model, items[j], e, False)
                                      for j, e in zip(grp, eff_specs)])
                    dev = model.device
                    x = torch.from_numpy(np.stack([np.asarray(items[j]["image"], np.float32)
                                                   for j in grp])).to(dev)
                    best0 = best_adv[ids[grp[0]]]
                    x_init = (torch.from_numpy(np.asarray(best0, np.float32))[None].to(dev)
                              if spec.init_from_best and best0 is not None else None)
                    # positional index, not the id (ids may be strings)
                    rng = fold_in(fold_in(seed, a_idx), grp[0])
                    with span("ensemble.attack"):
                        ta = time.perf_counter()
                        x_adv = self._attack_one(model, x, eff_specs[0], x_init, rng)
                        if spec.kind != "none":
                            if dev.type == "cuda":
                                torch.cuda.synchronize(dev)
                            attack_s += time.perf_counter() - ta
                            attack_iters += spec.n_iter
                    tc = time.perf_counter()
                    with span("ensemble.caption"):
                        outs = model.get_outputs(
                            x_adv, [self.prompt_fn(model, items[j], e, True) for j, e in zip(grp, eff_specs)],
                            max_new_tokens=self.max_new_tokens, num_beams=self.num_beams,
                        )
                    ts = time.perf_counter()
                    caption_s += ts - tc
                    with span("ensemble.score"):
                        x_adv_np = x_adv.detach().cpu().numpy()
                        for pos, j in enumerate(grp[:n_real]):
                            iid = ids[j]
                            out = outs[pos]
                            score = self.score_fn(out, items[j])
                            # a NaN score never wins `<`: keep the FIRST output/adv
                            # so the item still has a generation and a saved image
                            if best_outputs[iid] is None or score < best_scores[iid]:
                                best_outputs[iid] = out
                                best_adv[iid] = x_adv_np[pos]
                                dirty.add(iid)
                                if eff_specs[pos].gt_idx is not None:
                                    gt_dict[str(iid)] = eff_specs[pos].gt_idx
                                if not np.isnan(score):
                                    best_scores[iid] = score
                            if best_scores[iid] < self.threshold:
                                left_to_attack[iid] = False
                    score_s += time.perf_counter() - ts
            if self.verbose:
                finite = [s for s in best_scores.values() if np.isfinite(s)]
                mean_s = float(np.mean(finite)) if finite else float("nan")
                print(f"[ensemble] attack {a_idx + 1}/{len(schedule)} ({spec.kind},{spec.precision},"
                      f"gt={spec.gt_idx},targeted={spec.targeted}) done: mean score {mean_s:.2f}, "
                      f"{sum(left_to_attack.values())}/{n} still above threshold, "
                      f"{time.perf_counter() - t0:.0f}s (attack {attack_s:.0f}s, caption {caption_s:.0f}s, "
                      f"score {score_s:.0f}s)", flush=True)
            if self.out_dir is not None:
                self._write_state(ids, schedule, seed, a_idx, dirty, left_to_attack, best_scores,
                                  best_outputs, best_adv, gt_dict)

        # with save_adv=False the per-stage adv files were transient resume
        # state: a completed run removes them
        if self.out_dir is not None and not save_adv:
            for iid in ids:
                (self.out_dir / "adv" / f"{iid}.npy").unlink(missing_ok=True)
            (self.out_dir / "ensemble_state.json").unlink(missing_ok=True)

        return {
            "scores": best_scores,
            "outputs": best_outputs,
            "adv": best_adv,
            "left_to_attack": left_to_attack,
            "wall_s": time.perf_counter() - t0,
            "attack_s": attack_s,
            "caption_s": caption_s,
            "score_s": score_s,
            "attack_iters": attack_iters,
        }

    def _write_state(self, ids, schedule, seed, a_idx, dirty, left_to_attack, best_scores,
                     best_outputs, best_adv, gt_dict) -> None:
        """The per-stage checkpoint: left_to_attack and gt_dict json, the
        stage's changed adv tensors, and the resume state (replaced
        atomically, so a crash mid-write keeps the previous one)."""
        self.out_dir.mkdir(parents=True, exist_ok=True)
        (self.out_dir / "left_to_attack.json").write_text(
            json.dumps({str(k): v for k, v in left_to_attack.items()}))
        (self.out_dir / "gt_dict.json").write_text(json.dumps(gt_dict))
        for iid in dirty:
            save_adv_image(best_adv[iid], str(self.out_dir / "adv"), iid)
        state = dict(
            self._state_fingerprint(ids, schedule, seed),
            stages_done=a_idx + 1,
            left_to_attack={str(k): v for k, v in left_to_attack.items()},
            best_scores={str(k): v for k, v in best_scores.items()},
            best_outputs={str(k): v for k, v in best_outputs.items()},
            gt_dict=gt_dict,
        )
        tmp = self.out_dir / "ensemble_state.json.tmp"
        tmp.write_text(json.dumps(state))
        os.replace(tmp, self.out_dir / "ensemble_state.json")


def attack_success_rate(outputs: Dict, target_str: str) -> float:
    """Targeted success = the target as a substring of the generation."""
    vals = [o for o in outputs.values() if o is not None]
    if not vals:
        return float("nan")
    return float(np.mean([target_str.lower() in o.lower() for o in vals]))
