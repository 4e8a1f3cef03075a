"""The VLM captioning eval under attack: OpenFlamingo through the ensemble
runner.

The program under test is the port's `vlm_eval.ensemble.EnsembleRunner.run`
over the OpenFlamingo adapter `vlm_eval.run_evaluation.build_eval_model`
builds (the hash tokenizer, bf16), with the one stage `--attack apgd` gives
(untargeted, half precision, ground truth 0), batched as `--batch_size`
asks, greedy captions at the CLI's defaults and each caption scored by
CIDEr against its image's references, as `evaluate_captioning` does; no
state files. Prompts are `evaluate_captioning`'s at 0 shots: two text-only
demos, then the image and the caption. A unit is one group of fresh
images: attacked, captioned and scored. Its work is group x iterations
example-steps.

The check, after the window, against `reference/flamingo.py` in float32:
- `loss_gap`: the widest relative gap between the program's per-example
  loss and the reference's, at the last iterate whose gradient the program
  took;
- `grad_gap`: the widest relative l2 gap of that iterate's pixel gradient;
- `token_gap_mean`: over a sample of served captions drawn from the seed
  (the longest among them), the mean gap by which a served token's
  reference logit lies below the reference's best at its position, the
  prompt, the attacked image and the tokens before it given (the widest
  such gap, `token_gap`, swings with near-ties from seed to seed and is
  reported, not compared);
- `attack_shortfall`: the share of the window's images whose reference loss
  at the program's adversarial image is not above its loss at the clean one;
- `ball_excess`: how far any adversarial image leaves the eps-ball or [0, 1].
"""

from __future__ import annotations

import argparse
import random

import numpy as np
import torch

from harness import faults, models, traffic, weights
from harness.probe import Probe
from harness.traffic import fold
from reference import flamingo as R
from reference.common import full_fp32

GATE = 0.5  # both gates of every cross-attention block (chip_smoke.py's FLAMINGO_GATE)
ROWS = 16  # the reference's block of rows: its float32 products keep float32 weights for the backward

# the faults a cell of this entry can have, planted by the tests and `calibrate.py --faults`
# (one chip: no exchange between chips to leave out)
FAULTS = (faults.step_unchanged, faults.half_batch, faults.answer_altered, faults.caption_altered)


class Cell:
    rate_metric = "caption_attack_steps_per_s"

    def __init__(self, run):
        self.run = run
        self.cfg, self.tr = run.config, run.traffic
        self.dev = run.device
        self.attack = self.tr["attack"]
        self.eps = self.attack["eps_255"] / 255.0
        self.n_iter = int(self.attack["n_iter"])
        self.batch = int(self.tr["images"]["batch"])
        self.attempted = self.failed = 0
        self.kept, self.spans = [], {"attack_s": 0.0, "wall_s": 0.0}
        self.tf_prompts = []

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        from robustvlm_tpu_torch.device import use_full_fp32
        from robustvlm_tpu_torch.vlm_eval import run_evaluation as RE
        from robustvlm_tpu_torch.vlm_eval.ensemble import AttackSpec, EnsembleRunner
        from robustvlm_tpu_torch.vlm_eval.eval_models import WordTokenizer

        use_full_fp32()
        seed = self.run.seed
        self.state = weights.make(models.flamingo_specs(self.cfg, GATE), seed, self.dev)
        model = models.build_flamingo(self.cfg, self.state, WordTokenizer().media_token_id)
        args = argparse.Namespace(model="open_flamingo", model_size="7b", tokenizer_path="",
                                  quantize_decode=False, device=self.dev.type)
        adapter = RE.build_eval_model(args, "half", {"half": model})
        t = self.tr.get("trace", {})
        self.probe = Probe(adapter, self.run.tracer, int(t.get("first_call", 0)), int(t.get("calls", 1)))
        a = self.attack
        self.schedule = [AttackSpec(kind="apgd", precision=a["precision"], gt_idx=a["gt_idx"],
                                    n_iter=self.n_iter)]
        gen = self.tr["generate"]
        self.runner = EnsembleRunner(
            lambda precision: self.probe, eps=self.eps, norm=a["norm"], score_fn=self._score,
            prompt_fn=self._prompt, threshold=float(self.tr["threshold"]), out_dir=None,
            max_new_tokens=int(gen["max_new_tokens"]), num_beams=int(gen["num_beams"]), verbose=False,
            batch_size=self.batch)
        # warm-up at the cell's shapes: kernel builds, the allocator, cuBLAS,
        # the prompt lengths of every group (the captions' word count is fixed)
        self._group(-1, n_iter=2)
        self.fresh()

    def _prompt(self, model, item, spec, query_only: bool) -> str:
        """`evaluate_captioning`'s prompt: the demos' context, then the query."""
        from robustvlm_tpu_torch.vlm_eval.fewshot import build_context_text

        ctx = build_context_text(model, item.get("demos") or [], int(self.tr["shots"]), task="caption")
        if query_only:
            return ctx + model.get_caption_prompt(None)
        caps = item["all_captions"]
        text = ctx + model.get_caption_prompt(caps[(spec.gt_idx or 0) % len(caps)])
        self.tf_prompts.append(text)
        return text

    def _score(self, caption: str, item) -> float:
        return self.idf.score(caption, item["all_captions"]) * 100.0

    def _items(self, unit: int):
        from robustvlm_tpu_torch.vlm_eval.metrics.cider import CiderIDF

        x = traffic.images(self.tr["images"], self.run.seed, unit, self.dev)
        caps = traffic.captions(self.tr["captions"], self.run.seed, unit, x.shape[0])
        x_np = x.cpu().numpy()
        items = [dict(c, image=x_np[j], image_id=f"{unit}-{j}") for j, c in enumerate(caps)]
        self.idf = CiderIDF([it["all_captions"] for it in items])
        return items

    def _group(self, unit: int, n_iter=None):
        import dataclasses

        items = self._items(unit)
        schedule = self.schedule if n_iter is None else [dataclasses.replace(self.schedule[0], n_iter=n_iter)]
        self.tf_prompts = []
        res = self.runner.run(items, schedule, seed=fold(self.run.seed, 20_000 + unit))
        return items, res

    def unit(self, i: int) -> float:
        self.probe.begin_unit(i)
        items, res = self._group(i)
        self.probe.close()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        ids = [it["image_id"] for it in items]
        self.kept.append({"unit": i, "ids": ids, "adv": [res["adv"][k] for k in ids],
                          "outputs": [res["outputs"][k] for k in ids],
                          "queries": [self._prompt(self.probe, it, None, True) for it in items],
                          "tf_prompts": list(self.tf_prompts)})
        self.spans["attack_s"] += res["attack_s"]
        self.spans["wall_s"] += res["wall_s"]
        self.attempted += len(items)
        return float(len(items) * self.n_iter)

    def prompt_len(self) -> int:
        return len(R.teacher_forced(self.kept[-1]["tf_prompts"][0])[0]) if self.kept else 0

    def layer_ctx(self) -> dict:
        c = self.run.counts
        t = self.prompt_len()
        return {"traced_calls": self.probe.traced_calls,
                "traced_flops": self.probe.traced_calls * c.apgd_iteration_flops(self.cfg, self.batch, t),
                "attention": {"vit": c.vit_attention_launch_counts(self.cfg, self.batch, "bfloat16"),
                              "flash_alibi": c.flash_alibi_launch_counts(self.cfg, self.batch, t, "bfloat16")},
                "spans": dict(self.spans)}

    def fresh(self) -> None:
        self.kept, self.probe.last = [], {}
        self.spans = {"attack_s": 0.0, "wall_s": 0.0}

    def freeze(self) -> None:
        self.last = self.probe.last

    def release(self) -> None:
        self.freeze()
        del self.probe, self.runner
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def check(self, limits: dict) -> list:
        from harness.core import reading

        full_fp32()
        r = self.readings()
        return [reading(k, r[k], float(limits[k]))
                for k in ("loss_gap", "grad_gap", "token_gap_mean", "attack_shortfall", "ball_excess")]

    def _tokens(self, prompts):
        ids, masks = zip(*(R.teacher_forced(p) for p in prompts))
        return (torch.tensor(ids, device=self.dev), torch.tensor(masks, device=self.dev))

    def readings(self, candidate=None) -> dict:
        """The compared numbers with the program's outputs, or with
        `candidate` (the control: the reference in fp8) in the program's
        place for the gaps: `candidate("loss", x, ids, mask)` -> (loss, grad),
        `candidate("logits", x, ids)` -> logits."""
        w, cfg, last = self.state, self.cfg, self.last
        ids, mask = self._tokens(self.kept[-1]["tf_prompts"])
        ref_loss, ref_grad = loss_and_grad(w, cfg, last["x"], ids, mask, "float32")
        if candidate is None:
            got_loss, got_grad = last["out"].float(), last["grad"].float()
        else:
            got_loss, got_grad = candidate("loss", last["x"], ids, mask)
        loss_gap = float(((got_loss - ref_loss).abs() / ref_loss.abs().clamp_min(1e-30)).max())
        num = (got_grad - ref_grad).flatten(1).norm(dim=1)
        grad_gap = float((num / ref_grad.flatten(1).norm(dim=1).clamp_min(1e-30)).max())
        token_gap, token_gap_mean = self._token_gaps(candidate)
        short, total, excess = 0, 0, 0.0
        with torch.no_grad():
            for k in self.kept:
                x = traffic.images(self.tr["images"], self.run.seed, k["unit"], self.dev)
                xa = torch.from_numpy(np.stack(k["adv"])).to(self.dev)
                excess = max(excess, float(((xa - x).abs() - self.eps).max()),
                             float((-xa).max()), float((xa - 1.0).max()))
                ids_k, mask_k = self._tokens(k["tf_prompts"])
                for s in range(0, x.shape[0], ROWS):
                    rows = slice(s, s + ROWS)
                    l_adv = R.per_example_loss(w, cfg, xa[rows], ids_k[rows], mask_k[rows])
                    l_clean = R.per_example_loss(w, cfg, x[rows], ids_k[rows], mask_k[rows])
                    short += int((l_adv <= l_clean).sum())
                total += x.shape[0]
        return {"loss_gap": loss_gap, "grad_gap": grad_gap, "token_gap": token_gap,
                "token_gap_mean": token_gap_mean, "attack_shortfall": short / total,
                "ball_excess": max(excess, 0.0)}

    def _token_gaps(self, candidate):
        """(widest, mean) gap of the served tokens below the reference's
        best logit at their positions."""
        w, cfg = self.state, self.cfg
        pool = [(u, j) for u, k in enumerate(self.kept) for j in range(len(k["ids"]))]
        n = min(int(self.tr["check"]["sample_items"]), len(pool))
        longest = max(pool, key=lambda uj: len(R.served_ids(self.kept[uj[0]]["outputs"][uj[1]])))
        rng = random.Random(fold(self.run.seed, 31))
        sample = [longest] + rng.sample([p for p in pool if p != longest], n - 1)
        gaps = []
        with torch.no_grad():
            for u, j in sample:
                k = self.kept[u]
                served = R.served_ids(k["outputs"][j])
                if not served:
                    continue
                prompt = R.encode(k["queries"][j])
                seq = torch.tensor([prompt + served], device=self.dev)
                x = torch.from_numpy(np.asarray(k["adv"][j])[None]).to(self.dev)
                ref = R.forward(w, cfg, x, seq)[0]
                pos = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(served), device=self.dev)
                lg = ref[pos]
                if candidate is None:
                    tok = torch.tensor(served, device=self.dev)
                else:  # the token the control would serve at each position
                    tok = candidate("logits", x, seq)[0][pos].argmax(dim=-1)
                gaps.append(lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0])
        if not gaps:
            return 0.0, 0.0
        every = torch.cat(gaps)
        return float(every.max()), float(every.mean())

    def control(self):
        w, cfg = self.state, self.cfg

        def cand(kind, x, ids, mask=None):
            if kind == "loss":
                return loss_and_grad(w, cfg, x, ids, mask, "fp8")
            with torch.no_grad():
                return R.forward(w, cfg, x, ids, "fp8")

        return cand


def loss_and_grad(w, cfg, x, ids, mask, precision: str):
    """The reference's per-example loss and its pixel gradient, in blocks of rows."""
    losses, grads = [], []
    for s in range(0, x.shape[0], ROWS):
        xg = x[s:s + ROWS].detach().float().requires_grad_(True)
        with torch.enable_grad():
            loss = R.per_example_loss(w, cfg, xg, ids[s:s + ROWS], mask[s:s + ROWS], precision)
            (g,) = torch.autograd.grad(loss.sum(), xg)
        losses.append(loss.detach())
        grads.append(g)
    return torch.cat(losses), torch.cat(grads)
