"""The VLM captioning eval under attack: BLIP-2 OPT through the ensemble
runner.

The program under test is the port's `vlm_eval.ensemble.EnsembleRunner.run`
over the BLIP-2 adapter `vlm_eval.run_evaluation.build_eval_model` builds
(`--model blip2`: the hash tokenizer, bf16, the weights in `half_state`'s
layout), with the one stage `--attack apgd` gives (untargeted, half
precision, ground truth 0), batched as `--batch_size` asks, greedy
captions at the CLI's defaults and each caption scored by CIDEr against
its image's references, as `evaluate_captioning` does; no state files.
Prompts are `evaluate_captioning`'s at 0 shots: the two demos' captions as
text ("A photo of ..." each), then "A photo of " and the caption. A unit is
one group of fresh images: attacked, captioned and scored. Its work is
group x iterations example-steps.

The check, after the window, against `reference/blip2.py` in float32 (the
numbers of `entries/caption_attack.py`):
- `loss_gap`: the widest relative gap between the program's per-example
  loss and the reference's, at the last iterate whose gradient the program
  took;
- `grad_gap`: the widest relative l2 gap of that iterate's pixel gradient;
- `token_gap_mean`: over a sample of served captions drawn from the seed
  (the longest among them), the mean gap by which a served token's
  reference logit lies below the reference's best at its position, the
  query prompt, the attacked image and the tokens before it given (the
  widest such gap, `token_gap`, is reported, not compared);
- `attack_shortfall`: the share of the window's images whose reference loss
  at the program's adversarial image is not above its loss at the clean one;
- `ball_excess`: how far any adversarial image leaves the eps-ball or [0, 1].

The cell is OpenFlamingo's (`entries/caption_attack.py`) with BLIP-2's
set-up, counts and check; the BLIP-2 weight specs and model construction are here
(the harness's `models.py` holds CLIP's and OpenFlamingo's).
"""

from __future__ import annotations

import argparse
import random
from typing import Dict

import numpy as np
import torch

from harness import faults, registry, traffic, weights
from harness.probe import Probe
from harness.traffic import fold
from reference import blip2 as R

ROWS = 8  # the reference's block of rows under a gradient: its float32 products keep float32 weights
NO_GRAD_ROWS = 16

# the faults a cell of this entry can have (one chip: no exchange between chips to leave out)
FAULTS = (faults.step_unchanged, faults.half_batch, faults.answer_altered, faults.caption_altered)


# ------------------------------------------------------------------ model
def blip2_config(cfg: Dict):
    """The port's Blip2Config for an HF-style BLIP-2 OPT configuration."""
    from robustvlm_tpu_torch.models.blip2.model import Blip2Config, Blip2VisionConfig, QFormerConfig
    from robustvlm_tpu_torch.models.opt.model import OPTConfig

    v, q, t = cfg["vision_config"], cfg["qformer_config"], cfg["text_config"]
    if q["encoder_hidden_size"] != v["hidden_size"]:
        raise ValueError("the Q-Former's cross-attention reads the vision tower's width")
    vision = Blip2VisionConfig(v["hidden_size"], v["num_hidden_layers"], v["num_attention_heads"],
                               v["image_size"], v["patch_size"], v["intermediate_size"], v["layer_norm_eps"])
    qformer = QFormerConfig(q["hidden_size"], q["num_hidden_layers"], q["num_attention_heads"],
                            q["intermediate_size"], q["cross_attention_frequency"], q["layer_norm_eps"])
    opt = OPTConfig("opt-2.7b", t["hidden_size"], t["num_hidden_layers"], t["num_attention_heads"],
                    t["ffn_dim"], vocab_size=t["vocab_size"], max_seq_len=t["max_position_embeddings"],
                    norm_eps=t["layer_norm_eps"])
    return Blip2Config("blip2-opt-2.7b", vision, qformer, opt, num_query_tokens=cfg["num_query_tokens"])


def _std(name: str, cfg: Dict) -> float:
    """The normal std of a weight (the port's `init_random_state` scheme)."""
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("opt."):
        return {"tok_embedding": 0.02, "pos_embedding": 0.01}.get(leaf, cfg["text_config"]["hidden_size"] ** -0.5)
    if name.startswith("visual."):
        return cfg["vision_config"]["hidden_size"] ** -0.5
    if name == "query_tokens":
        return 0.02
    return cfg["qformer_config"]["hidden_size"] ** -0.5


def blip2_specs(cfg: Dict) -> Dict[str, weights.Spec]:
    """Weight specs in `half_state`'s layout: matrices bfloat16; the 1-D
    parameters, the query tokens and the language projection float32. The
    LM head is not drawn: `build` ties it to the token embedding."""
    from robustvlm_tpu_torch.models.blip2.model import Blip2

    specs = {}
    for name, shape in weights.meta_shapes(lambda: Blip2(blip2_config(cfg))).items():
        if name == "opt.lm_head":
            continue
        leaf = name.rsplit(".", 1)[-1]
        keep32 = len(shape) < 2 or name == "query_tokens" or name.startswith("language_projection.")
        if leaf in ("g", "ln_g"):
            init = ("ones",)
        elif len(shape) == 1 and name != "visual.class_embedding":
            init = ("zeros",)
        else:
            init = ("normal", _std(name, cfg))
        specs[name] = (shape, torch.float32 if keep32 else torch.bfloat16, init)
    return specs


def make_state(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights from the seed, the LM head a view of the token embedding."""
    state = weights.make(blip2_specs(cfg), seed, device)
    state["opt.lm_head"] = state["opt.tok_embedding"].t()
    return state


def build(cfg: Dict, state: Dict[str, torch.Tensor]):
    from robustvlm_tpu_torch.models.blip2.model import Blip2

    return Blip2.from_state(blip2_config(cfg), state)


# ------------------------------------------------------------------ cell
class Cell(registry.entry("caption_attack").Cell):
    """OpenFlamingo's caption-attack cell (`entries/caption_attack.py`: the
    runner, the prompts, the groups, the window's kept outputs) over the
    BLIP-2 adapter, checked against `reference/blip2.py`."""

    def setup(self) -> None:
        from robustvlm_tpu_torch.device import use_full_fp32
        from robustvlm_tpu_torch.vlm_eval import run_evaluation as RE
        from robustvlm_tpu_torch.vlm_eval.ensemble import AttackSpec, EnsembleRunner

        use_full_fp32()
        self.state = make_state(self.cfg, self.run.seed, self.dev)
        args = argparse.Namespace(model="blip2", model_size="7b", tokenizer_path="", quantize_decode=False,
                                  device=self.dev.type)
        adapter = RE.build_eval_model(args, "half", {"half": build(self.cfg, self.state)})
        self.text_len = int(adapter.max_len)
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

    def lm_len(self) -> int:
        """OPT's positions in a teacher-forced call: the queries and the padded prompt."""
        return int(self.cfg["num_query_tokens"]) + self.text_len

    def layer_ctx(self) -> dict:
        c = self.run.counts
        return {"traced_calls": self.probe.traced_calls,
                "traced_flops": self.probe.traced_calls * c.apgd_iteration_flops(self.cfg, self.batch,
                                                                                 self.text_len),
                "attention": {"vit": c.vit_attention_launch_counts(self.cfg, self.batch, "bfloat16"),
                              "flash_causal": c.flash_launch_counts(self.cfg, self.batch, self.lm_len(),
                                                                    "bfloat16")},
                "spans": dict(self.spans)}

    # ------------------------------------------------------------ check
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
                for s in range(0, x.shape[0], NO_GRAD_ROWS):
                    rows = slice(s, s + NO_GRAD_ROWS)
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
        nq = int(cfg["num_query_tokens"])
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
                prompt = R.query_ids(k["queries"][j])
                seq = torch.tensor([prompt + served], device=self.dev)
                x = torch.from_numpy(np.asarray(k["adv"][j])[None]).to(self.dev)
                ref = R.forward(w, cfg, x, seq)[0]
                pos = torch.arange(nq + len(prompt) - 1, nq + len(prompt) - 1 + len(served), device=self.dev)
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
