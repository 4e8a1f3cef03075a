"""The plain references agree with the port at a small size on the CPU, in
float32: the same weights (the harness's), the same inputs."""

import dataclasses

import pytest
import torch

import tiny
from harness import models, weights
from reference import clip as RC
from reference import fare as RF
from reference import flamingo as RFl


def test_clip_logits_and_gradient_match_the_port():
    from robustvlm_tpu_torch.eval.classifier import make_zero_shot_classifier
    from robustvlm_tpu_torch.ops.losses import ce_loss

    torch.manual_seed(0)
    cfg = tiny.CLIP
    state = weights.make(models.clip_specs(cfg), 3, torch.device("cpu"))
    model = models.build_clip(cfg, state)
    head = torch.nn.functional.normalize(torch.randn(cfg["embed_dim"], 10), dim=0)
    port = make_zero_shot_classifier(model, head, logit_scale=100.0)
    x = torch.rand(3, 3, 32, 32)
    y = torch.tensor([1, 2, 3])
    xg = x.clone().requires_grad_(True)
    got = port(xg)
    (g_port,) = torch.autograd.grad(ce_loss(got, y, reduction="none").sum(), xg)
    xr = x.clone().requires_grad_(True)
    ref = RC.zero_shot_logits(state, cfg, head, 100.0, xr)
    (g_ref,) = torch.autograd.grad(RC.ce(ref, y).sum(), xr)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    # float32 sums in another order: within 1e-4 of the gradient's largest element
    torch.testing.assert_close(g_port, g_ref, rtol=1e-3, atol=1e-4 * float(g_ref.abs().max()))


def test_flamingo_logits_and_loss_match_the_port():
    from robustvlm_tpu_torch.models.flamingo.model import flamingo_forward
    from robustvlm_tpu_torch.vlm_eval.eval_models import FlamingoEvalModel, WordTokenizer

    torch.manual_seed(1)
    cfg = tiny.FLAMINGO
    tok = WordTokenizer()
    state = weights.make(models.flamingo_specs(cfg, 0.5), 4, torch.device("cpu"))
    full = {k: v.float() for k, v in state.items()}
    model = models.build_flamingo(cfg, full, tok.media_token_id)
    adapter = FlamingoEvalModel(model, tok, compute_dtype=torch.float32)
    prompts = ["Output: a dog on grass<|endofchunk|><image>Output: two red bus<|endofchunk|>",
               "Output: a cat<|endofchunk|><image>Output: a man riding a horse<|endofchunk|>"]
    adapter.set_inputs(prompts)
    x = torch.rand(2, 3, 32, 32)
    got_loss = adapter(x)
    ids, masks = zip(*(RFl.teacher_forced(p) for p in prompts))
    n = max(len(i) for i in ids)
    ids_t = torch.tensor([list(i) + [0] * (n - len(i)) for i in ids])
    mask_t = torch.tensor([list(m) + [0.0] * (n - len(m)) for m in masks])
    assert torch.equal(ids_t, adapter._lang)
    torch.testing.assert_close(mask_t, adapter._mask)
    ref_loss = RFl.per_example_loss(full, cfg, x, ids_t, mask_t)
    torch.testing.assert_close(got_loss, ref_loss, rtol=1e-4, atol=1e-4)
    logits = flamingo_forward(model, x[:, None, None], ids_t, compute_dtype=torch.float32)
    torch.testing.assert_close(logits, RFl.forward(full, cfg, x, ids_t), rtol=1e-4, atol=1e-4)


def test_hash_tokens_match_the_port():
    from robustvlm_tpu_torch.vlm_eval.eval_models import WordTokenizer

    tok = WordTokenizer()
    assert RFl.encode_words("a man riding a horse") == tok.encode("a man riding a horse")
    assert RFl.served_ids(tok.decode([5, 77, 300])) == [5, 77, 300]
    assert (RFl.MEDIA, RFl.EOS) == (tok.media_token_id, tok.eos_token_id)


def test_config_files_are_the_ports():
    from robustvlm_tpu_torch.models.clip.model import CLIP_CONFIGS
    from robustvlm_tpu_torch.models.flamingo.model import FLAMINGO_CONFIGS
    from harness import registry

    clip = models.clip_config(registry.config("clip-vit-l-14"))
    assert dataclasses.replace(clip, name="ViT-L-14") == CLIP_CONFIGS["ViT-L-14"]
    of = models.flamingo_config(registry.config("openflamingo-9b"), 511)
    assert of == dataclasses.replace(FLAMINGO_CONFIGS["openflamingo-9b"], media_token_id=511)


def test_fare_step_matches_the_port():
    """One float32 FARE step of the port at a fixed adversarial image (the
    inner attack off) against the reference's loss, gradient and AdamW."""
    import copy

    from robustvlm_tpu_torch.train.trainer import TrainConfig, TrainStep

    torch.manual_seed(2)
    cfg = tiny.CLIP
    state = weights.make(models.clip_specs(cfg), 5, torch.device("cpu"))
    w0 = {k: v.clone() for k, v in state.items()}
    model = models.build_clip(cfg, state)
    tcfg = TrainConfig(attack="none", warmup=2, steps=10, lr=1e-3)
    step = TrainStep(tcfg, model, copy.deepcopy(model))
    x = torch.rand(4, 3, 32, 32)
    xa = (x + 0.03 * torch.randn_like(x)).clamp(0, 1)
    step.inner_attack = lambda *a, **k: xa
    m = step(x, None, 0)
    train = {"lr": tcfg.lr, "wd": tcfg.wd, "warmup": tcfg.warmup, "steps": tcfg.steps}
    ref = RF.follow(w0, cfg, train, [x], [xa], "float32")
    assert float(m["loss"]) == pytest.approx(ref["losses"][0], rel=1e-5)
    params = dict(step.model.named_parameters())
    for k, d in ref["change"].items():
        v = float(d.norm())
        # a key's bias has a gradient of round-off alone (softmax ignores it),
        # which Adam's first step turns into a full step of either sign: the
        # fused q|k|v bias is held to 5%, every other leaf to 1e-3
        rel = 5e-2 if k.endswith("qkv_b") else 1e-3
        assert float((params[k].detach() - w0[k]).norm()) == pytest.approx(v, rel=rel, abs=1e-9), k
