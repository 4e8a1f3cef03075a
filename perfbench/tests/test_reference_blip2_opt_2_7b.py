"""BLIP-2 OPT-2.7B's plain reference agrees with the port at the small
sizes (`tiny/configs/blip2-opt-2.7b.json`) on the CPU, in float32: the
harness's weights built as the cell's entry builds them, the adapter's
per-example loss and the logits; and the configuration file is the port's
blip2-opt-2.7b."""

import torch

import tiny
from harness import registry
from reference import blip2 as RB

ENTRY = registry.entry("blip2_caption_attack")
SMALL = tiny.small_config("blip2-opt-2.7b")


def _model():
    state = ENTRY.make_state(SMALL, 6, torch.device("cpu"))
    full = {k: v.float() for k, v in state.items()}
    return full, ENTRY.build(SMALL, full)


def test_blip2_loss_and_logits_match_the_port():
    from robustvlm_tpu_torch.models.blip2 import blip2_forward
    from robustvlm_tpu_torch.vlm_eval.eval_models import Blip2EvalModel, WordTokenizer

    torch.manual_seed(3)
    full, model = _model()
    adapter = Blip2EvalModel(model, WordTokenizer(), compute_dtype=torch.float32)
    prompts = ["A photo of a dog on grassA photo of two red busA photo of a man riding a horse",
               "A photo of a catA photo of the tower clockA photo of people on the beach"]
    adapter.set_inputs(prompts)
    x = torch.rand(2, 3, 32, 32)
    ids, masks = zip(*(RB.teacher_forced(p) for p in prompts))
    ids_t, mask_t = torch.tensor(ids), torch.tensor(masks)
    _, tokens, labels, mask = adapter.bound_args
    assert torch.equal(ids_t, tokens) and torch.equal(ids_t, labels)
    torch.testing.assert_close(mask_t, mask)
    got_loss = adapter(x)
    torch.testing.assert_close(got_loss, RB.per_example_loss(full, SMALL, x, ids_t, mask_t), rtol=1e-5, atol=1e-6)
    logits = blip2_forward(model, x, ids_t, compute_dtype=torch.float32)
    torch.testing.assert_close(logits, RB.forward(full, SMALL, x, ids_t), rtol=1e-4, atol=1e-4)


def test_blip2_lm_head_is_the_token_embedding():
    state = ENTRY.make_state(SMALL, 6, torch.device("cpu"))
    assert state["opt.lm_head"].data_ptr() == state["opt.tok_embedding"].data_ptr()
    assert torch.equal(state["opt.lm_head"], state["opt.tok_embedding"].t())
    assert state["opt.blocks.0.attn.wq"].dtype == torch.bfloat16
    assert state["language_projection.w"].dtype == state["query_tokens"].dtype == torch.float32


def test_blip2_config_file_is_the_ports():
    from robustvlm_tpu_torch.models.blip2.model import BLIP2_CONFIGS

    assert ENTRY.blip2_config(registry.config("blip2-opt-2.7b")) == BLIP2_CONFIGS["blip2-opt-2.7b"]
