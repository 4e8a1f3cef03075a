"""A planted fault itself, at a small size on the CPU: `caption_altered`
changes the first served word of whichever adapter the ensemble runner
captions with (BLIP-2's at `test-tiny` here, which no cell runs yet) and
leaves the rest of each caption as it was."""

import numpy as np
import torch

from harness import faults


def _blip2_adapter():
    from robustvlm_tpu_torch.models.blip2 import Blip2, init_random_state
    from robustvlm_tpu_torch.models.blip2.model import BLIP2_CONFIGS
    from robustvlm_tpu_torch.vlm_eval.eval_models import Blip2EvalModel, WordTokenizer

    cfg = BLIP2_CONFIGS["test-tiny"]
    model = Blip2.from_state(cfg, init_random_state(cfg, 0))
    return Blip2EvalModel(model, WordTokenizer(cfg.opt.vocab_size), compute_dtype=torch.float32)


def _served(adapter) -> list:
    from robustvlm_tpu_torch.vlm_eval.ensemble import AttackSpec, EnsembleRunner

    rng = np.random.default_rng(5)
    items = [{"image": rng.random((3, 32, 32), dtype=np.float32), "image_id": j} for j in range(3)]
    runner = EnsembleRunner(lambda precision: adapter, eps=2 / 255, score_fn=lambda caption, item: 0.0,
                            prompt_fn=lambda model, item, spec, query_only: model.get_caption_prompt(None),
                            max_new_tokens=4, verbose=False, batch_size=3)
    res = runner.run(items, [AttackSpec(kind="none", precision="full")], seed=3)
    return [res["outputs"][j] for j in range(3)]


def test_caption_altered_changes_the_first_served_word_of_a_blip2_adapter():
    adapter = _blip2_adapter()
    sound = _served(adapter)
    with faults.caption_altered():
        altered = _served(adapter)
    assert _served(adapter) == sound  # restored on leaving
    for s, a in zip(sound, altered):
        assert a.split(" ")[0] != s.split(" ")[0] and a.split(" ")[1:] == s.split(" ")[1:], (s, a)


def test_caption_altered_patches_every_captioning_adapter():
    from robustvlm_tpu_torch.vlm_eval import eval_models as E

    adapters = (E.LlavaEvalModel, E.FlamingoEvalModel, E.Blip2EvalModel)
    sound = [c.get_outputs for c in adapters]
    with faults.caption_altered():
        assert all(c.get_outputs is not f for c, f in zip(adapters, sound))
    assert [c.get_outputs for c in adapters] == sound

