"""The port's `Blip2EvalModel` and `run_evaluation --model blip2` against the
JAX package's, float32 on the CPU, `test-tiny` weights from the JAX init
(`params_from_jax`), the hash tokenizer at OPT's vocabulary: `_answer_split`
and `set_inputs`' arrays equal; the adapter's loss within 1e-5 relative
(`__call__` and `pure(*bound_args, x)` alike); greedy and beam captions
equal; the CLI's APGD captioning and VQA runs by outcome (finite loss,
x_adv in the box and the eps-ball, the report's keys); the hash tokenizer
rebuilt at OPT's vocabulary only when that is the smaller."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from robustvlm_tpu.models.blip2 import model as JB
from robustvlm_tpu.vlm_eval import eval_models as JE
from robustvlm_tpu_torch.models.blip2 import model as PB
from robustvlm_tpu_torch.models.blip2.convert import params_from_jax
from robustvlm_tpu_torch.vlm_eval import eval_models as PE
from robustvlm_tpu_torch.vlm_eval import run_evaluation as R

torch.set_num_threads(1)

CFG = JB.BLIP2_CONFIGS["test-tiny"]
PCFG = PB.BLIP2_CONFIGS["test-tiny"]
PROMPTS = ["A photo of a dog: sitting at 4:30 ", "Question:what time is it? Short answer:4:30",
           "Question:is it? Short answer: Short answer:yes", "no marker here"]


@pytest.fixture(scope="module")
def adapters():
    tree = JB.init_blip2_params(jax.random.PRNGKey(0), CFG)
    model = PB.Blip2.from_state(PCFG, params_from_jax(jax.tree.map(np.asarray, tree)))
    vocab = CFG.opt.vocab_size
    j = JE.Blip2EvalModel(tree, CFG, JE.WordTokenizer(vocab), compute_dtype=jnp.float32, max_len=16)
    p = PE.Blip2EvalModel(model, PE.WordTokenizer(vocab), compute_dtype=torch.float32, max_len=16)
    return j, p


@pytest.mark.parametrize("prompt", PROMPTS)
def test_answer_split_equals_jax(prompt):
    assert PE.Blip2EvalModel._answer_split(prompt) == JE.Blip2EvalModel._answer_split(prompt)


def test_prompts_and_set_inputs_equal_jax(adapters):
    j, p = adapters
    assert p.get_caption_prompt("a cat") == j.get_caption_prompt("a cat")
    assert p.get_vqa_prompt("what?", "yes") == j.get_vqa_prompt("what?", "yes")
    assert p.get_vqa_prompt("what?") == j.get_vqa_prompt("what?")
    j.set_inputs(PROMPTS)
    p.set_inputs(PROMPTS)
    for got, ref in zip(p.bound_args[1:], j.bound_args[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_loss_equals_jax(adapters):
    j, p = adapters
    prompts = [j.get_caption_prompt("a brown dog"), j.get_vqa_prompt("what is it?", "a dog")]
    j.set_inputs(prompts)
    p.set_inputs(prompts)
    x = np.random.RandomState(0).rand(2, 3, 40, 40).astype(np.float32)
    ref = np.asarray(j(jnp.asarray(x)))
    got = p(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
    assert torch.equal(p.pure(*p.bound_args, torch.from_numpy(x)), got)


@pytest.mark.parametrize("beams", [1, 3])
def test_outputs_equal_jax(adapters, beams):
    j, p = adapters
    x = np.random.RandomState(1).rand(2, 3, 32, 32).astype(np.float32)
    prompts = [j.get_vqa_prompt("what is in the picture today?"), j.get_caption_prompt()]
    kw = dict(max_new_tokens=5, num_beams=beams, length_penalty=1.0)
    assert p.get_outputs(torch.from_numpy(x), prompts, **kw) == j.get_outputs(jnp.asarray(x), prompts, **kw)


def test_hash_tokenizer_rebuilt_at_opt_vocab():
    args = R.build_parser().parse_args(["--device", "cpu", "--model", "blip2", "--model_size", "test-tiny"])
    assert R.blip2_tokenizer(args, PCFG).vocab_size == CFG.opt.vocab_size == 128
    assert R.blip2_tokenizer(args, PB.BLIP2_CONFIGS["blip2-opt-2.7b"]).vocab_size == 512
    adapter = R.build_eval_model(args, "full")
    assert isinstance(adapter, PE.Blip2EvalModel) and adapter.tok.vocab_size == 128
    assert R.blip2_config(R.build_parser().parse_args(["--model", "blip2"])).name == "blip2-opt-2.7b"


def _coco_fixture(root):
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (40, 48, 3), np.uint8)).save(img_dir / f"im{i}.png")
        images.append({"id": i, "file_name": f"im{i}.png"})
        anns.append({"image_id": i, "caption": f"a photo number {i}"})
    ann = root / "ann.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns}))
    return img_dir, ann


def test_cli_coco_and_vqa_apgd_on_cpu(tmp_path):
    img_dir, ann = _coco_fixture(tmp_path)
    qf, af = tmp_path / "q.json", tmp_path / "a.json"
    qf.write_text(json.dumps({"questions": [{"question_id": 5, "image_id": 0, "question": "what is it?"}]}))
    af.write_text(json.dumps({"annotations": [{"question_id": 5, "answers": [{"answer": "cat"}] * 10}]}))
    Image.open(img_dir / "im0.png").save(img_dir / "COCO_val2014_000000000000.jpg")
    out = tmp_path / "out"
    res = R.main(["--device", "cpu", "--model", "blip2", "--model_size", "test-tiny", "--eval_coco",
                  "--coco_image_dir", str(img_dir), "--coco_annotations", str(ann), "--eval_vqav2",
                  "--vqav2_image_dir", str(img_dir), "--vqav2_questions", str(qf),
                  "--vqav2_annotations", str(af), "--attack", "apgd", "--eps", "8", "--n_iter", "3",
                  "--num_samples", "2", "--max_new_tokens", "4", "--out_base_path", str(out)])
    assert set(res["coco"]) >= {"cider", "attack_s", "attack_iters"} and res["coco"]["attack_iters"] == 6
    assert set(res["vqav2"]) >= {"vqa_accuracy", "attack_iters"} and res["vqav2"]["attack_iters"] == 3
    assert np.isfinite(res["coco"]["cider"]) and np.isfinite(res["vqav2"]["vqa_accuracy"])
    from robustvlm_tpu_torch.vlm_eval.datasets import CaptionDataset

    ds = CaptionDataset(str(img_dir), str(ann), size=32, split="val")
    adapter = R.build_eval_model(R.build_parser().parse_args(
        ["--device", "cpu", "--model", "blip2", "--model_size", "test-tiny"]), "half")
    for i in range(2):
        clean = np.asarray(ds[i]["image"])
        adv = np.load(out / "coco" / "adv" / f"{ds[i]['image_id']}.npy")
        assert adv.shape == (3, 32, 32) and np.abs(adv - clean).max() <= 8 / 255 + 1e-6
        assert 0.0 <= adv.min() <= adv.max() <= 1.0
        adapter.set_inputs([adapter.get_caption_prompt(ds[i]["all_captions"][0])])
        with torch.no_grad():
            assert torch.isfinite(adapter(torch.from_numpy(adv[None]))).all()
