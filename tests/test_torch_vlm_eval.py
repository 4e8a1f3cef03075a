"""The port's VLM eval layers (robustvlm_tpu_torch.vlm_eval) against the JAX
package's: the LLaVA adapter's teacher-forcing arrays and captions, CIDEr,
the image transform, the ensemble's outcomes on a tiny model, and the
run_evaluation CLI on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from robustvlm_tpu.data.loaders import default_image_transform as jax_transform
from robustvlm_tpu.models.llava.model import LLAVA_CONFIGS as J_CONFIGS
from robustvlm_tpu.models.llava.model import init_llava_params
from robustvlm_tpu.vlm_eval import ensemble as JE
from robustvlm_tpu.vlm_eval import eval_models as JM
from robustvlm_tpu.vlm_eval.metrics.cider import CiderIDF as JIDF
from robustvlm_tpu.vlm_eval.metrics.cider import CiderScorer as JCider
from robustvlm_tpu_torch.data.loaders import default_image_transform
from robustvlm_tpu_torch.models.llava.convert import params_from_jax
from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS, Llava
from robustvlm_tpu_torch.vlm_eval import ensemble as PE
from robustvlm_tpu_torch.vlm_eval import eval_models as PM
from robustvlm_tpu_torch.vlm_eval.metrics.cider import CiderIDF, CiderScorer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def adapters():
    """(JAX, port) float32 LlavaEvalModels on the same test-tiny weights."""
    cfg = J_CONFIGS["test-tiny"]
    tree = init_llava_params(jax.random.PRNGKey(0), cfg)
    model = Llava.from_state(LLAVA_CONFIGS["test-tiny"], params_from_jax(jax.tree.map(np.asarray, tree)))
    j = JM.LlavaEvalModel(tree, cfg, JM.WordTokenizer(), compute_dtype=jnp.float32, max_post_len=16)
    p = PM.LlavaEvalModel(model, PM.WordTokenizer(), compute_dtype=torch.float32, max_post_len=16)
    return j, p


def test_set_inputs_arrays_equal_jax(adapters):
    j, p = adapters
    prompts = [j.get_caption_prompt("a dog on a red sofa"),
               j.get_vqa_prompt("what color is it?", "red")]
    assert prompts == [p.get_caption_prompt("a dog on a red sofa"),
                       p.get_vqa_prompt("what color is it?", "red")]
    j.set_inputs(prompts)
    p.set_inputs(prompts)
    for name in ("pre", "post", "labels", "label_mask"):
        np.testing.assert_array_equal(getattr(p._cached, name).numpy(),
                                      np.asarray(getattr(j._cached, name)), err_msg=name)
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    np.testing.assert_allclose(p(torch.from_numpy(x)).numpy(), np.asarray(j(jnp.asarray(x))), rtol=1e-4)


def test_captions_equal_jax(adapters):
    j, p = adapters
    x = np.random.RandomState(1).rand(2, 3, 32, 32).astype(np.float32)
    prompts = [j.get_caption_prompt(None)] * 2
    for beams in (1, 2):
        ref = j.get_outputs(jnp.asarray(x), prompts, max_new_tokens=5, num_beams=beams)
        got = p.get_outputs(torch.from_numpy(x), prompts, max_new_tokens=5, num_beams=beams)
        assert got == ref and all(got)


def test_tokenizer_and_stops_equal_jax():
    jt, pt = JM.WordTokenizer(), PM.WordTokenizer()
    text = "USER: <image>\nProvide a short caption. ASSISTANT: a cat"
    assert pt.encode(text) == jt.encode(text) and pt.decode([5, 7]) == jt.decode([5, 7])
    s = "tok5 tok9 USER: more </s> x"
    assert PM.truncate_at_stops(s, PM.LlavaEvalModel.DEFAULT_STOPS) == \
        JM.truncate_at_stops(s, JM.LlavaEvalModel.DEFAULT_STOPS)


def test_cider_equals_jax():
    refs = [["a dog runs on the grass", "the dog is running", "a brown dog's run"],
            ["two cats sleep on a sofa", "cats on the couch isn't it", "sleeping cats, 50%"],
            ["a red car", "U.S. car parked", "a red-striped car on a road"]]
    cands = ["a dog runs on grass", "two cats on a couch", "a car"]
    assert abs(CiderScorer(cands, refs).corpus() - JCider(cands, refs).corpus()) <= 1e-9
    idf, jidf = CiderIDF(refs), JIDF(refs)
    for c, r in zip(cands, refs):
        assert abs(idf.score(c, r) - jidf.score(c, r)) <= 1e-9


def test_image_transform_equals_jax_pil_path():
    arr = np.random.RandomState(2).randint(0, 255, (45, 61, 3), np.uint8)
    for mode in ("RGB", "L"):
        img = Image.fromarray(arr).convert(mode)
        np.testing.assert_array_equal(default_image_transform(32, prefer_native=False)(img),
                                      jax_transform(32, prefer_native=False)(img))


def _dataset():
    rng = np.random.RandomState(3)
    return [{"image": rng.rand(3, 32, 32).astype(np.float32), "image_id": i,
             "caption": f"a photo number {i}", "all_captions": [f"a photo number {i}", "a picture"]}
            for i in range(2)]


def test_ensemble_outcomes_equal_jax(adapters, tmp_path):
    """The schedule [clean, apgd gt=0, apgd gt=1, prev-best full] with the
    worst-case bookkeeping, float32 adapters on both sides: the same
    captions, scores, winning gt per image and remaining set. The score is
    CIDEr against the clean caption, so every attack that changes a caption
    lowers it."""
    j, p = adapters
    ds = _dataset()
    x = np.stack([it["image"] for it in ds])
    clean = j.get_outputs(jnp.asarray(x), [j.get_caption_prompt(None)] * 2, max_new_tokens=4)
    refs = {i: [clean[i], "tok1 tok2"] for i in range(2)}
    idf = JIDF(list(refs.values()))

    def score_fn(caption, item):
        return idf.score(caption, refs[item["image_id"]]) * 100.0

    def prompt_fn(model, item, spec, query_only):
        if query_only:
            return model.get_caption_prompt(None)
        caps = item["all_captions"]
        return model.get_caption_prompt(caps[(spec.gt_idx or 0) % len(caps)])

    def schedule(mod):
        return [mod.AttackSpec(kind="none"), mod.AttackSpec(gt_idx=0, n_iter=3),
                mod.AttackSpec(gt_idx=1, n_iter=3),
                mod.AttackSpec(precision="full", init_from_best=True, n_iter=3)]

    kw = dict(eps=16 / 255, score_fn=score_fn, prompt_fn=prompt_fn, threshold=-1.0,
              max_new_tokens=4, verbose=False)
    ref = JE.EnsembleRunner(lambda prec: j, out_dir=str(tmp_path / "jax"), **kw).run(
        ds, schedule(JE), seed=0)
    got = PE.EnsembleRunner(lambda prec: p, out_dir=str(tmp_path / "port"), **kw).run(
        ds, schedule(PE), seed=0)
    assert got["outputs"] == ref["outputs"]
    assert got["scores"] == pytest.approx(ref["scores"], abs=1e-9)
    assert got["left_to_attack"] == ref["left_to_attack"]
    assert json.loads((tmp_path / "port" / "gt_dict.json").read_text()) == \
        json.loads((tmp_path / "jax" / "gt_dict.json").read_text())
    for i in range(2):
        adv = np.load(tmp_path / "port" / "adv" / f"{i}.npy")
        assert np.abs(adv - ds[i]["image"]).max() <= 16 / 255 + 1e-6 and 0 <= adv.min() <= adv.max() <= 1
    assert got["attack_iters"] == 3 * 2 * 3


def test_ensemble_splits_its_wall_time_and_spans_each_group(adapters, capsys):
    """`run` reports the attack, captioning and scoring seconds on the clock
    of its wall time, prints them on the stage line, and under a profiler
    window spans each group with its three phases."""
    from torch.profiler import ProfilerActivity, profile

    from robustvlm_tpu_torch.utils import profiling

    _, p = adapters
    ds = _dataset()
    runner = PE.EnsembleRunner(
        lambda prec: p, eps=16 / 255, score_fn=lambda caption, item: 50.0,
        prompt_fn=lambda model, item, spec, query_only: model.get_caption_prompt(
            None if query_only else item["caption"]),
        threshold=-1.0, max_new_tokens=3, verbose=True, batch_size=2)
    schedule = [PE.AttackSpec(gt_idx=0, n_iter=2)]
    res = runner.run(ds, schedule, seed=0)
    parts = [res["attack_s"], res["caption_s"], res["score_s"]]
    assert all(s > 0 for s in parts) and sum(parts) <= res["wall_s"]
    line = capsys.readouterr().out
    assert "attack" in line and "caption" in line and "score" in line
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        runner.run(ds, schedule, seed=0)
    log = profiling.spans()
    profiling.reset()
    (group,) = [s for s in log if s["name"] == "ensemble.group"]
    kids = [s for s in log if s["parent"] == group["id"]]
    assert [s["name"] for s in kids] == ["ensemble.attack", "ensemble.caption", "ensemble.score"]
    (attack,) = [s for s in log if s["name"] == "apgd.attack"]
    assert attack["parent"] == kids[0]["id"] and attack["root"] == group["id"]


def _coco_fixture(tmp_path):
    """The COCO-format fixture of tests/test_vlm_eval.py (TestRunEvaluationE2E)."""
    img_dir = tmp_path / "images"
    img_dir.mkdir(exist_ok=True)
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(2):
        name = f"im{i}.png"
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(img_dir / name)
        images.append({"id": i, "file_name": name})
        anns.append({"image_id": i, "caption": f"a photo number {i}"})
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns}))
    return img_dir, ann


def test_cli_coco_apgd_on_cpu(tmp_path):
    from robustvlm_tpu_torch.vlm_eval.run_evaluation import main

    img_dir, ann = _coco_fixture(tmp_path)
    argv = ["--device", "cpu", "--model", "llava", "--model_size", "test-tiny", "--eval_coco",
            "--coco_image_dir", str(img_dir), "--coco_annotations", str(ann), "--attack", "apgd",
            "--eps", "8", "--n_iter", "2", "--num_samples", "2", "--max_new_tokens", "4",
            "--out_base_path", str(tmp_path / "out")]
    res = main(argv)
    assert json.loads((tmp_path / "out" / "results.json").read_text())["coco"] == res["coco"]
    assert res["coco"]["cider"] == 0.0  # hash-token captions share no n-gram with the references
    assert res["coco"]["attack_iters"] == 2 * 2
    saved = json.loads((tmp_path / "out" / "coco" / "ensemble_state.json").read_text())
    assert all(isinstance(v, str) for v in saved["best_outputs"].values())
    for i in range(2):
        adv = np.load(tmp_path / "out" / "coco" / "adv" / f"{i}.npy")
        clean = np.asarray(Image.open(img_dir / f"im{i}.png"), np.float32).transpose(2, 0, 1) / 255
        assert adv.shape == (3, 32, 32) and np.abs(adv - clean).max() <= 8 / 255 + 1e-6


def test_cli_builds_weights_once_per_run(tmp_path, monkeypatch):
    from robustvlm_tpu_torch.vlm_eval import run_evaluation as R

    built = []
    real = R.build_llava_models
    monkeypatch.setattr(R, "build_llava_models", lambda *a: built.append(a) or real(*a))
    img_dir, ann = _coco_fixture(tmp_path)
    res = R.main(["--device", "cpu", "--model_size", "test-tiny", "--eval_coco", "--eval_flickr30",
                  "--coco_image_dir", str(img_dir), "--coco_annotations", str(ann),
                  "--flickr_image_dir", str(img_dir), "--flickr_annotations", str(ann),
                  "--attack", "none", "--num_samples", "1", "--num_trials", "2",
                  "--max_new_tokens", "2", "--out_base_path", str(tmp_path / "out")])
    assert len(built) == 1 and built[0][1] == {"half"}
    assert {"coco_shots0_trial0", "flickr_shots0_trial1", "coco_shots0_mean"} <= set(res)


def test_ensemble_every_stage_one_copy_per_precision(tmp_path):
    """Threshold -inf keeps the image in every stage, so the float32 stage
    runs; the two precisions' models hold one float32 copy of every
    parameter and one bf16 copy of the matrices."""
    from robustvlm_tpu_torch.vlm_eval import run_evaluation as R

    img_dir, ann = _coco_fixture(tmp_path)
    args = R.build_parser().parse_args([
        "--device", "cpu", "--model_size", "test-tiny", "--eval_coco", "--attack", "ensemble",
        "--n_iter", "2", "--num_samples", "1", "--max_new_tokens", "2",
        "--out_base_path", str(tmp_path / "out")])
    schedule = R.attack_schedule(args)
    models = R.build_llava_models(args, {s.precision for s in schedule}, torch.device("cpu"))
    held = {t.data_ptr(): t.numel() * t.element_size()
            for m in models.values() for t in m.state_dict().values()}
    n_params = sum(t.numel() for t in models["full"].state_dict().values())
    n_matrix = sum(t.numel() for t in models["half"].state_dict().values() if t.dtype == torch.bfloat16)
    assert sum(held.values()) == 4 * n_params + 2 * n_matrix
    res = R.evaluate_captioning(args, "coco", str(img_dir), str(ann), models=models,
                                threshold=-float("inf"))
    state = json.loads((tmp_path / "out" / "coco" / "ensemble_state.json").read_text())
    assert state["stages_done"] == len(schedule) == 7
    assert res["attack_iters"] == 6 * 2


@pytest.mark.parametrize("flag, error, match", [
    # a robust tower replaces the tower of a loaded checkpoint: without one
    # it would be silently dropped for random weights
    (["--vision_encoder_pretrained", "x", "--eval_coco"], ValueError, "--llava_ckpt"),
    # BLIP-2 reads --blip2_ckpt (it raised NotImplementedError before it was ported)
    (["--model", "blip2", "--blip2_ckpt", "x", "--eval_coco"], FileNotFoundError, "no checkpoint"),
    # few-shot demo images need the interleaved-media model, as in JAX
    (["--shots", "2", "--eval_coco"], ValueError, "open_flamingo"),
    (["--llava_ckpt", "x", "--eval_coco"], FileNotFoundError, "no checkpoint")])
def test_cli_unported_parts_raise(tmp_path, flag, error, match):
    from robustvlm_tpu_torch.vlm_eval.run_evaluation import main

    img_dir, ann = _coco_fixture(tmp_path)
    base = ["--device", "cpu", "--model_size", "test-tiny", "--coco_image_dir", str(img_dir),
            "--coco_annotations", str(ann), "--out_base_path", str(tmp_path / "out")]
    with pytest.raises(error, match=match):
        main(base + flag)


def test_cli_defaults_to_cuda(monkeypatch):
    from robustvlm_tpu_torch.vlm_eval.run_evaluation import build_parser, main

    assert build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--eval_coco"])
