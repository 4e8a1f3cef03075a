"""The port's OpenFlamingo eval layers against the JAX package's: the
FlamingoEvalModel's teacher-forcing tensors, loss (1e-5 relative) and
captions; the stream; the few-shot demo pool and stacked frames; the frame
masks; the ensemble's outcomes with few-shot frames and a context mask (not
its trajectories: sign() turns 1-ulp gradient differences into different
valid ones); and the run_evaluation CLI with --model open_flamingo on the
CPU. Weights: the JAX `test-tiny` init carried across, both gates of every
cross-attention block opened to 0.5 (at the reference's 0 the model ignores
its image)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from robustvlm_tpu.models.flamingo import model as JF
from robustvlm_tpu.vlm_eval import ensemble as JE
from robustvlm_tpu.vlm_eval import eval_models as JM
from robustvlm_tpu.vlm_eval import fewshot as JS
from robustvlm_tpu_torch.models.flamingo import convert as PC
from robustvlm_tpu_torch.models.flamingo import model as PF
from robustvlm_tpu_torch.vlm_eval import ensemble as PE
from robustvlm_tpu_torch.vlm_eval import eval_models as PM
from robustvlm_tpu_torch.vlm_eval import fewshot as PS

torch.set_num_threads(1)

MEDIA = 511  # WordTokenizer(512).media_token_id


@pytest.fixture(scope="module")
def adapters():
    """(JAX, port) float32 FlamingoEvalModels on the same open-gated weights."""
    jcfg = dataclasses.replace(JF.FLAMINGO_CONFIGS["test-tiny"], media_token_id=MEDIA)
    tree = jax.jit(JF.init_flamingo_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    for gate in ("attn_gate", "ff_gate"):
        tree["xattn"][gate] = jnp.full_like(tree["xattn"][gate], 0.5)
    pcfg = dataclasses.replace(PF.FLAMINGO_CONFIGS["test-tiny"], media_token_id=MEDIA)
    model = PF.Flamingo.from_state(pcfg, PC.params_from_jax(jax.tree.map(np.asarray, tree)))
    j = JM.FlamingoEvalModel(tree, jcfg, JM.WordTokenizer(), compute_dtype=jnp.float32)
    p = PM.FlamingoEvalModel(model, PM.WordTokenizer(), compute_dtype=torch.float32)
    return j, p


def _prompts(m):
    ctx = m.get_caption_prompt("two dogs on a sofa") + m.get_caption_prompt("a red bus")
    return [ctx + m.get_caption_prompt("a cat asleep on the grass"),
            ctx.replace("<image>", "") + m.get_caption_prompt("a man: riding a wave")]


@pytest.mark.parametrize("pad_to_multiple", [None, 16])
def test_set_inputs_tensors_equal_jax(adapters, pad_to_multiple):
    j, p = adapters
    j.pad_to_multiple = p.pad_to_multiple = pad_to_multiple
    try:
        assert _prompts(p) == _prompts(j)
        j.set_inputs(_prompts(j))
        p.set_inputs(_prompts(p))
        for name in ("_lang", "_labels", "_mask"):
            np.testing.assert_array_equal(getattr(p, name).numpy(), np.asarray(getattr(j, name)),
                                          err_msg=name)
        if pad_to_multiple:
            assert p._lang.shape[1] % pad_to_multiple == 0
    finally:
        j.pad_to_multiple = p.pad_to_multiple = None


@pytest.mark.parametrize("ndim", [4, 6])
def test_loss_equals_jax(adapters, ndim):
    """(B, C, H, W) is lifted to one frame of one media slot; (B, T, F, C, H, W)
    with the prompts' media count."""
    j, p = adapters
    j.set_inputs(_prompts(j))
    p.set_inputs(_prompts(p))
    shape = (2, 3, 32, 32) if ndim == 4 else (2, 3, 1, 3, 32, 32)
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: j(v))(jnp.asarray(x)))
    got = p(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=0)


def test_captions_and_stream_equal_jax(adapters):
    """get_outputs' text equal to JAX's; the stream's last chunk equals it."""
    j, p = adapters
    x = np.random.RandomState(1).rand(2, 3, 32, 32).astype(np.float32)
    prompts = [p.get_caption_prompt("a red bus") + p.get_caption_prompt(None),
               p.get_caption_prompt(None)]
    ref = j.get_outputs(jnp.asarray(x), prompts, max_new_tokens=5)
    got = p.get_outputs(torch.from_numpy(x), prompts, max_new_tokens=5)
    assert got == ref and all(got)
    chunks = list(PM.stream_outputs(p, torch.from_numpy(x[1:]), prompts[1], max_new_tokens=5))
    assert chunks[-1] == got[1]


def _pool(n=6):
    rng = np.random.RandomState(3)
    return [{"image": rng.rand(3, 32, 32).astype(np.float32), "image_id": 100 + i,
             "caption": f"demo caption {i}", "all_captions": [f"demo caption {i}"]}
            for i in range(n)]


@pytest.mark.parametrize("num_shots", [0, 2])
def test_fewshot_items_equal_jax(adapters, num_shots):
    """The query set, each item's demos, the stacked frames (query last) and
    the context text: text-only demos at 0 shots, still 2 of them."""
    j, p = adapters
    pool = _pool()
    js, ps = JS.get_query_set(pool, 4, seed=7), PS.get_query_set(pool, 4, seed=7)
    assert [d["image_id"] for d in ps] == [d["image_id"] for d in js]
    eff = PS.compute_effective_num_shots(num_shots, "open_flamingo")
    assert eff == JS.compute_effective_num_shots(num_shots, "open_flamingo") == (num_shots or 2)
    base = _pool(3)[1:]  # item 101 can be its own demo: it must be left out
    jd = JS.FewShotDataset(base, js, num_shots=num_shots, effective_num_shots=eff, seed=7)
    pd = PS.FewShotDataset(base, ps, num_shots=num_shots, effective_num_shots=eff, seed=7)
    for i in range(len(base)):
        a, b = pd[i], jd[i]
        assert [d["image_id"] for d in a["demos"]] == [d["image_id"] for d in b["demos"]]
        assert base[i]["image_id"] not in [d["image_id"] for d in a["demos"]]
        np.testing.assert_array_equal(a["image"], b["image"])
        expect = (3, 32, 32) if num_shots == 0 else (num_shots + 1, 1, 3, 32, 32)
        assert a["image"].shape == expect
        if num_shots:
            np.testing.assert_array_equal(a["image"][-1, 0], base[i]["image"])
        ctx = PS.build_context_text(p, a["demos"], num_shots)
        assert ctx == JS.build_context_text(j, b["demos"], num_shots)
        assert ctx.count("<image>") == num_shots and ctx.count("<|endofchunk|>") == eff
    assert PS.sample_demos(ps, 2, 7, 0) == JS.sample_demos(js, 2, 7, 0)


@pytest.mark.parametrize("mode", ["context", "query", "none", 1, "only:1"])
def test_frame_mask_equals_jax(mode):
    shape = (2, 3, 1, 3, 4, 4)
    got = PM.make_frame_mask(shape, mode)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(JM.make_frame_mask(shape, mode)))


def test_ensemble_outcomes_with_context_mask_equal_jax(adapters, tmp_path):
    """One-shot items (2 frames, the query last) through [clean, apgd gt=0]
    with mask_out='context' in both runners: the same
    captions, scores and remaining set; the context frame never moves, the
    query frame stays in the ball and [0,1]."""
    j, p = adapters
    pool = _pool()
    ds = PS.FewShotDataset(_pool(2), pool[2:], num_shots=1, seed=0)
    items = [ds[i] for i in range(2)]
    prompts = [p.get_caption_prompt(it["demos"][0]["caption"]) + p.get_caption_prompt(None)
               for it in items]
    clean = j.get_outputs(jnp.asarray(np.stack([it["image"] for it in items])), prompts,
                          max_new_tokens=4)
    refs = {it["image_id"]: [clean[k], "tok1 tok2"] for k, it in enumerate(items)}

    def score_fn(caption, item):  # 0 for the clean caption, -1 for a changed one
        return -float(caption != refs[item["image_id"]][0])

    def prompt_fn(model, item, spec, query_only):
        ctx = PS.build_context_text(model, item["demos"], 1)
        if query_only:
            return ctx + model.get_caption_prompt(None)
        return ctx + model.get_caption_prompt(item["all_captions"][0])

    def schedule(mod):
        return [mod.AttackSpec(kind="none"), mod.AttackSpec(gt_idx=0, n_iter=3)]

    kw = dict(eps=16 / 255, score_fn=score_fn, prompt_fn=prompt_fn, threshold=-2.0,
              max_new_tokens=4, verbose=False, mask_out="context")
    ref = JE.EnsembleRunner(lambda prec: j, out_dir=str(tmp_path / "jax"), **kw).run(
        items, schedule(JE), seed=0)
    got = PE.EnsembleRunner(lambda prec: p, out_dir=str(tmp_path / "port"), **kw).run(
        items, schedule(PE), seed=0)
    assert got["outputs"] == ref["outputs"]
    assert got["scores"] == pytest.approx(ref["scores"], abs=1e-9)
    assert got["left_to_attack"] == ref["left_to_attack"]
    for it in items:
        adv = np.load(tmp_path / "port" / "adv" / f"{it['image_id']}.npy")
        np.testing.assert_array_equal(adv[0], it["image"][0])  # the context frame
        assert np.abs(adv[1] - it["image"][1]).max() <= 16 / 255 + 1e-6
        assert np.abs(adv[1] - it["image"][1]).max() > 0
        assert 0 <= adv.min() <= adv.max() <= 1
    assert got["attack_iters"] == 2 * 3


def _coco_fixture(tmp_path, n=4):
    img_dir = tmp_path / "images"
    img_dir.mkdir(exist_ok=True)
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(n):
        name = f"im{i}.png"
        Image.fromarray(rng.randint(0, 255, (40, 48, 3), np.uint8)).save(img_dir / name)
        images.append({"id": i, "file_name": name})
        anns += [{"image_id": i, "caption": f"a photo number {i} of {w}"} for w in ("a", "b")]
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns}))
    return img_dir, ann


def _cli_argv(img_dir, ann, out, *flags):
    return ["--device", "cpu", "--model", "open_flamingo", "--model_size", "test-tiny",
            "--eval_coco", "--coco_image_dir", str(img_dir), "--coco_annotations", str(ann),
            "--eps", "8", "--n_iter", "2", "--num_samples", "2", "--max_new_tokens", "4",
            "--out_base_path", str(out), *flags]


def test_cli_open_flamingo_apgd_on_cpu(tmp_path):
    """--attack apgd at 0 shots (2 text-only demos): x_adv in the ball and
    [0,1] at 32 px, a caption per image, finite CIDEr."""
    from robustvlm_tpu_torch.vlm_eval.datasets import CaptionDataset
    from robustvlm_tpu_torch.vlm_eval.run_evaluation import main

    img_dir, ann = _coco_fixture(tmp_path)
    res = main(_cli_argv(img_dir, ann, tmp_path / "out", "--attack", "apgd"))["coco"]
    assert np.isfinite(res["cider"]) and res["attack_iters"] == 2 * 2
    state = json.loads((tmp_path / "out" / "coco" / "ensemble_state.json").read_text())
    ds = CaptionDataset(str(img_dir), str(ann), size=32, split="val")
    for k, cap in state["best_outputs"].items():
        assert isinstance(cap, str)
        x = ds[[str(i) for i in ds.ids].index(k)]["image"]
        adv = np.load(tmp_path / "out" / "coco" / "adv" / f"{k}.npy")
        assert adv.shape == x.shape == (3, 32, 32)
        assert np.abs(adv - x).max() <= 8 / 255 + 1e-6 and 0 <= adv.min() <= adv.max() <= 1


def test_cli_open_flamingo_one_shot_ensemble_context_mask(tmp_path):
    """--attack ensemble --shots 1 --mask_out context through main (random
    weights caption under COCO's threshold, so it stops after the clean
    pass), then every stage with the threshold at -inf: each saved x_adv is
    (2, 1, 3, 32, 32), its context frame a clean demo image, its query frame
    in the ball (with CIDEr 0 at every stage the clean pass's image stays
    the worst case; the ensemble test above shows the masked attack)."""
    from robustvlm_tpu_torch.vlm_eval import run_evaluation as R
    from robustvlm_tpu_torch.vlm_eval.datasets import CaptionDataset

    img_dir, ann = _coco_fixture(tmp_path)
    flags = ("--attack", "ensemble", "--shots", "1", "--mask_out", "context")
    with pytest.warns(UserWarning, match="EVAL annotations"):
        res = R.main(_cli_argv(img_dir, ann, tmp_path / "out", *flags))
    assert set(res) == {"coco_shots1", "total_wall_s"}
    args = R.build_parser().parse_args(_cli_argv(img_dir, ann, tmp_path / "inf", *flags))
    models = R.build_models(args, {"half", "full"}, torch.device("cpu"))
    with pytest.warns(UserWarning, match="EVAL annotations"):
        res = R.evaluate_captioning(args, "coco", str(img_dir), str(ann), models=models,
                                    num_shots=1, threshold=-float("inf"))
    assert res["attack_iters"] == 2 * 6 * 2
    out = tmp_path / "inf" / "coco_shots1"
    state = json.loads((out / "ensemble_state.json").read_text())
    assert state["stages_done"] == 7
    ds = CaptionDataset(str(img_dir), str(ann), size=32, split="val")
    clean = {str(iid): ds[k]["image"] for k, iid in enumerate(ds.ids)}
    for k in state["best_outputs"]:
        adv = np.load(out / "adv" / f"{k}.npy")
        assert adv.shape == (2, 1, 3, 32, 32) and 0 <= adv.min() <= adv.max() <= 1
        assert any(np.array_equal(adv[0, 0], c) for i, c in clean.items() if i != k)  # a clean demo
        assert np.abs(adv[1, 0] - clean[k]).max() <= 8 / 255 + 1e-6
        assert isinstance(state["best_outputs"][k], str)


def test_cli_zero_gates_by_default():
    """The CLI's random OpenFlamingo keeps the reference's zero gates."""
    from robustvlm_tpu_torch.vlm_eval import run_evaluation as R

    args = R.build_parser().parse_args(["--device", "cpu", "--model", "open_flamingo",
                                        "--model_size", "test-tiny"])
    models = R.build_models(args, {"half"}, torch.device("cpu"))
    adapter = R.build_eval_model(args, "half", models)
    assert isinstance(adapter, PM.FlamingoEvalModel) and adapter.cfg.media_token_id == MEDIA
    assert all(float(b.attn_gate) == 0 and float(b.ff_gate) == 0 for b in models["half"].xattn)
    assert R._image_size(args) == 32
    args.model_size = "7b"
    assert R._image_size(args) == 224


def test_cli_loads_the_three_checkpoints(tmp_path):
    """--of_ckpt, --mpt_ckpt and --clip_ckpt (a full open_clip state dict)
    saved with torch.save: the CLI's models hold what the loader reads, in
    both precisions' layouts."""
    from test_torch_flamingo import _random_checkpoints

    from robustvlm_tpu_torch.models.flamingo.import_torch import load_flamingo_checkpoint
    from robustvlm_tpu_torch.vlm_eval import run_evaluation as R

    of, mpt, visual = _random_checkpoints()
    paths = {}
    for name, sd in (("of", of), ("mpt", mpt), ("clip", {"visual." + k: v for k, v in visual.items()})):
        paths[name] = str(tmp_path / f"{name}.pt")
        torch.save(sd, paths[name])
    args = R.build_parser().parse_args([
        "--device", "cpu", "--model", "open_flamingo", "--model_size", "test-tiny",
        "--of_ckpt", paths["of"], "--mpt_ckpt", paths["mpt"], "--clip_ckpt", paths["clip"]])
    models = R.build_models(args, {"half", "full"}, torch.device("cpu"))
    ref = load_flamingo_checkpoint(of, models["full"].cfg, mpt_path=mpt, visual_path=visual)
    full, half = models["full"].state_dict(), models["half"].state_dict()
    for k, v in ref.items():
        assert torch.equal(full[k], v), k
        assert torch.equal(half[k], v if v.dim() < 2 or k.startswith("perceiver.")
                           else v.to(torch.bfloat16)), k
