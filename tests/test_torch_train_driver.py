"""The port's training CLI (robustvlm_tpu_torch.train.driver) on the CPU at
test-tiny, and its data layer against the JAX package's.

- `driver.main` for 2 steps: args.json, the `[step]`/`[eval]` metrics in
  metrics.jsonl, the summary's step averages, the checkpoint policy's files, `--resume` restoring the
  model and the optimizer's update count, and the exported visual tower
  loading back through `visual_from_openai` to the same embedding (exact:
  the export transposes and the import transposes back);
- `DataLoader` yields the JAX loader's batches, in its order, from the same
  seed over two epochs (exact);
- `ImageFolderDataset` on PNGs the test writes equals JAX's with its PIL
  transform (`prefer_native=False`; the same PIL code, exact);
- without `--device` and without a GPU the CLI raises.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from robustvlm_tpu.data import loaders as jax_loaders
from robustvlm_tpu_torch.data import loaders
from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS
from robustvlm_tpu_torch.models.clip.convert import visual_from_openai
from robustvlm_tpu_torch.ops.image import normalize_clip
from robustvlm_tpu_torch.train import driver

torch.set_num_threads(1)

TINY = ["--device", "cpu", "--clip_model_name", "test-tiny", "--dataset", "synthetic",
        "--batch_size", "8", "--warmup", "1", "--iterations_adv", "2"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    argv = TINY + ["--steps", "2", "--grad_accum", "2", "--loss", "ce", "--inner_loss", "ce",
                   "--attack", "pgd", "--output_dir", str(out)]
    return out, driver.main(argv)


def test_main_writes_args_metrics_and_checkpoints(run):
    out, res = run
    assert json.loads((out / "args.json").read_text())["grad_accum"] == 2
    recs = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["imgs_per_sec"] > 0 for r in steps)
    assert any("eval/racc" in r for r in recs) and recs[-1]["summary/steps"] == 2
    # equal batches: the summary's averages are the logged steps' means
    for k in ("loss", "cos_sim", "acc", "racc"):
        assert recs[-1][f"summary/avg_{k}"] == pytest.approx(np.mean([r[k] for r in steps]), rel=1e-12)
    names = {p.name for p in (out / "checkpoints").iterdir()}
    assert {"step_1", "step_1_opt", "step_2", "step_2_opt", "final", "final_opt", "final.pt"} <= names
    assert res.steps == 2 and res.train_step.optimizer.count == 2
    assert res.eval_metrics is not None and set(res.metrics) >= {"loss", "cos_sim", "racc", "acc"}
    moved = any(not torch.equal(a, b) for a, b in zip(res.model.visual.parameters(),
                                                      res.model_orig.visual.parameters()))
    fresh = CLIP(CLIP_CONFIGS["test-tiny"]).init_random_(0)
    assert moved and all(torch.equal(a, b) for a, b in zip(res.model_orig.parameters(), fresh.parameters()))


def test_exported_visual_tower_round_trips(run):
    out, res = run
    sd = torch.load(out / "checkpoints" / "final.pt")
    assert "conv1.weight" in sd and "transformer.resblocks.1.attn.in_proj_weight" in sd
    cfg = CLIP_CONFIGS["test-tiny"]
    back = CLIP(cfg)
    full = res.model.state_dict()
    full.update(visual_from_openai(sd, cfg))
    back.load_state_dict(full)
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(back.encode_image(normalize_clip(x)), res.model.encode_image(normalize_clip(x)))


def test_resume_restores_model_and_optimizer(run, tmp_path):
    out, _ = run
    for name in ("step_1", "step_1_opt"):
        shutil.copytree(out / "checkpoints" / name, tmp_path / "checkpoints" / name)
    argv = TINY + ["--steps", "1", "--start_step", "1", "--resume", "step_1", "--loss", "ce",
                   "--inner_loss", "ce", "--attack", "pgd", "--output_dir", str(tmp_path)]
    res = driver.main(argv)
    assert res.steps == 1 and res.train_step.optimizer.count == 1
    saved = torch.load(tmp_path / "checkpoints" / "step_1" / "params.pt")
    for k, v in res.model.state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_dataloader_order_matches_jax():
    ds = loaders.SyntheticClassificationDataset(n=20, size=8)
    jds = jax_loaders.SyntheticClassificationDataset(n=20, size=8)
    ours = loaders.DataLoader(ds, 4, seed=3)
    theirs = jax_loaders.DataLoader(jds, 4, seed=3)
    for _ in range(2):  # two epochs: the order is reshuffled from seed + epoch
        got, ref = list(ours), list(theirs)
        assert len(got) == len(ref) == 5
        for (x, y), (jx, jy) in zip(got, ref):
            assert np.array_equal(x, jx) and np.array_equal(y, jy)
    assert len(loaders.DataLoader(ds, 6, drop_last=False)) == 4


def test_prefetch_iter_reraises_the_producers_error():
    def bad():
        yield 1
        raise KeyError("boom")

    it = loaders.prefetch_iter(bad())
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)


def test_image_folder_dataset_matches_jax_pil_path(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(0)
    for cls, shapes in (("cat", [(40, 30), (25, 50)]), ("dog", [(33, 33)])):
        (tmp_path / cls).mkdir()
        for i, (h, w) in enumerate(shapes):
            Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(tmp_path / cls / f"{i}.png")
    (tmp_path / "dog" / "notes.txt").write_text("not an image")
    ours = loaders.ImageFolderDataset(
        str(tmp_path), transform=loaders.default_image_transform(16, prefer_native=False))
    theirs = jax_loaders.ImageFolderDataset(
        str(tmp_path), transform=jax_loaders.default_image_transform(16, prefer_native=False))
    assert ours.class_to_idx == theirs.class_to_idx == {"cat": 0, "dog": 1}
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        (x, y), (jx, jy) = ours[i], theirs[i]
        assert y == jy and x.shape == (3, 16, 16) and np.array_equal(x, jx)


def test_cli_without_device_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default resolves to cuda")
    argv = [a for a in TINY if a not in ("--device", "cpu")] + ["--output_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(argv)


def test_meters_logger_and_step_timer(tmp_path):
    from robustvlm_tpu.utils.meters import AverageMeter as JaxMeter
    from robustvlm_tpu_torch.utils.logging import MetricLogger
    from robustvlm_tpu_torch.utils.meters import AverageMeter
    from robustvlm_tpu_torch.utils.profiling import trace

    ours, theirs = AverageMeter("loss"), JaxMeter("loss")
    for v, n in ((1.0, 2), (4.0, 1), (None, 5)):
        ours.update(v, n)
        theirs.update(v, n)
    assert (ours.avg, ours.count, repr(ours)) == (theirs.avg, theirs.count, repr(theirs)) == (2.0, 3, repr(ours))
    log = MetricLogger(str(tmp_path), use_wandb=False)
    log.log({"loss": torch.tensor(0.5)}, step=3)
    log.summary({"steps": 3})
    recs = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert recs[0]["loss"] == 0.5 and recs[0]["step"] == 3 and recs[1]["summary/steps"] == 3.0
    with trace(str(tmp_path / "trace")):
        torch.ones(3).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
