"""The port's benchmark modules (robustvlm_tpu_torch.benchmark) against the
JAX package's (robustvlm_tpu.benchmark) on the same inputs.

- metrics (top-k accuracy, mean per-class recall, multilabel mAP,
  recall@k, retrieval both ways): bit-equal on seeded arrays;
- templates and classnames: equal for every language table and dataset;
- the webdataset reader over tar shards the tests write: images bit-equal
  through both C++ transforms, the same labels, multi-hot labels and
  captions; `WdsDataset` metadata over local and file:// roots, the
  hub-URL split and `build_dataset`'s dispatch;
- the tfds/vtab adapter through a fake `tensorflow_datasets` (the real one
  is optional), as tests/test_benchmark.py does it;
- BLEU and ROUGE-L: equal to JAX's;
- `run_classification` at test-tiny on one set of weights: clean metrics
  equal to JAX's; under AutoAttack by outcome (whole attack trajectories
  need not match): at eps 0 nothing is fooled, at 32/255 everything;
- the linear probe's weights within 1e-5 (relative to the largest) of
  optax's after the same steps over the same minibatches.
"""

import io
import json
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from robustvlm_tpu.benchmark import builder as jbuilder
from robustvlm_tpu.benchmark import captioning as jcap
from robustvlm_tpu.benchmark import linear_probe as jlp
from robustvlm_tpu.benchmark import retrieval as jret
from robustvlm_tpu.benchmark import templates as jtpl
from robustvlm_tpu.benchmark import tfds_adapter as jtfds
from robustvlm_tpu.benchmark import zeroshot as jzs
from robustvlm_tpu.eval.classifier import make_zero_shot_classifier as jax_classifier
from robustvlm_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS
from robustvlm_tpu.models.clip import init_clip_params
from robustvlm_tpu_torch.benchmark import builder, captioning, linear_probe, retrieval, templates, tfds_adapter
from robustvlm_tpu_torch.benchmark import zeroshot
from robustvlm_tpu_torch.data import native
from robustvlm_tpu_torch.eval.classifier import make_zero_shot_classifier
from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, params_from_jax

import test_benchmark
from test_torch_native_image import jax_native_transform

torch.set_num_threads(1)
LANGUAGES = ("en", "ar", "cn", "it", "jp")


# ------------------------------------------------------------------ metrics
def test_metrics_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(40, 7).astype(np.float32)
    y = rng.randint(0, 7, 40)
    assert zeroshot.accuracy_topk(logits, y, (1, 3, 5)) == jzs.accuracy_topk(logits, y, (1, 3, 5))
    assert zeroshot.mean_per_class_recall(logits, y) == jzs.mean_per_class_recall(logits, y)
    multi = (rng.rand(40, 7) > 0.7).astype(np.float32)
    multi[:, 3] = 0  # a class without positives is skipped
    assert zeroshot.multilabel_average_precision(logits, multi) == jzs.multilabel_average_precision(logits, multi)
    scores, pos = rng.randn(9, 12), rng.rand(9, 12) > 0.8
    for k in (1, 5):
        assert np.array_equal(retrieval.recall_at_k(scores, pos, k), jret.recall_at_k(scores, pos, k))
    im, tx = rng.randn(6, 16).astype(np.float32), rng.randn(14, 16).astype(np.float32)
    t2i = rng.randint(0, 6, 14)
    assert retrieval.evaluate_retrieval(im, tx, t2i) == jret.evaluate_retrieval(im, tx, t2i)


# ---------------------------------------------------------------- templates
@pytest.mark.parametrize("language", LANGUAGES)
def test_templates_and_classnames_every_language(language):
    tpl_file = ("zeroshot_templates.json" if language == "en"
                else f"{language}_zeroshot_classification_templates.json")
    for ds in list(templates._load_json(tpl_file)) + ["no-such-dataset"]:
        assert templates.get_templates(ds, language=language) == jtpl.get_templates(ds, language=language)
    names = (["cifar10", "cifar100", "stl10", "imagenet1k", "imagenet-r"]
             + list(templates._load_json("en_classnames.json")) if language == "en"
             else list(templates._load_json(f"{language}_classnames.json")))
    for ds in names:
        assert templates.get_classnames(ds, language=language) == jtpl.get_classnames(ds, language=language)
    with pytest.raises(KeyError):
        templates.get_classnames("no-such-dataset", language=language)


def test_imagenet_classnames_and_prompts():
    assert templates.imagenet_classnames() == jtpl.imagenet_classnames()
    assert len(templates.imagenet_classnames()) == 1000
    assert templates.STD_TEMPLATE == jtpl.STD_TEMPLATE
    tpls = ["a photo of a {c}.", "itap of a {}."]
    assert templates.format_prompts(tpls, "dog") == jtpl.format_prompts(tpls, "dog")
    assert templates.target_to_seed() == jtpl.target_to_seed()


# ------------------------------------------------------------- webdatasets
def _png(seed, h=40, w=52):
    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def _write_shard(path, samples):
    """samples: [(key, {ext: bytes})] in order."""
    with tarfile.open(path, "w") as tf:
        for key, parts in samples:
            for ext, data in parts.items():
                info = tarfile.TarInfo(f"{key}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def _npy(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _shard_samples(kind, start, n):
    out = []
    for i in range(start, start + n):
        parts = {"png": _png(i)}
        if kind == "classification":
            parts["cls"] = str(i % 3).encode()
        elif kind == "multilabel":
            parts["npy"] = _npy((np.arange(4) == i % 4).astype(np.float32))
        elif i % 2:
            parts["txt"] = f"caption a {i}\ncaption b {i}\n".encode()
        else:
            parts["json"] = json.dumps({"caption": f"json caption {i}"}).encode()
        out.append((f"{i:06d}", parts))
    out.insert(1, ("no_image", {"cls": b"1"}))  # a sample without an image is skipped
    return out


def write_wds_root(root, kind="classification", splits=("test",), n_shards=2, per_shard=3):
    """A reference-layout webdataset root: <split>/{0..}.tar and nshards.txt,
    with classnames and templates (classification) or dataset_type.txt."""
    for split in splits:
        (root / split).mkdir(parents=True, exist_ok=True)
        for s in range(n_shards):
            _write_shard(root / split / f"{s}.tar", _shard_samples(kind, s * per_shard, per_shard))
        (root / split / "nshards.txt").write_text(str(n_shards))
    if kind == "classification":
        (root / "classnames.txt").write_text("aaa\nbbb\nccc\n")
        (root / "zeroshot_classification_templates.txt").write_text("a photo of a {c}.\nart of {c}\n")
    else:
        (root / "dataset_type.txt").write_text("retrieval" if kind == "captions" else kind)
    return root


@pytest.mark.parametrize("kind", ["classification", "multilabel", "captions"])
def test_shard_reader_matches_jax(tmp_path, kind):
    shard = tmp_path / "0.tar"
    _write_shard(shard, _shard_samples(kind, 0, 5))
    mode = {"captions": "captions"}.get(kind, kind)
    ours = list(builder.WdsShardDataset([shard], size=32, mode=mode))
    theirs = list(jbuilder.WdsShardDataset([shard], size=32, mode=mode, transform=jax_native_transform(32)))
    assert len(ours) == len(theirs) == 5
    for (x, y), (jx, jy) in zip(ours, theirs):
        assert x.shape == (3, 32, 32) and np.array_equal(x, jx)  # both C++ transforms
        if kind == "multilabel":
            assert np.array_equal(y, jy)
        else:
            assert y == jy
    if kind == "captions":
        assert ours[1][1] == ["caption a 1", "caption b 1"] and ours[0][1] == ["json caption 0"]


def test_wds_dataset_metadata_and_file_urls(tmp_path):
    root = write_wds_root(tmp_path / "root")
    for spec in (str(root), root.as_uri()):
        ds, jds = builder.WdsDataset(spec, size=32), jbuilder.WdsDataset(spec, size=32)
        assert ds.dataset_type == jds.dataset_type == "classification"
        assert ds.classes == jds.classes == ["aaa", "bbb", "ccc"]
        assert ds.templates == jds.templates == ["a photo of a {c}.", "art of {c}"]
        got = list(ds.batched(4))
        assert [len(b[1]) for b in got] == [4, 2]
        assert list(np.concatenate([b[1] for b in got])) == [0, 1, 2, 0, 1, 2]
    cap = builder.WdsDataset(write_wds_root(tmp_path / "cap", kind="captions").as_uri(), size=32)
    assert cap.dataset_type == "retrieval" and cap.classes is None
    xb, caps = next(iter(cap.batched(4)))
    assert xb.shape == (4, 3, 32, 32) and caps[1] == ["caption a 1", "caption b 1"]


def test_hub_urls_split_as_jax():
    for url in ("hf://user/repo", "https://huggingface.co/datasets/user/repo/tree/main",
                "https://huggingface.co/datasets/user/repo", "https://huggingface.co/datasets/u/r/tree/dev/sub",
                "/local/dir", "file:///a/b"):
        assert builder.resolve_wds_dirs(url) == jbuilder.resolve_wds_dirs(url)
    with pytest.raises(ValueError, match="unrecognized HF datasets URL"):
        builder.resolve_wds_dirs("https://huggingface.co/datasets/user/repo/blob/x/y")


def test_build_dataset_dispatch(tmp_path):
    root = write_wds_root(tmp_path / "root")
    xs, ys = next(iter(builder.build_dataset("wds/mine", root.as_uri(), size=32, batch_size=3)))
    assert xs.shape == (3, 3, 32, 32) and list(ys) == [0, 1, 2]
    flat = tmp_path / "flat"
    flat.mkdir()
    _write_shard(flat / "a.tar", _shard_samples("classification", 0, 4))
    got = list(builder.build_dataset("wds/flat", str(flat), size=32, batch_size=3, n_samples=3))
    assert [len(b[1]) for b in got] == [3]
    with pytest.raises(FileNotFoundError):
        builder.build_dataset("wds/none", str(tmp_path / "empty"), size=32)
    (x, y), = list(builder.build_dataset("synthetic", "", size=16, batch_size=8, n_samples=8))
    (jx, jy), = list(jbuilder.build_dataset("synthetic", "", size=16, batch_size=8, n_samples=8))
    assert np.array_equal(x, jx) and np.array_equal(y, jy)
    for cls, seeds in (("cat", (1, 2)), ("dog", (3,))):
        (tmp_path / "tree" / "val" / cls).mkdir(parents=True)
        for s in seeds:
            (tmp_path / "tree" / "val" / cls / f"{s}.png").write_bytes(_png(s))
    batches = list(builder.build_dataset("imagenet", str(tmp_path / "tree"), size=32, batch_size=2, n_samples=3))
    assert list(np.concatenate([b[1] for b in batches])) == [0, 0, 1]
    with pytest.raises(ValueError, match="unknown dataset"):
        builder.build_dataset("nope", "")


def test_truncate_batches_stops_before_decoding_more():
    pulled = []

    def gen():
        for i in range(5):
            pulled.append(i)
            yield np.zeros((4, 1)), np.arange(4)

    out = list(builder._truncate_batches(gen(), 6))
    assert [len(b[1]) for b in out] == [4, 2] and pulled == [0, 1]


# ------------------------------------------------------------------- tfds
def test_tfds_adapter_over_fake_tfds(monkeypatch):
    rng = np.random.RandomState(0)
    examples = [{"image": rng.randint(0, 255, (40, 40, 3), np.uint8), "label": i % 2} for i in range(5)]
    test_benchmark.TestTfdsVtabAdapter._install_fake_tfds(monkeypatch, examples, label_names=("x", "y"))
    batches = list(builder.build_dataset("tfds/cifar10", "", size=32, batch_size=2))
    jb = list(jbuilder.build_dataset("tfds/cifar10", "", size=32, batch_size=2))
    assert [b[1].tolist() for b in batches] == [b[1].tolist() for b in jb] == [[0, 1], [0, 1], [0]]
    assert batches[0][0].shape == (2, 3, 32, 32)
    assert tfds_adapter.build_tfds_dataset("cifar10", None).classes == ["x", "y"]
    derived = [{"image": rng.randint(0, 255, (30, 30, 3), np.uint8), "objects": {"size": np.zeros(3 + i)}}
               for i in range(3)]
    test_benchmark.TestTfdsVtabAdapter._install_fake_tfds(monkeypatch, derived)
    (x, y), = list(builder.build_dataset("vtab/clevr_count_all", "", size=32, batch_size=8))
    assert list(y) == [0, 1, 2]
    with pytest.raises(NotImplementedError, match="wds/vtab"):
        tfds_adapter.build_vtab_dataset("dsprites_label_orientation", None)
    with pytest.raises(ValueError, match="unknown VTAB"):
        tfds_adapter.build_vtab_dataset("no_such_task", None)


def test_missing_tfds_raises_informatively(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "tensorflow_datasets", None)
    with pytest.raises(ImportError, match="wds/"):
        tfds_adapter.build_tfds_dataset("cifar10", None)


def test_vtab_label_functions_match_jax():
    rng = np.random.RandomState(2)
    for _ in range(20):
        n = rng.randint(1, 6)
        ex = {"objects": {"type": rng.randint(0, 6, n), "location": rng.rand(n, 3) * 40,
                          "size": np.zeros(rng.randint(3, 11)), "pixel_coords": rng.rand(n, 3) * 12}}
        for name in ("kitti_closest_vehicle_distance_label", "clevr_count_all_label",
                     "clevr_closest_object_distance_label"):
            assert getattr(tfds_adapter, name)(ex) == getattr(jtfds, name)(ex), name


# --------------------------------------------------------------- captions
def test_caption_scores_equal_jax():
    refs = [["a dog runs on the grass", "the dog is running"], ["two cats sleep on a red couch"],
            ["a man rides a bike down the street", "someone on a bicycle"], ["an empty road"]]
    cands = ["a dog is running on grass", "two cats on a couch", "a man on a bike", ""]
    assert captioning.bleu_scores(cands, refs) == jcap.bleu_scores(cands, refs)
    for c, r in zip(cands, refs):
        assert captioning.rouge_l_score(c, r) == jcap.rouge_l_score(c, r)
    assert captioning.score_captions(cands, refs) == jcap.score_captions(cands, refs)
    got = captioning.evaluate_captioning(lambda imgs: cands[:len(imgs)], [(np.zeros(4), refs)])
    assert got == jcap.score_captions(cands, refs)
    perfect = captioning.score_captions(["a b c d e"], [["a b c d e"]])
    assert perfect["Bleu_4"] == pytest.approx(1.0) and perfect["ROUGE_L"] == pytest.approx(1.0)


# ---------------------------------------------------------- classification
@pytest.fixture(scope="module")
def tiny():
    cfg = JAX_CONFIGS["test-tiny"]
    tree = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(2), cfg))
    model = CLIP(CLIP_CONFIGS["test-tiny"], device="cpu")
    model.load_state_dict(params_from_jax(tree))
    rng = np.random.RandomState(3)
    temb = rng.randn(64, 10).astype(np.float32)
    temb /= np.linalg.norm(temb, axis=0, keepdims=True)
    jfn = jax_classifier(jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(temb))
    x = rng.rand(12, 3, 32, 32).astype(np.float32)
    pred = np.asarray(jfn(jnp.asarray(x))).argmax(-1)
    y = np.where(np.arange(12) % 3 == 0, (pred + 1) % 10, pred)  # 8 of 12 right
    return jfn, make_zero_shot_classifier(model, torch.from_numpy(temb)), x, y


def _batches(x, y, bs=5):
    return [(x[i:i + bs], y[i:i + bs]) for i in range(0, len(x), bs)]


def test_run_classification_clean_equals_jax(tiny):
    jfn, fn, x, y = tiny
    ref = jzs.run_classification(jfn, _batches(x, y), n_samples=11)
    got = zeroshot.run_classification(fn, _batches(x, y), n_samples=11)
    assert got == ref
    assert got["acc1"] == pytest.approx(7 / 11)


@pytest.mark.parametrize("eps", [0.0, 32 / 255])
def test_run_classification_aa_by_outcome(tiny, eps, monkeypatch):
    jfn, fn, x, y = tiny
    kw = dict(attack="aa", eps=eps, n_iter=3, n_samples=9, batch_size=4, attack_batch=4)
    ref = jzs.run_classification(jfn, _batches(x, y), **kw)
    seen = []
    real = zeroshot.AutoAttack.run_standard_evaluation

    def run(self, x_in, y_in, **k):
        seen.append((x_in, y_in, real(self, x_in, y_in, **k).numpy()))
        return torch.from_numpy(seen[-1][2])

    monkeypatch.setattr(zeroshot.AutoAttack, "run_standard_evaluation", run)
    got = zeroshot.run_classification(fn, _batches(x, y), **kw)
    (x_in, y_in, x_adv), = seen
    assert {k: got[k] for k in ("acc1", "acc5", "mean_per_class_recall")} == {
        k: ref[k] for k in ("acc1", "acc5", "mean_per_class_recall")}
    assert got["adv_acc1"] == ref["adv_acc1"] == (got["acc1"] if eps == 0 else 0.0)
    assert x_adv.shape == x_in.shape == (9, 3, 32, 32) and np.array_equal(y_in, y[:9])
    assert np.abs(x_adv - x_in).max() <= eps + 1e-6 and x_adv.min() >= 0 and x_adv.max() <= 1


def test_multilabel_attack_refused_on_the_first_batch():
    calls = []

    def data():
        calls.append(1)
        yield np.zeros((2, 3, 8, 8), np.float32), np.zeros((2, 4), np.float32)
        calls.append(2)

    with pytest.raises(NotImplementedError, match="multilabel"):
        zeroshot.run_classification(torch.nn.Identity(), data(), attack="aa", device="cpu")
    assert calls == [1]


def test_multilabel_clean_is_map():
    w = torch.randn(3 * 8 * 8, 4, generator=torch.Generator().manual_seed(0))
    x = np.random.RandomState(0).rand(6, 3, 8, 8).astype(np.float32)
    t = (np.random.RandomState(1).rand(6, 4) > 0.5).astype(np.float32)
    got = zeroshot.run_classification(lambda xb: xb.reshape(len(xb), -1) @ w, [(x, t)], device="cpu")
    logits = (torch.from_numpy(x).reshape(6, -1) @ w).numpy()
    assert got == {"mean_average_precision": jzs.multilabel_average_precision(logits, t)}


# ----------------------------------------------------------- linear probe
def test_linear_probe_matches_optax():
    rng = np.random.RandomState(0)
    f = rng.randn(70, 8).astype(np.float32)
    y = (f @ rng.randn(8, 3)).argmax(-1)
    kw = dict(lr=0.05, epochs=3, batch_size=16, wd=0.01, seed=4)
    ref = jlp.train_linear_probe(f, y, 3, **kw)
    got = linear_probe.train_linear_probe(f, y, 3, **kw)
    for k in ("w", "b"):
        r = np.asarray(ref[k])
        assert np.abs(got[k].numpy() - r).max() <= 1e-5 * np.abs(r).max(), k


def test_linear_probe_learns_and_caches(tmp_path):
    rng = np.random.RandomState(1)
    f = rng.randn(200, 8).astype(np.float32)
    y = (f @ rng.randn(8, 3)).argmax(-1)
    probe = linear_probe.train_linear_probe(f, y, 3, epochs=150, lr=0.1, batch_size=64)
    assert float(((torch.from_numpy(f) @ probe["w"] + probe["b"]).argmax(-1).numpy() == y).mean()) > 0.9

    def embed(x):
        return x.reshape(len(x), -1)

    data = [(f[:100].reshape(100, 2, 4), y[:100]), (f[100:].reshape(100, 2, 4), y[100:])]
    out = linear_probe.evaluate_linear_probe(embed, data, data, 3, cache_dir=str(tmp_path), epochs=20)
    assert (tmp_path / "train.npz").exists() and 0.0 <= out["lp_acc1"] <= 1.0
    cached, _ = linear_probe.extract_features(lambda x: 1 / 0, [], cache_path=str(tmp_path / "train.npz"))
    assert np.array_equal(cached, f)


def test_native_transform_is_the_readers_default():
    assert native.available()
    assert getattr(builder.WdsShardDataset([], size=32).transform, "native", False)
