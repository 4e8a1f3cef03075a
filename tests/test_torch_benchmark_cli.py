"""The port's benchmark CLI (robustvlm_tpu_torch.benchmark.cli.main) against
the JAX package's, task by task, at test-tiny on one set of weights (a
JAX tree written as an openai-layout checkpoint that both CLIs load), on
fixtures the tests write: a webdataset root, CIFAR-10 python batches, a
COCO-style captions json with its images, a predictions json.

With `--attack none` the JSON metrics equal JAX's; under `--attack aa` the
outcome agrees (whole trajectories need not match): eps 0 fools nothing,
eps 32/255 everything. Also the collection mechanics (@file lists,
`model,pretrained` rows, the `--dataset_root` template, per-language
outputs) and that without a GPU the CLI raises unless given `--device cpu`.
"""

import json
import pickle

import jax
import numpy as np
import pytest
import torch

from robustvlm_tpu.benchmark.cli import main as jax_main
from robustvlm_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS
from robustvlm_tpu.models.clip import init_clip_params
from robustvlm_tpu_torch.benchmark import cli

from test_torch_benchmark import _png, write_wds_root
from test_torch_native_image import jax_native_transform
from test_torch_robustbench_dtype import openai_state_dict

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def jax_hash_tokens_in_vocab(monkeypatch):
    """Without a BPE file both CLIs hash words to token ids; the port hashes
    into the model's vocabulary (torch indexing raises out of range), JAX
    into CLIP's 49408 ids and its gather clamps. JAX's CLI gets a hash
    tokenizer over test-tiny's vocabulary, so both see the same ids."""
    from robustvlm_tpu.models.clip import tokenizer as jtok

    monkeypatch.setattr(jtok, "get_tokenizer",
                        lambda bpe, ctx: jtok.HashTokenizer(JAX_CONFIGS["test-tiny"].vocab_size, ctx))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    jax_native_transform(32)  # the JAX reader's C++ transform is built
    cfg = JAX_CONFIGS["test-tiny"]
    tree = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(7), cfg))
    path = tmp_path_factory.mktemp("ckpt") / "tiny.pt"
    torch.save(openai_state_dict(tree, cfg), path)
    return str(path)


def both(tmp_path, argv):
    ref = jax_main(argv + ["--output", str(tmp_path / "jax_{model}_{dataset}_{task}.json")])
    got = cli.main(argv + ["--output", str(tmp_path / "port_{model}_{dataset}_{task}.json"), "--device", "cpu"])
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert {k: v for k, v in g.items() if k != "wall_s"} == {k: v for k, v in r.items() if k != "wall_s"}
    return got


def _five_class_root(root):
    write_wds_root(root, splits=("test", "train"))
    (root / "classnames.txt").write_text("aaa\nbbb\nccc\nddd\neee\n")
    return root


def test_zeroshot_classification_wds_equals_jax(ckpt, tmp_path):
    root = _five_class_root(tmp_path / "wds")
    got = both(tmp_path, ["eval", "--model", "test-tiny", "--pretrained", ckpt, "--dataset", "wds/mine",
                          "--dataset_root", str(root), "--batch_size", "4", "--attack", "none"])
    assert set(got[0]["metrics"]) == {"acc1", "acc5", "mean_per_class_recall"}


@pytest.mark.parametrize("eps", ["0", "32"])
def test_zeroshot_classification_aa_by_outcome(ckpt, tmp_path, eps):
    root = _five_class_root(tmp_path / "wds")
    argv = ["eval", "--model", "test-tiny", "--pretrained", ckpt, "--dataset", "wds/mine", "--dataset_root",
            root.as_uri(), "--batch_size", "4", "--attack", "aa", "--eps", eps, "--n_iter", "2",
            "--n_samples", "5", "--template", "std"]
    ref = jax_main(argv + ["--output", str(tmp_path / "j.json")])[0]["metrics"]
    got = cli.main(argv + ["--output", str(tmp_path / "t.json"), "--device", "cpu"])[0]["metrics"]
    clean = ("acc1", "acc5", "mean_per_class_recall")
    assert {k: got[k] for k in clean} == {k: ref[k] for k in clean}
    assert got["adv_acc1"] == ref["adv_acc1"] == (got["acc1"] if eps == "0" else 0.0)


def test_cifar10_at_native_size_equals_jax(ckpt, tmp_path):
    rng = np.random.RandomState(0)
    batch = {b"data": rng.randint(0, 256, (6, 3072), dtype=np.uint8), b"labels": list(rng.randint(0, 10, 6))}
    (tmp_path / "cifar").mkdir()
    with open(tmp_path / "cifar" / "test_batch", "wb") as f:
        pickle.dump(batch, f)
    both(tmp_path, ["eval", "--model", "test-tiny", "--pretrained", ckpt, "--dataset", "cifar10",
                    "--dataset_root", str(tmp_path / "cifar"), "--batch_size", "4", "--template", "std"])


def _captions_fixture(tmp_path):
    (tmp_path / "img").mkdir()
    images, anns = [], []
    for i in range(5):
        (tmp_path / "img" / f"{i}.png").write_bytes(_png(i, 36, 44))
        images.append({"id": i, "file_name": f"{i}.png"})
        for j, cap in enumerate((f"a photo number {i}", f"picture {i} of a scene", "something else")):
            anns.append({"image_id": i, "caption": cap, "id": 10 * i + j})
    (tmp_path / "ann.json").write_text(json.dumps({"images": images, "annotations": anns}))
    return tmp_path / "img", tmp_path / "ann.json"


@pytest.mark.parametrize("task", ["zeroshot_retrieval", "image_caption_selection"])
def test_retrieval_tasks_equal_jax(ckpt, tmp_path, task):
    img, ann = _captions_fixture(tmp_path)
    got = both(tmp_path, ["eval", "--model", "test-tiny", "--pretrained", ckpt, "--dataset", "mscoco_captions",
                          "--dataset_root", str(img), "--retrieval_annotations", str(ann), "--task", task,
                          "--batch_size", "2"])
    assert got[0]["metrics"]


def test_linear_probe_equals_jax(ckpt, tmp_path):
    root = write_wds_root(tmp_path / "wds", splits=("test", "train"))
    got = both(tmp_path, ["eval", "--model", "test-tiny", "--pretrained", ckpt, "--dataset", "wds/cifar10",
                          "--dataset_root", str(root), "--task", "linear_probe", "--batch_size", "4"])
    assert 0.0 <= got[0]["metrics"]["lp_acc1"] <= 1.0


def test_captioning_scores_equal_jax(tmp_path):
    _, ann = _captions_fixture(tmp_path)
    preds = [{"image_id": i, "caption": c} for i, c in
             enumerate(["a photo number 0", "a picture of a scene", "nothing", "photo 3", "x"])]
    (tmp_path / "preds.json").write_text(json.dumps(preds))
    got = both(tmp_path, ["eval", "--model", "test-tiny", "--task", "captioning", "--predictions",
                          str(tmp_path / "preds.json"), "--retrieval_annotations", str(ann)])
    assert set(got[0]["metrics"]) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr"}


def test_collections_languages_and_root_template(ckpt, tmp_path):
    _five_class_root(tmp_path / "wds_mine")
    for c, cls in enumerate(("n01", "n02")):  # an ImageNet-layout tree at the templated root
        (tmp_path / "wds_imagenet1k" / "val" / cls).mkdir(parents=True)
        for i in range(2):
            (tmp_path / "wds_imagenet1k" / "val" / cls / f"{i}.png").write_bytes(_png(10 * c + i))
    (tmp_path / "models.txt").write_text(f"# a comment\ntest-tiny,{ckpt}\ntest-tiny-convnext,random\n")
    out = tmp_path / "res" / "{model}_{dataset}.json"
    got = cli.main(["eval", "--model", f"@{tmp_path / 'models.txt'}", "--dataset", "wds/mine,imagenet1k",
                    "--dataset_root", str(tmp_path / "wds_{dataset}"), "--language", "en,it",
                    "--batch_size", "8", "--n_samples", "4", "--template", "std", "--output", str(out),
                    "--device", "cpu"])
    assert [(r["model"], r["dataset"], r["language"]) for r in got] == [
        (m, d, lang) for m in ("test-tiny", "test-tiny-convnext") for d in ("wds/mine", "imagenet1k")
        for lang in ("en", "it")]
    assert (tmp_path / "res" / "it_test-tiny-convnext_wds_mine.json").exists()
    assert json.loads((tmp_path / "res" / "en_test-tiny_imagenet1k.json").read_text())["pretrained"] == ckpt
    with pytest.raises(ValueError, match="mutually exclusive"):
        cli.main(["eval", "--model", f"@{tmp_path / 'models.txt'}", "--pretrained", "random", "--device", "cpu"])
    with pytest.raises(ValueError, match="pair positionally"):
        cli.main(["eval", "--model", "test-tiny,test-tiny", "--pretrained", "a,b,c", "--device", "cpu"])
    with pytest.raises(ValueError, match="same file"):
        cli.main(["eval", "--model", "test-tiny,test-tiny", "--pretrained", "random,x", "--dataset", "synthetic",
                  "--output", str(tmp_path / "{model}.json"), "--device", "cpu"])


def test_raises_without_a_gpu_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["eval", "--model", "test-tiny", "--pretrained", "random", "--dataset", "synthetic"])


def test_model_families_resolve(monkeypatch):
    """Every model family of the CLI builds (on the meta device: no weights
    are drawn), and ViT-g-14 is JAX's config."""
    from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS
    from robustvlm_tpu_torch.models.jaclip import JaCLIP

    for cls in (CLIP, JaCLIP):
        monkeypatch.setattr(cls, "init_random_", lambda self, seed=0: self)
    args = cli.build_parser().parse_args(["eval"])
    for name in ("convnext_base_w", "ViT-g-14", "ja_clip-vit-b-16", "xlm-roberta-base-ViT-B-32",
                 "xlm-roberta-large-ViT-H-14"):
        with torch.device("meta"):
            model, cfg, tokenize, build = cli.build_model(args, name, "random", torch.device("meta"))
        assert cfg.image_size in (224, 256) and callable(tokenize) and callable(build)
    g = CLIP_CONFIGS["ViT-g-14"]
    j = JAX_CONFIGS["ViT-g-14"]
    assert (g.vision, g.text, g.embed_dim, g.image_size, g.patch_size, g.quick_gelu) == (
        type(g.vision)(**vars(j.vision)), type(g.text)(**vars(j.text)), j.embed_dim, j.image_size,
        j.patch_size, j.quick_gelu)
    assert g.vision.width // g.vision.heads == 88 and int(g.vision.width * g.vision.mlp_ratio) == 6144
