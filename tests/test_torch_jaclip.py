"""The port's ja_clip (robustvlm_tpu_torch.models.jaclip) against the JAX
package's, on the same weights (a JAX tree through `params_from_jax`).

- text embeddings within 1e-5 of JAX's, in both position conventions and
  with CLS and mean pooling; the template-ensemble classifier too;
- the BERT tower against `transformers.RobertaModel` (behind importorskip);
- the HF-RoBERTa and rinna importers give JAX's tree bit for bit, and the
  missing-text-tower diagnostic;
- the tokenizers give JAX's ids (hash tokenizer, rinna's HF protocol);
- the benchmark CLI end to end (`--model ja_clip-test-tiny --language
  jp` over a fake tfds dataset) gives JAX's CLI metrics on one written
  checkpoint; unknown names and other tasks raise as in JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.benchmark.cli import main as jax_main
from robustvlm_tpu.models import jaclip as J
from robustvlm_tpu.models.clip.import_torch import export_visual_state_dict
from robustvlm_tpu.models.jaclip.import_torch import import_hf_roberta as jax_import_hf
from robustvlm_tpu.models.jaclip.import_torch import import_rinna_jaclip as jax_import_rinna
from robustvlm_tpu_torch.benchmark.cli import main
from robustvlm_tpu_torch.models.clip import params_from_jax
from robustvlm_tpu_torch.models.jaclip import (
    JACLIP_CONFIGS,
    JaCLIP,
    build_ja_text_classifier,
    default_position_ids,
    get_ja_tokenizer,
    wrap_hf_ja_tokenizer,
)
from robustvlm_tpu_torch.models.jaclip.import_torch import import_hf_roberta, import_rinna_jaclip

import test_benchmark

torch.set_num_threads(1)
PROMPTS = ["a photo of a cat", "猫 の 写真", "x", "a much longer prompt with many words in it"]

HF_LAYER = {  # JAX leaf -> (HF key under encoder.layer.<i>., transposed)
    "q_w": ("attention.self.query.weight", True), "q_b": ("attention.self.query.bias", False),
    "k_w": ("attention.self.key.weight", True), "k_b": ("attention.self.key.bias", False),
    "v_w": ("attention.self.value.weight", True), "v_b": ("attention.self.value.bias", False),
    "o_w": ("attention.output.dense.weight", True), "o_b": ("attention.output.dense.bias", False),
    "ln1_w": ("attention.output.LayerNorm.weight", False), "ln1_b": ("attention.output.LayerNorm.bias", False),
    "ff1_w": ("intermediate.dense.weight", True), "ff1_b": ("intermediate.dense.bias", False),
    "ff2_w": ("output.dense.weight", True), "ff2_b": ("output.dense.bias", False),
    "ln2_w": ("output.LayerNorm.weight", False), "ln2_b": ("output.LayerNorm.bias", False),
}


def hf_text_state_dict(text, prefix=""):
    """A JAX text tree as an HF RobertaModel state dict (torch tensors)."""
    t = lambda a: torch.tensor(np.ascontiguousarray(np.asarray(a)))  # noqa: E731
    sd = {prefix + "embeddings.word_embeddings.weight": t(text["word_emb"]),
          prefix + "embeddings.position_embeddings.weight": t(text["pos_emb"]),
          prefix + "embeddings.token_type_embeddings.weight": t(text["type_emb"]),
          prefix + "embeddings.LayerNorm.weight": t(text["emb_ln_w"]),
          prefix + "embeddings.LayerNorm.bias": t(text["emb_ln_b"])}
    for leaf, (key, tr) in HF_LAYER.items():
        for i, a in enumerate(np.asarray(text["blocks"][leaf])):
            sd[f"{prefix}encoder.layer.{i}.{key}"] = t(a.T if tr else a)
    return sd


def visual_state_dict(tree, vcfg, prefix="visual."):
    return {prefix + k: torch.tensor(np.ascontiguousarray(np.asarray(v)))
            for k, v in export_visual_state_dict(tree["visual"], vcfg).items()}


@pytest.fixture(scope="module")
def tiny():
    cfg = J.JACLIP_CONFIGS["test-tiny"]
    tree = jax.tree.map(np.asarray, J.init_jaclip_params(jax.random.PRNGKey(1), cfg))
    model = JaCLIP(JACLIP_CONFIGS["test-tiny"], device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return cfg, tree, model


@pytest.mark.parametrize("convention", ["roberta", "arange"])
@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_text_embeddings_match_jax(tiny, convention, pool):
    cfg, tree, model = tiny
    text = dataclasses.replace(cfg.text, position_convention=convention, pool=pool)
    jcfg = dataclasses.replace(cfg, text=text)
    model.cfg = dataclasses.replace(model.cfg, text=dataclasses.replace(model.cfg.text,
                                                                      position_convention=convention, pool=pool))
    model.text.cfg = model.cfg.text
    ids, mask = get_ja_tokenizer(None, model.cfg, max_len=12)(PROMPTS)
    ref = np.asarray(J.encode_text(jax.tree.map(jnp.asarray, tree), jnp.asarray(ids.numpy()),
                                   jnp.asarray(mask.numpy()), jcfg, normalize=True))
    got = model.encode_text(ids, mask, normalize=True).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    jpos = np.asarray(J.default_position_ids(jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy()), text))
    assert np.array_equal(default_position_ids(ids, mask, model.cfg.text).numpy(), jpos)
    model.cfg = JACLIP_CONFIGS["test-tiny"]
    model.text.cfg = model.cfg.text


def test_classifier_and_image_tower_match_jax(tiny):
    cfg, tree, model = tiny
    tok = get_ja_tokenizer(None, model.cfg)
    jtok = J.get_ja_tokenizer(None, cfg)
    tpls = ["{c} の 写真", "a photo of a {c}"]
    ref = np.asarray(J.build_ja_text_classifier(jax.tree.map(jnp.asarray, tree), cfg, jtok, ["猫", "犬", "鳥"], tpls))
    got = build_ja_text_classifier(model, tok, ["猫", "犬", "鳥"], tpls).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    ref_img = np.asarray(J.encode_image(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), cfg))
    np.testing.assert_allclose(model.encode_image(torch.from_numpy(x)).numpy(), ref_img, atol=1e-5, rtol=0)


def test_bert_tower_matches_hf_roberta(tiny):
    pytest.importorskip("transformers")
    from transformers import RobertaConfig, RobertaModel

    tc = JACLIP_CONFIGS["test-tiny"].text
    torch.manual_seed(0)
    hf = RobertaModel(RobertaConfig(
        vocab_size=tc.vocab_size, hidden_size=tc.hidden, num_hidden_layers=tc.layers,
        num_attention_heads=tc.heads, intermediate_size=tc.intermediate,
        max_position_embeddings=tc.max_positions, type_vocab_size=tc.type_vocab,
        pad_token_id=tc.pad_token_id, layer_norm_eps=tc.layer_norm_eps, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0), add_pooling_layer=False).eval()
    model = JaCLIP(JACLIP_CONFIGS["test-tiny"])
    model.load_state_dict({**model.state_dict(), **import_hf_roberta(hf.state_dict(), tc)})
    ids = torch.from_numpy(np.random.RandomState(0).randint(5, tc.vocab_size, (2, 11)))
    mask = torch.ones(2, 11, dtype=torch.long)
    mask[1, 7:] = 0
    ids[1, 7:] = tc.pad_token_id
    with torch.no_grad():
        ref = hf(input_ids=ids, attention_mask=mask).last_hidden_state
    got = model.text(ids, mask)
    torch.testing.assert_close(got[0], ref[0], atol=2e-5, rtol=0)
    torch.testing.assert_close(got[1, :7], ref[1, :7], atol=2e-5, rtol=0)


def test_importers_bit_equal_to_jax(tiny, tmp_path):
    cfg, tree, _ = tiny
    sd = hf_text_state_dict(tree["text"], prefix="text_model.")
    ours = import_hf_roberta(sd, cfg.text, prefix="text_model.")
    theirs = params_from_jax({"text": jax.tree.map(np.asarray, jax_import_hf(sd, cfg.text, prefix="text_model."))})
    assert set(ours) == set(theirs) and all(torch.equal(ours[k], theirs[k]) for k in ours)
    sd["text_projection.weight"] = torch.tensor(np.ascontiguousarray(np.asarray(tree["text_projection"]).T))
    sd.update(visual_state_dict(tree, cfg.vision))
    sd["logit_scale"] = torch.tensor(3.1)
    torch.save(sd, tmp_path / "rinna.pt")
    ours = import_rinna_jaclip(str(tmp_path / "rinna.pt"), JACLIP_CONFIGS["test-tiny"])
    theirs = params_from_jax(jax.tree.map(np.asarray, jax_import_rinna(str(tmp_path / "rinna.pt"), cfg)))
    assert set(ours) == set(theirs)
    for k in ours:
        assert torch.equal(ours[k], theirs[k].reshape(ours[k].shape)), k
    JaCLIP(JACLIP_CONFIGS["test-tiny"]).load_state_dict(ours)


def test_missing_text_tower_raises_with_keys(tmp_path):
    torch.save({"some.random.key": torch.zeros(2)}, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="word_embeddings"):
        import_rinna_jaclip(str(tmp_path / "bad.pt"), JACLIP_CONFIGS["test-tiny"])


def test_tokenizers_match_jax():
    cfg = JACLIP_CONFIGS["test-tiny"]
    ids, mask = get_ja_tokenizer(None, cfg, max_len=8)(PROMPTS)
    jids, jmask = J.get_ja_tokenizer(None, J.JACLIP_CONFIGS["test-tiny"], max_len=8)(PROMPTS)
    assert np.array_equal(ids.numpy(), np.asarray(jids)) and np.array_equal(mask.numpy(), np.asarray(jmask))
    assert ids.dtype == torch.int64 and ids[:, 0].tolist() == [0] * len(PROMPTS)

    class FakeHF:
        cls_token_id = 4

        def __call__(self, texts, *, padding, truncation, max_length, add_special_tokens, return_tensors):
            assert add_special_tokens is False
            ids = np.ones((len(texts), max_length), np.int64)
            mask = np.zeros((len(texts), max_length), np.int64)
            for i, t in enumerate(texts):
                toks = [10 + j for j in range(len(t.split()))][:max_length]
                ids[i, :len(toks)], mask[i, :len(toks)] = toks, 1
            return {"input_ids": ids, "attention_mask": mask}

    a = wrap_hf_ja_tokenizer(FakeHF(), 8)(["a b c", "d"])
    b = J.wrap_hf_ja_tokenizer(FakeHF(), 8)(["a b c", "d"])
    assert all(np.array_equal(x.numpy(), np.asarray(y)) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="cls_token_id"):
        wrap_hf_ja_tokenizer(type("NoCls", (), {"cls_token_id": None, "bos_token_id": None})())


def test_random_init_on_the_device():
    m = JaCLIP(JACLIP_CONFIGS["test-tiny"]).init_random_(3)
    assert torch.equal(m.text.blocks[0].ln1_w, torch.ones(32)) and float(m.text.word_emb.std()) > 0.01
    assert float(m.logit_scale) == pytest.approx(np.log(1 / 0.07))
    ids, mask = get_ja_tokenizer(None, m.cfg)(PROMPTS)
    assert torch.isfinite(m.encode_text(ids, mask)).all()


def _fake_jp_tfds(monkeypatch, names=("猫", "犬")):
    rng = np.random.RandomState(0)
    examples = [{"image": rng.randint(0, 255, (32, 32, 3), np.uint8), "label": i % 2} for i in range(4)]
    test_benchmark.TestTfdsVtabAdapter._install_fake_tfds(monkeypatch, examples, label_names=names)


def test_cli_end_to_end_matches_jax(tiny, tmp_path, monkeypatch):
    cfg, tree, _ = tiny
    sd = hf_text_state_dict(tree["text"], prefix="text_model.")
    sd["text_projection.weight"] = torch.tensor(np.ascontiguousarray(np.asarray(tree["text_projection"]).T))
    sd.update(visual_state_dict(tree, cfg.vision))
    torch.save(sd, tmp_path / "rinna.pt")
    _fake_jp_tfds(monkeypatch)
    argv = ["eval", "--model", "ja_clip-test-tiny", "--pretrained", str(tmp_path / "rinna.pt"),
            "--dataset", "tfds/cifar10", "--dataset_root", "", "--task", "zeroshot_classification",
            "--language", "jp", "--batch_size", "2", "--n_samples", "4"]
    ref = jax_main(argv + ["--output", str(tmp_path / "j_{model}.json")])
    got = main(argv + ["--output", str(tmp_path / "t_{model}.json"), "--device", "cpu"])
    assert got[0]["metrics"] == ref[0]["metrics"]
    assert {k: v for k, v in got[0].items() if k not in ("wall_s",)} == {
        k: v for k, v in ref[0].items() if k not in ("wall_s",)}
    _fake_jp_tfds(monkeypatch, ("猫", "犬", "鳥", "魚", "馬"))  # APGD-T's DLR loss needs 4 classes
    rnd = main(["eval", "--model", "ja_clip-test-tiny", "--pretrained", "random", "--dataset",
                "tfds/cifar10", "--dataset_root", "", "--language", "jp", "--batch_size", "2",
                "--n_samples", "4", "--attack", "aa", "--n_iter", "2", "--device", "cpu",
                "--output", str(tmp_path / "r_{model}.json")])
    assert rnd[0]["metrics"]["adv_acc1"] <= rnd[0]["metrics"]["acc1"]


def test_cli_refusals_match_jax():
    with pytest.raises(KeyError, match="unknown ja_clip"):
        main(["eval", "--model", "ja_clip-vit-l-14", "--pretrained", "random", "--dataset", "tfds/cifar10",
              "--dataset_root", "", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="zeroshot_classification"):
        main(["eval", "--model", "ja_clip-test-tiny", "--pretrained", "random", "--dataset",
              "mscoco_captions", "--dataset_root", "x", "--task", "zeroshot_retrieval", "--device", "cpu"])
