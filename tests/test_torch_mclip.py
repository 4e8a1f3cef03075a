"""The port's multilingual open_clip rows (robustvlm_tpu_torch.models.mclip)
against the JAX package's, on the same weights.

- text embeddings (mean pooling, MLP projection) within 1e-5 of JAX's, and
  the full open_clip text path against `transformers.XLMRobertaModel`
  (behind importorskip) within 2e-5;
- the open_clip checkpoint importer gives JAX's tree bit for bit, and its
  missing-projection diagnostic;
- the hash tokenizer gives JAX's ids; the configs are JAX's;
- the benchmark CLI end to end (`--model test-tiny-mclip --language it`)
  gives JAX's CLI metrics on one written checkpoint; other tasks raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.benchmark.cli import main as jax_main
from robustvlm_tpu.models import mclip as JM
from robustvlm_tpu_torch.benchmark.cli import main
from robustvlm_tpu_torch.models.clip import params_from_jax
from robustvlm_tpu_torch.models.mclip import (
    MCLIP_CONFIGS,
    JaCLIP,
    build_mclip_text_classifier,
    get_mclip_tokenizer,
    import_open_clip_mclip,
)

import test_benchmark
from test_torch_jaclip import PROMPTS, hf_text_state_dict, visual_state_dict

torch.set_num_threads(1)
NAME = "test-tiny-mclip"


@pytest.fixture(scope="module")
def tiny():
    cfg = JM.MCLIP_CONFIGS[NAME]
    tree = jax.tree.map(np.asarray, JM.init_mclip_params(jax.random.PRNGKey(4), cfg))
    model = JaCLIP(MCLIP_CONFIGS[NAME], device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return cfg, tree, model


def open_clip_state_dict(tree, cfg):
    sd = hf_text_state_dict(tree["text"], prefix="text.transformer.")
    tp = tree["text_projection"]
    sd["text.proj.0.weight"] = torch.tensor(np.ascontiguousarray(np.asarray(tp["fc_w"]).T))
    sd["text.proj.2.weight"] = torch.tensor(np.ascontiguousarray(np.asarray(tp["out_w"]).T))
    sd.update(visual_state_dict(tree, cfg.vision))
    sd["logit_scale"] = torch.tensor(3.3)
    return sd


def test_text_embeddings_and_classifier_match_jax(tiny):
    cfg, tree, model = tiny
    ids, mask = get_mclip_tokenizer(None, model.cfg, max_len=12)(PROMPTS)
    jtree = jax.tree.map(jnp.asarray, tree)
    ref = np.asarray(JM.encode_text(jtree, jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy()), cfg,
                                    normalize=True))
    np.testing.assert_allclose(model.encode_text(ids, mask, normalize=True).numpy(), ref, atol=1e-5, rtol=0)
    tpls = ["una foto di un {c}", "{c}"]
    jref = np.asarray(JM.build_mclip_text_classifier(jtree, cfg, JM.get_mclip_tokenizer(None, cfg),
                                                     ["gatto", "cane"], tpls))
    got = build_mclip_text_classifier(model, get_mclip_tokenizer(None, model.cfg), ["gatto", "cane"], tpls)
    np.testing.assert_allclose(got.numpy(), jref, atol=1e-5, rtol=0)


def test_open_clip_text_path_matches_xlm_roberta(tiny):
    pytest.importorskip("transformers")
    from transformers import XLMRobertaConfig, XLMRobertaModel

    tc = MCLIP_CONFIGS[NAME].text
    torch.manual_seed(0)
    hf = XLMRobertaModel(XLMRobertaConfig(
        vocab_size=tc.vocab_size, hidden_size=tc.hidden, num_hidden_layers=tc.layers,
        num_attention_heads=tc.heads, intermediate_size=tc.intermediate,
        max_position_embeddings=tc.max_positions, type_vocab_size=tc.type_vocab,
        pad_token_id=tc.pad_token_id, layer_norm_eps=tc.layer_norm_eps, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0), add_pooling_layer=False).eval()
    cfg, tree, _ = tiny
    sd = open_clip_state_dict(tree, cfg)
    sd.update({f"text.transformer.{k}": v for k, v in hf.state_dict().items()})
    model = JaCLIP(MCLIP_CONFIGS[NAME])
    model.load_state_dict(_import(sd))
    ids = torch.tensor([[0, 5, 6, 7, 2, 1, 1]])
    mask = (ids != 1).long()
    with torch.no_grad():
        h = hf(input_ids=ids, attention_mask=mask).last_hidden_state
        pooled = (h * mask[..., None]).sum(1) / mask.sum(1, keepdim=True)
        ref = torch.nn.functional.gelu(pooled @ sd["text.proj.0.weight"].T) @ sd["text.proj.2.weight"].T
    torch.testing.assert_close(model.encode_text(ids, mask), ref, atol=2e-5, rtol=0)


def _import(sd):
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        torch.save(sd, f"{d}/m.pt")
        return import_open_clip_mclip(f"{d}/m.pt", MCLIP_CONFIGS[NAME])


def test_importer_bit_equal_to_jax(tiny, tmp_path):
    cfg, tree, _ = tiny
    torch.save(open_clip_state_dict(tree, cfg), tmp_path / "m.pt")
    ours = import_open_clip_mclip(str(tmp_path / "m.pt"), MCLIP_CONFIGS[NAME])
    theirs = params_from_jax(jax.tree.map(np.asarray, JM.import_open_clip_mclip(str(tmp_path / "m.pt"), cfg)))
    assert set(ours) == set(theirs)
    for k in ours:
        assert torch.equal(ours[k], theirs[k].reshape(ours[k].shape)), k
    assert float(ours["logit_scale"]) == pytest.approx(3.3)
    sd = open_clip_state_dict(tree, cfg)
    del sd["text.proj.0.weight"], sd["text.proj.2.weight"]
    torch.save(sd, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="MLP text projection"):
        import_open_clip_mclip(str(tmp_path / "bad.pt"), MCLIP_CONFIGS[NAME])


def test_tokenizer_and_configs_match_jax():
    for name, jcfg in JM.MCLIP_CONFIGS.items():
        t = MCLIP_CONFIGS[name]
        assert (t.embed_dim, t.proj_arch, t.proj_hidden, t.vision.name) == (
            jcfg.embed_dim, jcfg.proj_arch, jcfg.proj_hidden, jcfg.vision.name)
        assert vars(t.text) == vars(jcfg.text)
    ids, mask = get_mclip_tokenizer(None, MCLIP_CONFIGS[NAME], max_len=8)(PROMPTS)
    jids, jmask = JM.get_mclip_tokenizer(None, JM.MCLIP_CONFIGS[NAME], max_len=8)(PROMPTS)
    assert np.array_equal(ids.numpy(), np.asarray(jids)) and np.array_equal(mask.numpy(), np.asarray(jmask))


def test_cli_end_to_end_matches_jax(tiny, tmp_path, monkeypatch):
    cfg, tree, _ = tiny
    torch.save(open_clip_state_dict(tree, cfg), tmp_path / "m.pt")
    rng = np.random.RandomState(0)
    examples = [{"image": rng.randint(0, 255, (32, 32, 3), np.uint8), "label": i % 3} for i in range(6)]
    test_benchmark.TestTfdsVtabAdapter._install_fake_tfds(monkeypatch, examples, label_names=("gatto", "cane", "uccello"))
    argv = ["eval", "--model", NAME, "--pretrained", str(tmp_path / "m.pt"), "--dataset", "tfds/cifar10",
            "--dataset_root", "", "--language", "it", "--batch_size", "4", "--n_samples", "6"]
    ref = jax_main(argv + ["--output", str(tmp_path / "j.json")])
    got = main(argv + ["--output", str(tmp_path / "t.json"), "--device", "cpu"])
    assert got[0]["metrics"] == ref[0]["metrics"]
    with pytest.raises(NotImplementedError, match="zeroshot_classification"):
        main(["eval", "--model", "xlm-roberta-base-ViT-B-32", "--pretrained", "random", "--dataset",
              "mscoco_captions", "--dataset_root", "x", "--task", "zeroshot_retrieval", "--device", "cpu"])
