"""`scripts/real_ckpt_parity_torch.py`: a fingerprint recorded by either
package checks in the other (rc 0 both ways), a checkpoint with one weight
perturbed non-uniformly fails the check (rc 1), no checkpoint skips
cleanly, and the real-weight case runs only when $CLIP_CKPT is set."""

import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import real_ckpt_parity as jax_rp  # noqa: E402
import real_ckpt_parity_torch as rp  # noqa: E402

from robustvlm_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS  # noqa: E402
from robustvlm_tpu.models.clip import init_clip_params  # noqa: E402
from robustvlm_tpu.models.clip.import_torch import export_visual_state_dict  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def visual_ckpt(tmp_path_factory):
    """A test-tiny visual-only checkpoint in the openai torch layout, and a
    copy with one matrix perturbed non-uniformly (a constant added to every
    element of conv1 would be removed by ln_pre exactly)."""
    d = tmp_path_factory.mktemp("ckpt")
    cfg = JAX_CONFIGS["test-tiny"]
    params = init_clip_params(jax.random.PRNGKey(0), cfg)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_visual_state_dict(params["visual"], cfg).items()}
    torch.save(sd, d / "visual.pt")
    sd2 = dict(sd)
    k0 = next(k for k in sd2 if sd2[k].ndim >= 2)
    g = torch.Generator().manual_seed(0)
    sd2[k0] = sd2[k0] + 1e-2 * torch.randn(sd2[k0].shape, generator=g)
    torch.save(sd2, d / "perturbed.pt")
    return d


def _port(ckpt, *flags):
    return rp.main(["--ckpt", str(ckpt), "--model", "test-tiny", "--visual_only", "--device", "cpu", *flags])


def _jax(ckpt, *flags):
    return jax_rp.main(["--ckpt", str(ckpt), "--model", "test-tiny", "--visual_only", *flags])


def test_jax_record_checks_in_the_port_and_back(visual_ckpt, capsys):
    d = visual_ckpt
    assert _jax(d / "visual.pt", "--record", str(d / "jax.json")) == 0
    assert _port(d / "visual.pt", "--expected", str(d / "jax.json")) == 0
    assert _port(d / "visual.pt", "--record", str(d / "port.json")) == 0
    assert _jax(d / "visual.pt", "--expected", str(d / "port.json")) == 0
    assert "PARITY OK" in capsys.readouterr().out
    jrec, prec = (json.loads((d / n).read_text()) for n in ("jax.json", "port.json"))
    assert jrec.keys() == prec.keys() == {"model", "embed_head", "embed_norms"}
    assert np.abs(np.asarray(jrec["embed_head"]) - np.asarray(prec["embed_head"])).max() < 1e-4


def test_perturbed_checkpoint_fails_the_check(visual_ckpt, tmp_path, capsys):
    d = visual_ckpt
    assert _port(d / "visual.pt", "--record", str(tmp_path / "port.json")) == 0
    assert _port(d / "perturbed.pt", "--expected", str(tmp_path / "port.json")) == 1
    # and JAX's gate refuses the perturbed copy against the port's record
    assert _jax(d / "perturbed.pt", "--expected", str(tmp_path / "port.json")) == 1
    assert "PARITY FAIL" in capsys.readouterr().out


def test_model_mismatch_fails(visual_ckpt):
    fp = {"model": "test-tiny", "embed_head": [[0.0]], "embed_norms": [1.0]}
    assert rp.compare(fp, {**fp, "model": "ViT-L-14"}) == ["model mismatch: test-tiny != ViT-L-14"]
    assert rp.compare(fp, {**fp, "embed_norms": [1.0, 2.0]})[0].startswith("embed_norms: shape")


def test_skip_without_checkpoint(monkeypatch, capsys):
    monkeypatch.delenv("CLIP_CKPT", raising=False)
    monkeypatch.delenv("LLAVA_CKPT", raising=False)
    assert rp.main([]) == 0
    assert capsys.readouterr().out.startswith("SKIP")


@pytest.mark.skipif(not os.environ.get("CLIP_CKPT"), reason="no real checkpoint: $CLIP_CKPT is unset")
def test_real_checkpoint_fingerprint_agrees_with_jax(tmp_path):
    model = os.environ.get("CLIP_MODEL", "ViT-L-14")
    flags = ["--model", model] + (["--visual_only"] if os.environ.get("CLIP_VISUAL_ONLY") else [])
    assert jax_rp.main(flags + ["--record", str(tmp_path / "jax.json")]) == 0
    assert rp.main(flags + ["--device", "cpu", "--expected", str(tmp_path / "jax.json")]) == 0
