"""`scripts/bench_decode_torch.py` on the CPU at test-tiny size: the timed
generation's greedy tokens equal JAX's `greedy_generate` on the same
weights and inputs (bf16-width weights, i.e. unquantized, and int8), in
float32; a batch point's and the sweep's JSON lines; a failing batch point
makes the sweep raise after its summary."""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import bench_decode_torch  # noqa: E402

from robustvlm_tpu.models.generation import greedy_generate as jax_greedy  # noqa: E402
from robustvlm_tpu.models.llava.model import LLAVA_CONFIGS as JAX_CONFIGS  # noqa: E402
from robustvlm_tpu.models.llava.model import init_llava_params  # noqa: E402
from robustvlm_tpu.models.llava.model import make_llava_decode_fns as jax_decode_fns  # noqa: E402
from robustvlm_tpu.ops import quant as jax_quant  # noqa: E402
from robustvlm_tpu_torch.models.llava import LLAVA_CONFIGS, Llava, params_from_jax  # noqa: E402
from robustvlm_tpu_torch.ops import quant as port_quant  # noqa: E402

torch.set_num_threads(2)
MAX_NEW = 6


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, init_llava_params(jax.random.PRNGKey(0), JAX_CONFIGS["test-tiny"]))


@pytest.mark.parametrize("bits", [0, 8])
def test_generate_tokens_equal_jax_greedy(tree, bits):
    cfg = LLAVA_CONFIGS["test-tiny"]
    model = Llava.from_state(cfg, params_from_jax(tree))
    jparams = jax.tree.map(jnp.asarray, tree)
    if bits:
        port_quant.quantize_decode_params_inplace(model, bits=bits, min_size=0)
        jparams = jax_quant.quantize_decode_params_inplace(jparams, bits=bits, min_size=0) or jparams
    inputs = bench_decode_torch.decode_inputs(cfg, 2, "cpu")
    got = bench_decode_torch.generate(model, inputs, MAX_NEW, compute_dtype=torch.float32).numpy()

    pixels, pre, question, n_pad = (jnp.asarray(t.numpy()) for t in inputs)
    pf, df = jax_decode_fns(jparams, JAX_CONFIGS["test-tiny"], pixels, pre.astype(jnp.int32),
                            max_total_len=bench_decode_torch.T_QUESTION + MAX_NEW, compute_dtype=jnp.float32)
    want = np.asarray(jax_greedy(pf, df, question.astype(jnp.int32), n_pad.astype(jnp.int32),
                                 max_new_tokens=MAX_NEW, eos_id=-1).tokens)
    assert got.shape == (2, MAX_NEW)
    assert np.array_equal(got, want)


def test_run_one_and_sweep_lines(tree, capsys):
    summary = bench_decode_torch.main(batches=[1, 2], max_new=3, bits=8, device="cpu", config="test-tiny",
                                      compute_dtype=torch.float32)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [ln["metric"] for ln in lines] == ["llava7b_greedy_decode"] * 2 + ["llava7b_greedy_decode_tokens_per_sec"]
    for pt, b in zip(lines[:2], (1, 2)):
        assert pt["batch"] == b and pt["max_new_tokens"] == 3
        assert pt["tokens_per_sec"] == pytest.approx(b * 3 / min(pt["generate_s"]))
        assert pt["prefill_s"] > 0
    assert summary["value"] == max(p["tokens_per_sec"] for p in lines[:2])
    assert summary["weights"] == "int8" and summary["kv_cache"] == "bf16"
    roof = summary["roofline"]
    assert roof["weights_plus_kv_gb_per_step"] > 0 and roof["measured_copy_bandwidth_gb_s"] is None


def test_a_failing_batch_point_raises_after_the_summary(monkeypatch, capsys):
    real = bench_decode_torch.run_one

    def run_one(model, batch, *a, **k):
        if batch == 2:
            raise RuntimeError("simulated out of memory")
        return real(model, batch, *a, **k)

    monkeypatch.setattr(bench_decode_torch, "run_one", run_one)
    with pytest.raises(RuntimeError, match=r"failed: \[2\]"):
        bench_decode_torch.main(batches=[1, 2], max_new=2, bits=0, device="cpu", config="test-tiny",
                                compute_dtype=torch.float32)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert "simulated out of memory" in lines[1]["error"]
    assert lines[-1]["metric"] == "llava7b_greedy_decode_tokens_per_sec" and lines[-1]["value"] is None
