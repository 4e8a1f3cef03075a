"""The port's bench arithmetic against the JAX scripts' own, exactly: the
matmul FLOPs of an APGD step on LLaVA (`bench_llava7b_torch`) and on
OpenFlamingo (`bench_of9b_torch`), the bytes of a decode step
(`bench_decode_torch`) and OpenFlamingo-9B's parameter counts by component
(`bench_of9b_torch.plan`, on the meta device) against JAX's `eval_shape`.
Pure arithmetic: no XLA cost analysis is involved."""

import dataclasses
import sys
from pathlib import Path

import jax
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import bench_decode  # noqa: E402
import bench_decode_torch  # noqa: E402
import bench_llava7b  # noqa: E402
import bench_llava7b_torch  # noqa: E402
import bench_of9b  # noqa: E402
import bench_of9b_torch  # noqa: E402

from robustvlm_tpu.models.flamingo import FLAMINGO_CONFIGS as JAX_FLAMINGO  # noqa: E402
from robustvlm_tpu.models.llava.model import LLAVA_CONFIGS as JAX_LLAVA  # noqa: E402
from robustvlm_tpu_torch.models.flamingo.model import FLAMINGO_CONFIGS  # noqa: E402
from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS  # noqa: E402

LLAVA_NAMES = ("llava-1.5-7b", "llava-1.5-7b-rob", "test-tiny")


@pytest.mark.parametrize("name", LLAVA_NAMES)
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("projector", ["mlp2x_gelu", "linear"])
def test_llava_attack_step_flops_equal_jax(name, remat, projector):
    port = dataclasses.replace(LLAVA_CONFIGS[name], projector_type=projector)
    ref = dataclasses.replace(JAX_LLAVA[name], projector_type=projector)
    for batch, t_pre, t_post in ((1, bench_llava7b.T_PRE, bench_llava7b.T_POST), (3, 5, 4)):
        got = bench_llava7b_torch.attack_step_matmul_flops(port, batch, t_pre, t_post, remat=remat)
        want = bench_llava7b.attack_step_matmul_flops(ref, batch, t_pre, t_post, remat=remat)
        assert got == want
    assert (bench_llava7b_torch.T_PRE, bench_llava7b_torch.T_POST) == (bench_llava7b.T_PRE, bench_llava7b.T_POST)


def test_llava_7b_step_magnitude_and_remat_share():
    """About 24.6 TFLOP at 7B with remat (the count JAX validated), and
    remat adds the replay on top of the model FLOPs."""
    cfg = LLAVA_CONFIGS["llava-1.5-7b"]
    with_remat = bench_llava7b_torch.attack_step_matmul_flops(cfg, 1, 35, 24, remat=True)
    model = bench_llava7b_torch.attack_step_matmul_flops(cfg, 1, 35, 24, remat=False)
    assert 24e12 < with_remat < 25.5e12
    assert 1.2 < with_remat / model < 1.6


@pytest.mark.parametrize("name", ["openflamingo-9b", "test-tiny"])
def test_flamingo_attack_step_flops_equal_jax(name):
    for batch, t_img, frames, t_txt in ((8, 1, 1, 44), (8, 5, 1, 220), (2, 3, 2, 17)):
        got = bench_of9b_torch.attack_step_matmul_flops(FLAMINGO_CONFIGS[name], batch, t_img, frames, t_txt)
        want = bench_of9b.attack_step_matmul_flops(JAX_FLAMINGO[name], batch, t_img, frames, t_txt)
        assert got == want


@pytest.mark.parametrize("name", LLAVA_NAMES)
@pytest.mark.parametrize("weight_bytes", [2.0, 1.0, 0.5 + 4.0 / 128])
@pytest.mark.parametrize("kv_int8", [False, True])
def test_decode_step_bytes_equal_jax(name, weight_bytes, kv_int8):
    port, ref = LLAVA_CONFIGS[name], JAX_LLAVA[name]
    kv = (1.0 + 4.0 / port.llama.head_dim) if kv_int8 else 2.0
    for t_avg in (1, 687):
        got = bench_decode_torch._decode_step_bytes(port, t_avg, weight_bytes=weight_bytes, kv_bytes=kv)
        want = bench_decode._decode_step_bytes(ref, t_avg, weight_bytes=weight_bytes, kv_bytes=kv)
        assert got == want
    assert (bench_decode_torch.T_PRE, bench_decode_torch.T_QUESTION) == (bench_decode.T_PRE, bench_decode.T_QUESTION)


def test_of9b_component_counts_equal_jax_eval_shape(capsys):
    from robustvlm_tpu.models.flamingo import init_flamingo_params

    cfg = JAX_FLAMINGO["openflamingo-9b"]
    shapes = jax.eval_shape(lambda k: init_flamingo_params(k, cfg), jax.random.PRNGKey(0))
    want = {k: sum(leaf.size for leaf in jax.tree.leaves(v)) for k, v in shapes.items()}
    assert bench_of9b_torch.param_counts() == want
    out = bench_of9b_torch.plan(memory_gib=80.0)
    capsys.readouterr()
    assert out["params_by_component_b"] == {k: v / 1e9 for k, v in bench_of9b_torch.param_counts().items()}
    assert 8.0 <= out["n_params_b"] <= 8.3
    assert out["params_gib_bf16"] == pytest.approx(sum(want.values()) * 2 / 2**30)
    assert out["card_memory_source"] == "argument" and out["fits_one_card"]


def test_of9b_projection_and_shard_plan(capsys):
    out = bench_of9b_torch.flops_projection(rate_tf_s=100.0)
    assert "PROJECTION" in out["label"]
    zero, few = out["points"]
    assert few["tflop_per_step"] > 4 * zero["tflop_per_step"]
    assert zero["projected_steps_per_sec"] == pytest.approx(100.0 / zero["tflop_per_step"])
    plan = bench_of9b_torch.shard_plan((1, 8, 1))
    capsys.readouterr()
    # the case JAX's compile check caught: 588 rows do not split 8 ways
    assert [d["name"] for d in plan["dropped"]] == ["vision.patch_embed"]
    assert plan["dropped"][0]["shape"] == [588, 1024]
    assert plan["whole_param_gib"] / 8 < plan["per_device_param_gib"] < plan["whole_param_gib"] / 7
