"""The port's weight-only quantization (robustvlm_tpu_torch.ops.quant) against
the JAX package's (robustvlm_tpu.ops.quant) on the same float32 weights.

Limits: codes bitwise equal, scales within 1e-6 relative (the limit of
tests/test_serve.py for the in-place against the functional quantizer);
`dequantize` and float32 `qmatmul` within 1e-5 of the output's largest
magnitude (float32 sums in another order); bf16 `qmatmul` within 2^-6 of
the largest magnitude (a bf16 result of a sum of two bf16 halves, each
rounded once: two bf16 roundings at most apart). On the CPU the int4 path is
the split dot in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.models.llava import model as JV
from robustvlm_tpu.ops import quant as JQ
from robustvlm_tpu_torch.models.llava import model as PV
from robustvlm_tpu_torch.models.llava.convert import params_from_jax
from robustvlm_tpu_torch.ops import quant as PQ

torch.set_num_threads(1)

# name -> (weight shape, bits, group size)
WEIGHTS = {
    "q8": ((256, 96), 8, 128),
    "q4": ((512, 128), 4, 128),
    "q4_three_groups_per_half": ((768, 64), 4, 128),
    "q4_group_clamped": ((96, 64), 4, 128),
    "q4_stacked": ((2, 256, 64), 4, 64),
}
MATMUL_CASES = [(bits, dtype, xdim) for bits in (8, 4) for dtype in ("float32", "bfloat16")
                for xdim in (2, 3)]


def _w(shape, seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 0.05).astype(np.float32)


def _x(dtype, xdim, k=512, seed=1):
    x = (np.random.RandomState(seed).randn(*((2, 3, k) if xdim == 3 else (4, k))) * 0.5).astype(np.float32)
    return jnp.asarray(x).astype(getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _quantize_jax(a, bits, g):
    return JQ.quantize_q8(jnp.asarray(a)) if bits == 8 else JQ.quantize_q4(jnp.asarray(a), group_size=g)


def _quantize_port(a, bits, g):
    t = torch.from_numpy(a)
    return PQ.quantize_q8(t) if bits == 8 else PQ.quantize_q4(t, group_size=g)


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX result the file compares with, computed once."""
    out = {"quantized": {}, "dequantized": {}, "qmatmul": {}}
    for name, (shape, bits, g) in WEIGHTS.items():
        qw = _quantize_jax(_w(shape), bits, g)
        out["quantized"][name] = tuple(np.array(a) for a in qw)
        out["dequantized"][name] = np.asarray(JQ.dequantize(qw))
    for bits, dtype, xdim in MATMUL_CASES:
        qw = _quantize_jax(_w((512, 128)), bits, 128)
        jx, _ = _x(dtype, xdim)
        out["qmatmul"][bits, dtype, xdim] = _np(JQ.qmatmul(jx, qw))
    cfg = JV.LLAVA_CONFIGS["test-tiny"]
    tree = jax.tree.map(np.asarray, JV.init_llava_params(jax.random.PRNGKey(0), cfg))
    out["tree"] = tree
    out["tree_q4"] = jax.tree.map(np.asarray, JQ.quantize_llama_decode_params(tree, bits=4, min_size=0))
    return out


@pytest.mark.parametrize("name", list(WEIGHTS))
def test_codes_match_jax(jax_side, name):
    shape, bits, g = WEIGHTS[name]
    got = _quantize_port(_w(shape), bits, g)
    codes, scales = jax_side["quantized"][name]
    mine = got.q if bits == 8 else got.p
    assert mine.dtype == (torch.int8 if bits == 8 else torch.uint8)
    np.testing.assert_array_equal(mine.numpy(), codes)
    np.testing.assert_allclose(got.s.numpy(), scales, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", list(WEIGHTS))
def test_dequantize_matches_jax(jax_side, name):
    shape, bits, g = WEIGHTS[name]
    ref = jax_side["dequantized"][name]
    got = PQ.dequantize(_quantize_port(_w(shape), bits, g)).numpy()
    assert got.shape == ref.shape == shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("case", MATMUL_CASES, ids=lambda c: f"int{c[0]}-{c[1]}-x{c[2]}d")
def test_qmatmul_matches_jax(jax_side, case):
    bits, dtype, xdim = case
    _, tx = _x(dtype, xdim)
    got = PQ.qmatmul(tx, _quantize_port(_w((512, 128)), bits, 128))
    ref = jax_side["qmatmul"][case]
    assert got.dtype == tx.dtype and got.shape == ref.shape
    limit = 1e-5 if dtype == "float32" else 2.0 ** -6
    assert np.abs(got.float().numpy() - ref).max() <= limit * np.abs(ref).max()


def test_qmatmul_plain_weight_casts_to_x():
    x = torch.randn(3, 8, dtype=torch.bfloat16)
    w = torch.randn(8, 5)
    assert torch.equal(PQ.qmatmul(x, w), x @ w.to(torch.bfloat16))


def _tiny_state(jax_side):
    return params_from_jax(jax_side["tree"])


@pytest.mark.parametrize("bits", [4, 8])
def test_inplace_equals_functional_and_selects_by_key(jax_side, bits):
    cfg = PV.LLAVA_CONFIGS["test-tiny"]
    state = _tiny_state(jax_side)
    ref = PQ.quantize_llama_decode_params(state, bits=bits, min_size=0)
    model = PV.Llava.from_state(cfg, dict(state))
    PQ.quantize_decode_params_inplace(model, bits=bits, min_size=0)
    got = model.state_dict()
    kind = PQ.QuantizedWeight if bits == 8 else PQ.PackedQ4Weight
    quantized = {k for k, v in ref.items() if isinstance(v, kind)}
    # every LM block matrix and the LM head; no norm, embedding, vision or projector leaf
    expect = {k for k in state if k.startswith("llama.blocks.") and (".attn." in k or ".mlp." in k)}
    assert quantized == expect | {"llama.lm_head"}
    for name in quantized:
        for field, t in ref[name].named_buffers():
            assert torch.equal(got[f"{name}.{field}"], t), name
    for name in set(state) - quantized:
        assert torch.equal(got[name], state[name]), name


def test_min_size_and_bias_leaves_pass_through():
    blocks = {"0.attn.wq": torch.randn(64, 64), "0.attn.qkv_b": torch.randn(64, 64),
              "0.mlp.w_up": torch.randn(8, 16), "0.attn_norm": torch.randn(64, 64)}
    out = PQ.quantize_lm_blocks(blocks, min_size=256)
    assert isinstance(out["0.attn.wq"], PQ.QuantizedWeight)
    for k in ("0.attn.qkv_b", "0.mlp.w_up", "0.attn_norm"):
        assert out[k] is blocks[k]


def test_jax_quantized_tree_carries_across(jax_side):
    """A JAX int4 tree through `params_from_jax` holds the codes the port
    makes from the same float32 weights."""
    cfg = PV.LLAVA_CONFIGS["test-tiny"]
    carried = params_from_jax(jax_side["tree_q4"])
    mine = PQ.quantize_llama_decode_params(_tiny_state(jax_side), bits=4, min_size=0)
    assert carried.keys() == mine.keys()
    for k, v in mine.items():
        if isinstance(v, PQ.PackedQ4Weight):
            assert isinstance(carried[k], PQ.PackedQ4Weight)
            assert torch.equal(carried[k].p, v.p), k
            torch.testing.assert_close(carried[k].s, v.s, rtol=1e-6, atol=0)
    model = PV.Llava.from_state(cfg, carried)
    assert isinstance(model.llama.blocks[1].mlp.w_down, PQ.PackedQ4Weight)


def test_per_layer_layout_carries_across(jax_side):
    """The JAX per-layer serving layout (a `layers` tuple of block trees, no
    stacked `llama.blocks`) maps onto the same state as the stacked one."""
    tree = dict(jax_side["tree_q4"])
    llama = dict(tree["llama"])
    blocks = llama.pop("blocks")
    n = np.asarray(blocks["attn_norm"]).shape[0]
    tree["llama"] = llama
    tree["layers"] = tuple(jax.tree.map(lambda a, i=i: np.asarray(a)[i], blocks) for i in range(n))
    stacked, unstacked = params_from_jax(jax_side["tree_q4"]), params_from_jax(tree)
    assert stacked.keys() == unstacked.keys()
    for k, v in stacked.items():
        w = unstacked[k]
        assert type(w) is type(v), k
        for a, b in zip(v.buffers(), w.buffers()) if isinstance(v, PQ.QUANTIZED) else [(v, w)]:
            assert torch.equal(a, b), k


def test_loss_path_refuses_quantized_model(jax_side):
    cfg = PV.LLAVA_CONFIGS["test-tiny"]
    model = PV.Llava.from_state(cfg, PQ.quantize_llama_decode_params(_tiny_state(jax_side), bits=8))
    x = torch.rand(1, 3, 32, 32)
    tok = torch.ones(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="quantized"):
        PV.llava_per_sample_loss(model, x, tok, tok, tok, torch.ones(1, 4))
