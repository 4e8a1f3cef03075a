"""The port's packed-int4 matmul (robustvlm_tpu_torch.ops.kernels.q4_matmul)
against the JAX kernel (robustvlm_tpu.ops.pallas.q4_matmul, interpret mode)
on the same packed weights, for both bodies: the group body (the default)
and the shift body (Q4_KERNEL=shift).

Limits: float32 x within 1e-5 of the reference's largest magnitude (the two
differ in the order of float32 sums only); bf16 x within one bf16 rounding
of each element (2^-7 |ref|) plus 1e-5 of the largest magnitude (an output
rounded to bf16 can land on either side of a tie after a reordered sum).
Both bodies within 1e-2 of x.float() @ dequantize(w), the limit of
tests/test_q4_kernel.py. The CUDA kernel against the plain version runs on
the card only (`cuda` marker)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustvlm_tpu.ops import quant as JQ
from robustvlm_tpu.ops.pallas import q4_matmul as JK
from robustvlm_tpu_torch.ops import quant as PQ
from robustvlm_tpu_torch.ops.kernels import q4_matmul as K

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)  # the chip check's helpers; it imports only the standard library

# (b, k, n, g): the JAX package's shapes, plus K/2 = 3 groups
CASES = [(1, 512, 512, 128), (8, 512, 384, 64), (3, 256, 128, 128), (5, 768, 256, 128)]
BODIES = ("group", "shift")
DTYPES = ("float32", "bfloat16")


def _inputs(b, k, n, g, seed=0):
    rng = np.random.RandomState(seed)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    qw = JQ.quantize_q4(jnp.asarray(w), group_size=g)
    x = (rng.randn(b, k) * 0.5).astype(np.float32)
    return x, np.array(qw.p), np.array(qw.s)


def _torch_x(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.fixture(scope="module")
def jax_out():
    """The JAX kernel's output (float32 numpy) per (case, dtype, body)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for body in BODIES:
            mp.setenv("Q4_KERNEL", body)
            for case in CASES:
                x, p, s = _inputs(*case)
                for dtype in DTYPES:
                    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
                    y = JK.q4_matmul(jx, jnp.asarray(p), jnp.asarray(s), interpret=True)
                    out[case, dtype, body] = np.asarray(y.astype(jnp.float32))
    return out


def _within(got: np.ndarray, ref: np.ndarray, dtype: str) -> bool:
    top = np.abs(ref).max()
    if dtype == "float32":
        return np.abs(got - ref).max() <= 1e-5 * top
    return bool((np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-5 * top).all())


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_reference_matches_jax_kernel(jax_out, case, dtype, body):
    x, p, s = _inputs(*case)
    got = K.q4_matmul_reference(_torch_x(x, dtype), torch.from_numpy(p), torch.from_numpy(s),
                                group=body == "group")
    assert got.dtype == getattr(torch, dtype) and got.shape == (case[0], case[2])
    assert _within(got.float().numpy(), jax_out[case, dtype, body], dtype)


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_reference_near_dequantized_matmul(case, body):
    x, p, s = _inputs(*case)
    xb = _torch_x(x, "bfloat16")
    w = PQ.PackedQ4Weight(torch.from_numpy(p), torch.from_numpy(s))
    got = K.q4_matmul_reference(xb, w.p, w.s, group=body == "group").float()
    ref = xb.float() @ PQ.dequantize(w)
    torch.testing.assert_close(got, ref, rtol=1e-2, atol=1e-2)


def test_env_selects_the_body(monkeypatch):
    x, p, s = _inputs(*CASES[3])
    args = (_torch_x(x, "bfloat16"), torch.from_numpy(p), torch.from_numpy(s))
    monkeypatch.delenv("Q4_KERNEL", raising=False)
    assert torch.equal(K.q4_matmul(*args), K.q4_matmul_reference(*args, group=True))
    monkeypatch.setenv("Q4_KERNEL", "shift")
    assert torch.equal(K.q4_matmul(*args), K.q4_matmul_reference(*args, group=False))


def test_leading_dims_flatten():
    x, p, s = _inputs(2, 256, 256, 128)
    xt, pt, st = torch.from_numpy(x).reshape(2, 1, 256), torch.from_numpy(p), torch.from_numpy(s)
    y = K.q4_matmul(xt, pt, st)
    assert y.shape == (2, 1, 256)
    assert torch.equal(y.reshape(2, 256), K.q4_matmul(xt.reshape(2, 256), pt, st))


def test_ineligible_shapes_return_none():
    """None exactly where the JAX function returns None."""
    _, p, s = _inputs(1, 256, 256, 128)
    _, p_odd, s_odd = _inputs(1, 256, 192, 128, seed=3)
    cases = {
        "stacked weight": (np.zeros((1, 256), np.float32), np.broadcast_to(p, (2,) + p.shape), s),
        "N without a strip": (np.zeros((1, 256), np.float32), p_odd, s_odd),
        "prefill-sized batch": (np.zeros((64, 256), np.float32), p, s),
        "K mismatch": (np.zeros((1, 128), np.float32), p, s),
    }
    for name, (x, pp, ss) in cases.items():
        assert JK.q4_matmul(jnp.asarray(x), jnp.asarray(pp), jnp.asarray(ss), interpret=True) is None, name
        assert K.q4_matmul(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(pp)),
                           torch.from_numpy(ss)) is None, name
    # the 7B decode shapes are all eligible
    for kh, n in ((2048, 4096), (2048, 11008), (5504, 4096), (2048, 32000)):
        assert K.pick_strip(kh, n) == JK._pick_bn(kh, n) and K.pick_strip(kh, n) is not None


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks before a launch run on any tensor, so they run here."""
    x, p, s = (torch.from_numpy(a) for a in _inputs(4, 512, 256, 128))
    K._check_cuda(x, p, s)
    with pytest.raises(TypeError):
        K._check_cuda(x.half(), p, s)
    with pytest.raises(TypeError):
        K._check_cuda(x, p.to(torch.int8), s)
    with pytest.raises(ValueError, match="rows"):
        K._check_cuda(torch.zeros(33, 512), p, s)
    with pytest.raises(ValueError, match="scales"):
        K._check_cuda(x, p, s[:3])
    with pytest.raises(ValueError, match="multiple of 16"):
        w = PQ.quantize_q4(torch.randn(48, 256), group_size=8)
        K._check_cuda(torch.zeros(1, 48), w.p, w.s)
    with pytest.raises(ValueError, match="contiguous"):
        K._check_cuda(x, p.t().contiguous().t(), s)


@pytest.mark.parametrize("fault", [None, "nibbles_swapped"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_library_operands_give_the_shift_body(case, fault):
    """chip_smoke.py times PyTorch's int4 weight-only matmul as both
    q4_matmul rows' library call, on operands that `tinygemm_operands`
    builds from the port's (p, s). Here the op's CPU twin
    (`_convert_weight_to_int4pack_for_cpu`, `_weight_int4pack_mm_for_cpu`)
    pins the unpacking and the scale layout: with x the identity, the
    dequantized weight equals the shift body's bit for bit; on random x the
    product is within one bf16 rounding of the shift body's largest output
    (2^-7 max|ref|: the twin's sums run in its own order and land more than
    one rounding off at some small outputs, so the per-element limit of the
    card's check is not the twin's); with the nibbles swapped (a planted
    fault) both fail."""
    b, k, n, g = case
    x, p, s = _inputs(*case)
    p, s = torch.from_numpy(p), torch.from_numpy(s)
    pk = (p >> 4) | (p << 4) if fault else p
    codes, sz = SMOKE.tinygemm_operands(pk, s)
    assert codes.shape == (n, k) and sz.shape == (k // g, n, 2) and sz.dtype == torch.bfloat16
    packed = SMOKE.tinygemm_pack(codes)
    eye = torch.eye(k, dtype=torch.bfloat16)
    exact = torch.equal(SMOKE.tinygemm_mm(eye, packed, g, sz),
                        K.q4_matmul_reference(eye, p, s, group=False))
    xb = _torch_x(x, "bfloat16")
    got = SMOKE.tinygemm_mm(xb, packed, g, sz).float()
    ref = K.q4_matmul_reference(xb, p, s, group=False).float()
    within = float((got - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())
    assert (exact, within) == ((False, False) if fault else (True, True))


@pytest.mark.cuda
@pytest.mark.parametrize("body", BODIES)
def test_cuda_kernel_matches_plain(body):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for b, k, n, g in [(1, 4096, 4096, 128), (5, 768, 256, 128), (32, 11008, 512, 128),
                       (9, 512, 384, 64)]:
        rng = np.random.RandomState(b)
        w = PQ.quantize_q4(torch.from_numpy(rng.randn(k, n).astype(np.float32) * 0.05).cuda(),
                           group_size=g)
        for dtype in DTYPES:
            x = torch.from_numpy(rng.randn(b, k).astype(np.float32) * 0.5).cuda().to(getattr(torch, dtype))
            before = K.LAUNCHES[f"q4_matmul_{body}"]
            got = K.q4_matmul_cuda(x, w.p, w.s, group=body == "group")
            again = K.q4_matmul_cuda(x, w.p, w.s, group=body == "group")
            ref = K.q4_matmul_reference(x, w.p, w.s, group=body == "group")
            torch.cuda.synchronize()
            assert K.LAUNCHES[f"q4_matmul_{body}"] == before + 2
            assert got.dtype == x.dtype and torch.equal(got, again)
            assert _within(got.float().cpu().numpy(), ref.float().cpu().numpy(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("b", [1, 7, 8, 9, 32])
def test_cuda_kernel_edges(b, body):
    """The kernel's edges at LLaVA-1.5-7B's w_down shape (K = 11008, N =
    4096, G = 128): 43 groups a half split unevenly across a cluster's
    blocks; batch sizes at a batch tile's ends (1, 7, 8, 9) and the most
    rows (32); two calls bitwise equal (the splits are added in a fixed
    order, no atomics); one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.RandomState(b)
    w = PQ.quantize_q4(torch.from_numpy(rng.randn(11008, 4096).astype(np.float32) * 0.01).cuda(),
                       group_size=128)
    x = torch.from_numpy(rng.randn(b, 11008).astype(np.float32) * 0.5).cuda().bfloat16()
    before = K.LAUNCHES[f"q4_matmul_{body}"]
    got = K.q4_matmul_cuda(x, w.p, w.s, group=body == "group")
    again = K.q4_matmul_cuda(x, w.p, w.s, group=body == "group")
    ref = K.q4_matmul_reference(x, w.p, w.s, group=body == "group")
    torch.cuda.synchronize()
    assert K.LAUNCHES[f"q4_matmul_{body}"] == before + 2
    assert got.shape == (b, 4096) and torch.equal(got, again)
    assert _within(got.float().cpu().numpy(), ref.float().cpu().numpy(), "bfloat16")
