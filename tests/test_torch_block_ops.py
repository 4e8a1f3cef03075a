"""The block kernels' LayerNorm and bias + activation
(robustvlm_tpu_torch.ops.kernels.block_ops): the CLIP block's, the ReLU
form OPT's MLP takes, and the bias-free LayerNorm of OpenFlamingo's MPT.

On the CPU: `layer_norm`, `bias_act` and `Block.forward` give, bit for bit,
what the block computed before the kernels (frozen copies below), forward
and backward; and the Functions' analytic plain backwards agree with
autograd through that arithmetic. On a card (marked `cuda`, skipped here):
the kernels against the plain versions, their repeatability, three planted
faults, and the launches of one ViT-L/14 forward and pixel backward.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from robustvlm_tpu_torch.models.clip.model import CLIP, CLIP_CONFIGS, Block, TransformerConfig
from robustvlm_tpu_torch.ops import kernels
from robustvlm_tpu_torch.ops.kernels import block_ops as B

torch.set_num_threads(1)


# ------------------------------------- the block's code before the kernels
def _old_quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _old_layer_norm(x, g, b, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


def _old_block_forward(blk, x, causal=False):
    x = x + blk.attn(_old_layer_norm(x, blk.ln_1.g, blk.ln_1.b), causal, None)
    cd = x.dtype
    m = blk.mlp
    h = _old_layer_norm(x, blk.ln_2.g, blk.ln_2.b)
    h = h @ m.fc_w.to(cd)
    h = (_old_quick_gelu if blk.quick else F.gelu)(h + m.fc_b.to(cd))
    y = h @ m.proj_w.to(cd)
    return x + (y + m.proj_b.to(cd))


def _layer_norm_in(x, g, b, eps, acc):
    """The old decomposition with its statistics in `acc` (float64 here)."""
    xf = x.to(acc)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g.to(acc) + b.to(acc)).to(x.dtype)


def _inputs(shape, dtype, seed, shift=0.5):
    gen = torch.Generator().manual_seed(seed)
    w = shape[-1]
    x = (torch.randn(shape, generator=gen, dtype=torch.float64) * 2 + shift).to(dtype)
    g = (1 + 0.1 * torch.randn(w, generator=gen, dtype=torch.float64)).float()
    b = (0.1 * torch.randn(w, generator=gen, dtype=torch.float64)).float()
    dy = torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype)
    return x, g, b, dy


def _strided(x):
    """Rows of a (B, N, W) tensor taken at token 0, as `ln_post` takes them:
    N * W values apart."""
    return x[:, 0]


def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(-1).view(torch.uint8),
                                                                      b.view(-1).view(torch.uint8))


# ------------------------------------------------------------ CPU: bit for bit
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", ["contiguous", "strided_rows", "one_row"])
def test_layer_norm_cpu_bitwise_equals_old(dtype, layout):
    x, g, b, dy = _inputs((3, 5, 64), dtype, 0)
    if layout == "strided_rows":
        x, dy = _strided(x), dy[:, 0]
    elif layout == "one_row":
        x, dy = x[0, 0], dy[0, 0]
    for eps in (1e-5, 1e-6):
        xs = [x.clone().requires_grad_(True) for _ in range(2)]
        ps = [(g.clone().requires_grad_(True), b.clone().requires_grad_(True)) for _ in range(2)]
        new = B.layer_norm(xs[0], *ps[0], eps)
        old = _old_layer_norm(xs[1], *ps[1], eps)
        assert _bits_equal(new, old)
        gn = torch.autograd.grad(new, (xs[0], *ps[0]), dy)
        go = torch.autograd.grad(old, (xs[1], *ps[1]), dy)
        assert all(_bits_equal(a, c) for a, c in zip(gn, go))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_bias_act_relu_cpu_bitwise_equals_opt_mlp(dtype):
    """ReLU, as OPT's MLP ran it before the kernels: relu(h + b1 cast to
    h's dtype), forward and autograd, bit for bit on the CPU."""
    h, _, bias, dy = _inputs((4, 7, 256), dtype, 2, shift=0.0)
    hs = [h.clone().requires_grad_(True) for _ in range(2)]
    bs = [bias.clone().requires_grad_(True) for _ in range(2)]
    new = B.bias_act(hs[0], bs[0], "relu")
    old = F.relu(hs[1] + bs[1].to(dtype))
    assert _bits_equal(new, old)
    gn = torch.autograd.grad(new, (hs[0], bs[0]), dy)
    go = torch.autograd.grad(old, (hs[1], bs[1]), dy)
    assert all(_bits_equal(a, c) for a, c in zip(gn, go))


def test_bias_act_names_and_flags():
    assert [B.act_name(a) for a in (True, False, "quick_gelu", "gelu", "relu")] == \
        ["quick_gelu", "gelu", "quick_gelu", "gelu", "relu"]
    with pytest.raises(ValueError, match="unknown activation"):
        B.act_name("silu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("quick", [True, False], ids=["quick_gelu", "gelu"])
def test_bias_act_cpu_bitwise_equals_old(dtype, quick):
    h, _, bias, dy = _inputs((4, 7, 256), dtype, 1, shift=0.0)
    hs = [h.clone().requires_grad_(True) for _ in range(2)]
    bs = [bias.clone().requires_grad_(True) for _ in range(2)]
    new = B.bias_act(hs[0], bs[0], quick)
    old = (_old_quick_gelu if quick else F.gelu)(hs[1] + bs[1].to(dtype))
    assert _bits_equal(new, old)
    gn = torch.autograd.grad(new, (hs[0], bs[0]), dy)
    go = torch.autograd.grad(old, (hs[1], bs[1]), dy)
    assert all(_bits_equal(a, c) for a, c in zip(gn, go))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("quick", [True, False], ids=["quick_gelu", "gelu"])
@pytest.mark.parametrize("causal", [False, True], ids=["vision", "text"])
def test_block_forward_cpu_bitwise_equals_old(dtype, quick, causal):
    torch.manual_seed(2)
    blk = Block(TransformerConfig(64, 1, 4), quick)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            p.copy_(torch.randn_like(p) * (0.1 if p.dim() == 1 else 0.125) + name.endswith(".g"))
    x, _, _, dy = _inputs((2, 9, 64), dtype, 3)
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    new = blk(xs[0], causal)
    old = _old_block_forward(blk, xs[1], causal)
    assert _bits_equal(new, old)
    params = list(blk.parameters())
    for p in params:
        p.requires_grad_(True)
    gn = torch.autograd.grad(blk(xs[0], causal), [xs[0], *params], dy)
    go = torch.autograd.grad(_old_block_forward(blk, xs[1], causal), [xs[1], *params], dy)
    assert all(_bits_equal(a, c) for a, c in zip(gn, go))


def test_cpu_route_launches_no_kernel():
    x, g, b, dy = _inputs((4, 64), torch.float32, 4)
    kernels.reset_launches()
    x.requires_grad_(True)
    torch.autograd.grad(B.bias_act(B.layer_norm(x, g, b), b, True), x, dy)
    assert all(kernels.launches()[k] == 0 for k in B.LAUNCHES)


def test_counters_registered():
    assert set(B.LAUNCHES) <= set(kernels.launches())
    assert "block_ops" in kernels._build.KERNELS


def test_unsupported_device_raises():
    x = torch.empty(2, 8, device="meta")
    v = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        B.layer_norm(x, v, v)
    with pytest.raises(ValueError, match="unsupported device"):
        B.bias_act(x, v, True)


# ------------------------------------ CPU: the analytic plain backwards
@pytest.mark.parametrize("weights", [False, True], ids=["dx_only", "with_dg_db"])
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided_rows"])
def test_layer_norm_bwd_plain_float64_matches_autograd(weights, strided):
    # float64 throughout: the formula itself, to 1e-10 of each tensor's largest
    x, g, b, dy = _inputs((3, 6, 96), torch.float64, 5)
    g, b = g.double(), b.double()
    if strided:
        x, dy = _strided(x), dy[:, 0]
    eps = 1e-5
    xf = x.clone().requires_grad_(True)
    gf, bf = g.clone().requires_grad_(weights), b.clone().requires_grad_(weights)
    ref = torch.autograd.grad(_layer_norm_in(xf, gf, bf, eps, torch.float64),
                              (xf, gf, bf) if weights else (xf,), dy)
    mean = x.mean(-1)
    rstd = torch.rsqrt(x.var(-1, unbiased=False) + eps)
    got = B.layer_norm_bwd_plain(x, g, mean, rstd, dy, weights)
    got = got if weights else got[:1]
    assert B.layer_norm_bwd_plain(x, g, mean, rstd, dy, False)[1:] == (None, None)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=1e-10 * float(r.abs().max()), rtol=0)


@pytest.mark.parametrize("need", ["x", "x_g", "x_b", "x_g_b"])
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided_rows"])
def test_layer_norm_fn_float32_matches_autograd(need, strided):
    # float32: the Function's plain forward and analytic backward against
    # autograd through the old decomposition, both in float32 with their sums
    # in other orders: 1e-5 of each tensor's largest magnitude
    x, g, b, dy = _inputs((3, 6, 128), torch.float32, 6)
    if strided:
        x, dy = _strided(x), dy[:, 0]
    outs = []
    for fn in (lambda *a: B.LayerNormFn.apply(*a, 1e-5), _old_layer_norm):
        xf = x.clone().requires_grad_(True)
        gf, bf = g.clone().requires_grad_("g" in need), b.clone().requires_grad_("b" in need)
        y = fn(xf, gf, bf)
        wrt = [t for t in (xf, gf, bf) if t.requires_grad]
        outs.append((y, torch.autograd.grad(y, wrt, dy)))
    (y, got), (y_ref, ref) = outs
    assert _bits_equal(y, y_ref)
    assert len(got) == len(ref) == 1 + ("g" in need) + ("b" in need)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=1e-5 * float(r.abs().max()), rtol=0)


@pytest.mark.parametrize("quick", [True, False], ids=["quick_gelu", "gelu"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["dh_only", "with_dbias"])
def test_bias_act_bwd_plain_float64_matches_autograd(quick, with_bias):
    h, _, bias, dy = _inputs((5, 3, 48), torch.float64, 7, shift=0.0)
    bias = bias.double()
    hf, bf = h.clone().requires_grad_(True), bias.clone().requires_grad_(with_bias)
    ref = torch.autograd.grad(B.bias_act_plain(hf, bf, quick), (hf, bf) if with_bias else (hf,), dy)
    dh, db = B.bias_act_bwd_plain(h, bias, dy, quick, with_bias)
    got = (dh, db) if with_bias else (dh,)
    assert with_bias == (db is not None)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=1e-12 * float(r.abs().max()), rtol=0)


@pytest.mark.parametrize("with_bias", [False, True], ids=["dh_only", "with_dbias"])
def test_bias_act_relu_plain_backward_matches_autograd(with_bias):
    """ReLU's analytic backward, dy where z > 0 (float64, and the Function in
    float32, where it is exact), against autograd through `bias_act_plain`."""
    for dtype in (torch.float64, torch.float32):
        h, _, bias, dy = _inputs((5, 3, 48), dtype, 7, shift=0.0)
        bias = bias.to(dtype)
        hf, bf = h.clone().requires_grad_(True), bias.clone().requires_grad_(with_bias)
        ref = torch.autograd.grad(B.bias_act_plain(hf, bf, "relu"), (hf, bf) if with_bias else (hf,), dy)
        dh, db = B.bias_act_bwd_plain(h, bias, dy, "relu", with_bias)
        assert _bits_equal(dh, ref[0])
        if with_bias:
            torch.testing.assert_close(db.to(dtype), ref[1], atol=1e-6 * float(ref[1].abs().max()), rtol=0)
        hg = h.clone().requires_grad_(True)
        (fn_dh,) = torch.autograd.grad(B.BiasActFn.apply(hg, bias, "relu"), hg, dy)
        assert _bits_equal(fn_dh, ref[0])


@pytest.mark.parametrize("quick", [True, False], ids=["quick_gelu", "gelu"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["dh_only", "with_dbias"])
def test_bias_act_fn_float32_matches_autograd(quick, with_bias):
    # float32, another order of operations: 1e-5 of each tensor's largest
    h, _, bias, dy = _inputs((6, 5, 64), torch.float32, 8, shift=0.0)
    outs = []
    for fn in (lambda a, c: B.BiasActFn.apply(a, c, quick), lambda a, c: B.bias_act_plain(a, c, quick)):
        hf, bf = h.clone().requires_grad_(True), bias.clone().requires_grad_(with_bias)
        y = fn(hf, bf)
        outs.append((y, torch.autograd.grad(y, [t for t in (hf, bf) if t.requires_grad], dy)))
    (y, got), (y_ref, ref) = outs
    assert _bits_equal(y, y_ref)
    assert len(got) == len(ref) == 1 + with_bias
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=1e-5 * float(r.abs().max()), rtol=0)


# OpenFlamingo's three LayerNorm calls: MPT's bias-free one and the
# cross-attention's over the bf16 text at width 4096, and the Perceiver's in
# float32 at width 1024
FLAMINGO_CALLS = [(torch.bfloat16, 4096, False), (torch.bfloat16, 4096, True), (torch.float32, 1024, True)]
FLAMINGO_IDS = ["bf16_4096_bias_free", "bf16_4096_bias", "fp32_1024_bias"]


def _old_layer_norm_or_bias_free(x, g, b, eps=1e-5):
    """`_old_layer_norm`, and with b None the same arithmetic without the
    bias add."""
    if b is not None:
        return _old_layer_norm(x, g, b, eps)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g.float()).to(x.dtype)


@pytest.mark.parametrize("dtype,w,bias", FLAMINGO_CALLS, ids=FLAMINGO_IDS)
def test_layer_norm_fn_bias_free_cpu(dtype, w, bias):
    """On the CPU, `layer_norm` and `LayerNormFn` with b=None give the
    bias-free arithmetic bit for bit (with b, the old one), and the
    Function's analytic backward agrees with autograd through that
    arithmetic: dx within BWD_TOL of x's dtype, dg and db (float32) within
    1e-5 of their largest. No bias gradient is returned without a bias."""
    x, g, b, dy = _inputs((3, 5, w), dtype, 14 + bias)
    b = b if bias else None
    kernels.reset_launches()
    assert _bits_equal(B.layer_norm(x, g, b), _old_layer_norm_or_bias_free(x, g, b))
    assert _bits_equal(B.LayerNormFn.apply(x, g, b, 1e-5), _old_layer_norm_or_bias_free(x, g, b))
    outs = []
    for fn in (lambda *a: B.LayerNormFn.apply(*a, 1e-5), _old_layer_norm_or_bias_free):
        xf, gf = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
        bf = None if b is None else b.clone().requires_grad_(True)
        y = fn(xf, gf, bf)
        outs.append(torch.autograd.grad(y, [t for t in (xf, gf, bf) if t is not None], dy))
    got, ref = outs
    assert len(got) == len(ref) == 2 + bias
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype
        assert _close(a, r, r.dtype), (a.dtype, float((a.float() - r.float()).abs().max()))
    assert all(kernels.launches()[k] == 0 for k in B.LAUNCHES)


# ------------------------------------------------------------------ the card
LN_WIDTHS = (64, 100, 768, 1024, 1408, 4096, 8192)  # 100: one value at a time (no 16-byte words)
ACT_WIDTHS = (256, 100, 3072, 4096, 6144)  # the blocks' hidden widths, and a ragged one
ROWS = (37, 1029)  # ragged against the 8 rows of a block and the 4 rows of an unroll
# backward and weight gradients: within these shares of each tensor's largest
# magnitude. bf16: dx and dh are rounded once to bf16 (2^-8 of a value)
# after float32 sums taken in another order; float32: only the order of the
# sums and the kernels' fast exp and rsqrt differ.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_inputs(rows, w, dtype, seed, shift=0.5):
    return [t.cuda() for t in _inputs((rows, w), dtype, seed, shift)]


def _bf16_ulp(ref):
    """One bf16 unit in the last place of each value of ref (float32)."""
    a = ref.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _forward_ok(got, ref, terms=None) -> bool:
    """bf16: within 2 ulp of the plain value, element by element (both round
    a float32 value once), plus 2^-16 of `terms`, the magnitude of the float32
    terms that sum to the value: where they cancel, the float32 rounding of
    the terms and of the row's sums (a few 2^-24 each) is many ulp of the
    small result; 2^-16 is still 2^-8 of one bf16 ulp of the terms. float32:
    1e-5 of the largest magnitude."""
    d = (got.float() - ref.float()).abs()
    if got.dtype == torch.bfloat16:
        slack = 0.0 if terms is None else 2.0 ** -16 * terms
        return bool((d <= 2 * _bf16_ulp(ref) + slack).all())
    return bool(d.max() <= 1e-5 * ref.float().abs().max())


def _ln_terms(x, g, b, mean, rstd):
    """|x_hat g| + |b|: the two float32 terms LayerNorm's output sums."""
    xh = (x.float() - mean.unsqueeze(-1)) * rstd.unsqueeze(-1)
    return (xh * g).abs() + b.abs()


def _ln_sum_terms(x, g, b, mean, rstd):
    """(|x| + |mean|) rstd |g| + |b|: the float32 terms of each output with
    x - mean's own. A bias-free output is a product of x - mean, so where x
    sits near its row's mean the rounding of the mean (a few 2^-24 of it)
    is many ulp of the small result, which `_ln_terms` covers only through
    |b|."""
    t = (x.float().abs() + mean.abs().unsqueeze(-1)) * rstd.unsqueeze(-1) * g.abs()
    return t if b is None else t + b.abs()


def _close(got, ref, dtype) -> bool:
    return bool((got.float() - ref.float()).abs().max() <= BWD_TOL[dtype] * ref.float().abs().max())


def record_layer_norms(monkeypatch) -> list:
    """Route `block_ops.layer_norm` through a recorder for the test: each
    call's x (a detached copy), g, b and eps, in call order; the call itself
    runs as before."""
    calls, real = [], B.layer_norm

    def rec(x, g, b, eps=1e-5):
        calls.append((x.detach().clone(), g.detach(), None if b is None else b.detach(), eps))
        return real(x, g, b, eps)

    monkeypatch.setattr(B, "layer_norm", rec)
    return calls


def card_call_matches_cpu(call, cpu_fn, seed: int) -> bool:
    """One recorded call, run on the card through `LayerNormFn` (the
    kernels), against `cpu_fn(x, g, b, eps)`, the calling module's CPU
    arithmetic, on the same inputs moved to the CPU: the forward within 2
    bf16 ulp plus 2^-16 of `_ln_sum_terms` (`_forward_ok`; float32: 1e-5
    of the largest), and dx for a random dy through autograd within
    BWD_TOL."""
    x, g, b, eps = call
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(seed)).to(x.dtype)
    outs = []
    for dev in (x.device, torch.device("cpu")):
        xa = x.detach().to(dev).requires_grad_(True)
        ga, ba = g.to(dev), None if b is None else b.to(dev)
        y = B.LayerNormFn.apply(xa, ga, ba, eps) if dev.type == "cuda" else cpu_fn(xa, ga, ba, eps)
        outs.append((y.detach().cpu(), torch.autograd.grad(y, xa, dy.to(dev))[0].cpu()))
    (y, dx), (y_ref, dx_ref) = outs
    xc, gc = x.cpu().float(), g.cpu()
    mean = xc.mean(-1)
    rstd = torch.rsqrt(xc.var(-1, unbiased=False) + eps)
    terms = _ln_sum_terms(xc, gc, None if b is None else b.cpu(), mean, rstd)
    return _forward_ok(y, y_ref, terms) and _close(dx, dx_ref, x.dtype)


def _check_layer_norm(x, g, b, dy, dtype):
    """Forward, then backward with weight gradients, kernel against plain;
    the plain backward takes the kernel's own saved statistics."""
    y, mean, rstd = B.layer_norm_fwd_cuda(x, g, b, 1e-5)
    y_ref, mean_ref, rstd_ref = B.layer_norm_fwd_plain(x, g, b, 1e-5)
    fwd = _forward_ok(y, y_ref, _ln_terms(x, g, b, mean_ref, rstd_ref)) and \
        _close(mean, mean_ref, torch.float32) and \
        _close(rstd, rstd_ref, torch.float32)
    got = B.layer_norm_bwd_cuda(x, g, mean, rstd, dy, True)
    ref = B.layer_norm_bwd_plain(x, g, mean_ref, rstd_ref, dy, True)
    return fwd, [_close(a, r, dtype) for a, r in zip(got, ref)]


def _act_ref(h, bias, quick):
    """The kernel's arithmetic in plain PyTorch: z rounded to h's dtype, the
    activation in float32, rounded once."""
    z = (h + bias.to(h.dtype)).float()
    return B.bias_act_plain(z, torch.zeros_like(bias), quick).to(h.dtype)


def _check_bias_act(h, bias, dy, quick, dtype):
    out = B.bias_act_fwd_cuda(h, bias, quick)
    fwd = _forward_ok(out, _act_ref(h, bias, quick)) and \
        _close(out, B.bias_act_plain(h, bias, quick), dtype)
    got = B.bias_act_bwd_cuda(h, bias, dy, quick, True)
    ref = B.bias_act_bwd_plain(h, bias, dy, quick, True)
    return fwd, [_close(a, r, dtype) for a, r in zip(got, ref)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("w", LN_WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
def test_cuda_layer_norm_matches_plain(dtype, w, rows):
    _cuda()
    x, g, b, dy = _card_inputs(rows, w, dtype, w + rows)
    before = dict(B.LAUNCHES)
    fwd, bwd = _check_layer_norm(x, g, b, dy, dtype)
    assert fwd and all(bwd), (fwd, bwd)
    assert B.LAUNCHES["layer_norm_fwd"] == before["layer_norm_fwd"] + 1
    assert B.LAUNCHES["layer_norm_bwd"] == before["layer_norm_bwd"] + 1
    # without weight gradients: the same dx, bit for bit
    y, mean, rstd = B.layer_norm_fwd_cuda(x, g, b, 1e-5)
    dx, dg, db = B.layer_norm_bwd_cuda(x, g, mean, rstd, dy, False)
    assert dg is None and db is None
    assert torch.equal(dx, B.layer_norm_bwd_cuda(x, g, mean, rstd, dy, True)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,w,bias", FLAMINGO_CALLS, ids=FLAMINGO_IDS)
def test_cuda_layer_norm_flamingo_calls(dtype, w, bias):
    """OpenFlamingo's three calls through `layer_norm` and autograd at their
    row counts (64 images x 34 text tokens; 64 x 64 latents): one launch
    each way; the forward within 2 bf16 ulp plus 2^-16 of `_ln_sum_terms`
    (float32: 1e-5 of the largest) and dx within BWD_TOL of the plain
    versions. Bias-free, the kernel gives, bit for bit, its launch with an
    explicit zero bias; no bias gradient comes back."""
    _cuda()
    x, g, b, dy = _card_inputs(64 * 34 if w == 4096 else 64 * 64, w, dtype, w + bias)
    b = b if bias else None
    xg, gg = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    before = dict(B.LAUNCHES)
    y = B.layer_norm(xg, gg, b)
    grads = torch.autograd.grad(y, (xg, gg), dy)
    assert B.LAUNCHES["layer_norm_fwd"] == before["layer_norm_fwd"] + 1
    assert B.LAUNCHES["layer_norm_bwd"] == before["layer_norm_bwd"] + 1
    y_ref, mean_ref, rstd_ref = B.layer_norm_fwd_plain(x, g, b, 1e-5)
    assert _forward_ok(y, y_ref, _ln_sum_terms(x, g, b, mean_ref, rstd_ref))
    dx_ref, dg_ref, _ = B.layer_norm_bwd_plain(x, g, mean_ref, rstd_ref, dy, True)
    assert _close(grads[0], dx_ref, dtype) and _close(grads[1], dg_ref, torch.float32)
    if b is None:
        assert torch.equal(y, B.layer_norm_fwd_cuda(x, g, torch.zeros_like(g), 1e-5)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cuda_layer_norm_strided_rows(dtype):
    dev = _cuda()
    x, g, b, dy = _inputs((130, 257, 1024), dtype, 9)
    x, g, b = x.to(dev), g.to(dev), b.to(dev)
    xs = x[:, 0]  # rows 257 * 1024 values apart
    assert not xs.is_contiguous()
    fwd, bwd = _check_layer_norm(xs, g, b, dy[:, 0].to(dev), dtype)
    assert fwd and all(bwd), (fwd, bwd)
    # through autograd, as `ln_post` runs it: dx lands in token 0's rows only
    xg = x.clone().requires_grad_(True)
    dx, = torch.autograd.grad(B.layer_norm(xg[:, 0], g, b).float().sum(), xg)
    assert dx[:, 1:].abs().max() == 0 and dx[:, 0].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("quick", [True, False], ids=["quick_gelu", "gelu"])
@pytest.mark.parametrize("w", ACT_WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
def test_cuda_bias_act_matches_plain(dtype, quick, w, rows):
    _cuda()
    h, _, bias, dy = _card_inputs(rows, w, dtype, w + rows, shift=0.0)
    before = dict(B.LAUNCHES)
    fwd, bwd = _check_bias_act(h, bias, dy, quick, dtype)
    assert fwd and all(bwd), (fwd, bwd)
    assert B.LAUNCHES["bias_act_fwd"] == before["bias_act_fwd"] + 1
    assert B.LAUNCHES["bias_act_bwd"] == before["bias_act_bwd"] + 1
    dh, db = B.bias_act_bwd_cuda(h, bias, dy, quick, False)
    assert db is None and torch.equal(dh, B.bias_act_bwd_cuda(h, bias, dy, quick, True)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows", [64 * 69, 64 * 96, 37])
def test_cuda_bias_act_relu_at_opt_shape(dtype, rows):
    """ReLU at OPT-2.7B's MLP width (10240) over 64 images' 69 or 96 (the
    prompt padded to 64 text tokens) positions, and a ragged row count:
    forward exact against the plain version, dh bit for bit (a product by 1
    or 0, rounded once), dbias within the sums' tolerance."""
    _cuda()
    h, _, bias, dy = _card_inputs(rows, 10240, dtype, rows, shift=0.0)
    before = dict(B.LAUNCHES)
    fwd, bwd = _check_bias_act(h, bias, dy, "relu", dtype)
    assert fwd and all(bwd), (fwd, bwd)
    assert B.LAUNCHES["bias_act_fwd"] == before["bias_act_fwd"] + 1
    assert torch.equal(B.bias_act_fwd_cuda(h, bias, "relu"), B.bias_act_plain(h, bias, "relu"))
    dh, _ = B.bias_act_bwd_cuda(h, bias, dy, "relu", False)
    assert torch.equal(dh, B.bias_act_bwd_plain(h, bias, dy, "relu", False)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cuda_backward_bitwise_repeatable(dtype):
    """At the ViT-L/14 cell's shapes (128 x 257 rows): no atomics, so two
    backwards on the same inputs give the same bits, weight gradients too."""
    _cuda()
    rows = 128 * 257
    x, g, b, dy = _card_inputs(rows, 1024, dtype, 10)
    y, mean, rstd = B.layer_norm_fwd_cuda(x, g, b, 1e-5)
    first = B.layer_norm_bwd_cuda(x, g, mean, rstd, dy, True)
    h, _, bias, dh_in = _card_inputs(rows, 4096, dtype, 11, shift=0.0)
    first_act = B.bias_act_bwd_cuda(h, bias, dh_in, True, True)
    for _ in range(2):
        assert all(torch.equal(a, c) for a, c in zip(first, B.layer_norm_bwd_cuda(x, g, mean, rstd, dy, True)))
        assert all(torch.equal(a, c) for a, c in zip(first_act, B.bias_act_bwd_cuda(h, bias, dh_in, True, True)))


# Planted faults, each a one-line edit of csrc/block_ops.cu built on the side:
# (name, the line as it is, the line with the fault, what must catch it)
FAULTS = [
    ("rstd_x1.01", "const float rs = rsqrtf(q[0] / (float)width + eps);",
     "const float rs = 1.01f * rsqrtf(q[0] / (float)width + eps);", "layer_norm forward"),
    ("dropped_mean_term", "o[i] = rs * (wd[k] - a - xh[k] * cc);",
     "o[i] = rs * (wd[k] - xh[k] * cc);", "layer_norm dx"),
    ("bias_grad_off_by_one_row", "if constexpr (kBias) acc[i] += o[i];",
     "if constexpr (kBias) if (r != 0) acc[i] += o[i];", "bias_act dbias"),
]


@pytest.fixture(scope="module")
def fault_libs(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from robustvlm_tpu_torch.ops.kernels import _build

    src = (_build.CSRC / "block_ops.cu").read_text()
    sources = {}
    for name, line, fault, _ in FAULTS:
        assert src.count(line) == 1, f"the line of fault {name} is not in block_ops.cu"
        sources[name] = src.replace(line, fault)
    built = _build.build_variants(sources, tmp_path_factory.mktemp("block_ops_faults"), "fault")
    return {name: B.bind(lib) for name, (lib, _) in built.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("fault", [f[0] for f in FAULTS])
def test_cuda_planted_faults_caught(fault_libs, monkeypatch, dtype, fault):
    _cuda()
    caught_by = dict((f[0], f[3]) for f in FAULTS)[fault]
    x, g, b, dy = _card_inputs(257, 1024, dtype, 12)
    dy = dy + 0.5  # rows of dy with a mean, as a real backward has: the mean term then counts
    h, _, bias, dh_in = _card_inputs(64, 4096, dtype, 13, shift=0.0)
    sound = (_check_layer_norm(x, g, b, dy, dtype), _check_bias_act(h, bias, dh_in, True, dtype))
    assert sound[0][0] and all(sound[0][1]) and sound[1][0] and all(sound[1][1])
    monkeypatch.setattr(B, "_lib", lambda: fault_libs[fault])
    (ln_fwd, (ln_dx, _, _)), (_, (_, act_db)) = (_check_layer_norm(x, g, b, dy, dtype),
                                                 _check_bias_act(h, bias, dh_in, True, dtype))
    ok = {"layer_norm forward": ln_fwd, "layer_norm dx": ln_dx, "bias_act dbias": act_db}
    assert not ok[caught_by], f"fault {fault} not caught by the {caught_by} check"


@pytest.mark.cuda
def test_cuda_vit_l14_launches():
    """One ViT-L/14 forward and pixel backward in bf16: 50 LayerNorms (ln_pre,
    two a block, ln_post) and 24 bias + QuickGELU, each way."""
    dev = _cuda()
    model = CLIP(CLIP_CONFIGS["ViT-L-14"], device=dev).init_random_(0)
    x = torch.rand(2, 3, 224, 224, device=dev, requires_grad=True)
    kernels.reset_launches()
    emb = model.encode_image(x, compute_dtype=torch.bfloat16)
    fwd = kernels.launches()
    torch.autograd.grad(emb.sum(), x)
    both = kernels.launches()
    assert (fwd["layer_norm_fwd"], fwd["bias_act_fwd"], fwd["layer_norm_bwd"], fwd["bias_act_bwd"]) == \
        (50, 24, 0, 0)
    assert (both["layer_norm_bwd"], both["bias_act_bwd"]) == (50, 24)
    assert math.isfinite(float(emb.float().sum()))
