"""The attention kernels' head layouts (robustvlm_tpu_torch.ops.kernels._heads).

The bf16 kernels read q, k, v and dO through their strides and write O, dQ,
dK and dV where theirs say, so the callers hand them views of their
projections and get O token-major. On the CPU: the layout rule takes the
views each call site passes and refuses what TMA cannot address, and the
packed and view forms give the bits the split-then-attend path gave (the
plain versions see the same contiguous operands). On the card (`cuda`
marker): the view and packed launches are bitwise the contiguous launch,
and no bf16 caller's operand is copied.
"""

import math
import re

import numpy as np
import pytest
import torch

from robustvlm_tpu_torch.models.mpt.model import alibi_slopes
from robustvlm_tpu_torch.ops.kernels import _heads
from robustvlm_tpu_torch.ops.kernels import flash_attention as F
from robustvlm_tpu_torch.ops.kernels import vit_attention as A

torch.set_num_threads(1)

# (label, batch, heads, n, head dim, packed): the views of each call site at
# the benchmark's shapes. Packed: CLIP's ViT-L/14 and EVA's ViT-g/14 (fused
# qkv), MPT-7B in OpenFlamingo (fused Wqkv), a ViT-L/14 block split over
# `model` = 2 (the local [q_r|k_r|v_r] of 8 heads); OPT-2.7B's separate q,
# k, v projections at head dim 80.
CALL_SITES = [
    ("vitl14", 128, 16, 257, 64, True),
    ("evag14", 64, 16, 257, 88, True),
    ("opt", 64, 32, 96, 80, False),
    ("mpt", 64, 32, 34, 128, True),
    ("vitl14_tp2", 128, 8, 257, 64, True),
]


def _site_views(b, h, n, d, packed, device="meta", dtype=torch.bfloat16):
    """q, k, v as the call site makes them, and the (B, N, W) it feeds dO from."""
    w = h * d
    if packed:
        q, k, v = _heads.qkv_views(torch.empty(b, n, 3 * w, dtype=dtype, device=device), h)
    else:
        q, k, v = (_heads.heads_of(torch.empty(b, n, w, dtype=dtype, device=device), h) for _ in range(3))
    return q, k, v, torch.empty(b, n, w, dtype=dtype, device=device)


@pytest.mark.parametrize("label,b,h,n,d,packed", CALL_SITES, ids=[c[0] for c in CALL_SITES])
def test_layout_rule_takes_each_call_sites_views(label, b, h, n, d, packed):
    """q, k, v, dO (a head view of the out-projection's gradient), O as the
    wrappers allocate it and the gradients' views into one (B, N, 3W) tensor
    all pass as they lie: nothing is copied on the bf16 path."""
    q, k, v, dout = _site_views(b, h, n, d, packed)
    o = _heads.empty_out(q)
    grads = _heads.qkv_views(torch.empty(b, n, 3 * h * d, dtype=torch.bfloat16, device="meta"), h)
    for t in (q, k, v, _heads.heads_of(dout, h), o, *grads):
        assert t.shape == (b, h, n, d) and not t.is_contiguous()
        assert _heads.layout_problem(t) is None
    # the strides the kernel is handed: (batch, head, row), the row one the
    # projection's width
    row = 3 * h * d if packed else h * d
    assert list(_heads.strides([q])) == [n * row, d, row]
    assert list(_heads.strides([o])) == [n * h * d, d, h * d]


def test_layout_rule_refuses_what_the_kernels_cannot_address():
    x = torch.zeros(2, 16, 3 * 4 * 64, dtype=torch.bfloat16)
    q = _heads.qkv_views(x, 4)[0]
    assert _heads.layout_problem(q) is None
    # the head dim not contiguous
    assert "last stride 1" in _heads.layout_problem(q.transpose(-1, -2))
    # a row stride of 4 bytes past whole 16
    y = torch.zeros(2, 16, 4 * 64 + 2, dtype=torch.bfloat16)[..., :256]
    assert "16 bytes" in _heads.layout_problem(_heads.heads_of(y, 4))
    # a base 2 bytes past a 16-byte boundary
    z = torch.zeros(2 * 16 * 256 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 256)
    assert "aligned" in _heads.layout_problem(_heads.heads_of(z, 4))
    # float32 takes contiguous operands only, and a size-1 dim's stride is free
    assert "contiguous" in _heads.layout_problem(_heads.heads_of(torch.zeros(2, 16, 256), 4))
    assert _heads.layout_problem(torch.zeros(2, 4, 16, 64)) is None
    one = torch.zeros(1, 16, 4, 64, dtype=torch.bfloat16).transpose(1, 2)[:, :, :1]
    assert _heads.layout_problem(one) is None
    assert list(_heads.strides([one])) == [4 * 64, 64, 64]


def test_float32_strides_are_those_of_a_contiguous_array():
    """The float32 kernels take no strides: what the wrappers pass for a
    contiguous (B*H, N, D) array or (B, H, N, D) one is what csrc's
    `packed()` accepts, (H N D, N D, D)."""
    assert list(_heads.strides([torch.zeros(6, 10, 64)])) == [640, 640, 64]
    assert list(_heads.strides([torch.zeros(2, 3, 10, 64)])) == [1920, 640, 64]


# ------------------------------------------------- the names the trace reads
def test_attention_source_holds_each_entrys_tables_and_is_built_once():
    """The benchmark's trace readers tell a ViT launch from a flash launch
    by the tile struct in the kernel's name (`VitBf16*` against `Bf16*`).
    csrc/attention.cu declares the six tables; each head dim of each entry
    point has its specialisations in its own set, and the dispatch builds
    each set at exactly those head dims under the entry's `tables` number;
    `_build` names every source under csrc/ once."""
    from robustvlm_tpu_torch.ops.kernels import _build

    src = (_build.CSRC / "attention.cu").read_text()
    body = src[src.index("int dispatch("):]
    body = body[:body.index("\n}\n")]
    cases = dict(zip(*[iter(re.split(r"tables == (\d+)", body)[1:])] * 2))
    sets = [(F.FLASH, "F32Tile", "Bf16Fwd", "Bf16Bwd", "FlashTables"),
            (A.VIT, "VitF32Tile", "VitBf16Fwd", "VitBf16Bwd", "VitTables")]
    for entry, f32, fwd, bwd, tables in sets:
        for struct in (f32, fwd, bwd):
            assert re.search(rf"^struct {struct};$", src, re.M), struct
        dims = set(entry.head_dims)
        kinds = re.findall(rf"^struct {f32}<(\d+), (kFwd|kDq|kDkv)> {{", src, re.M)
        assert sorted(kinds) == sorted((str(d), k) for d in dims for k in ("kFwd", "kDq", "kDkv"))
        for struct in (fwd, bwd):
            assert {int(d) for d in re.findall(rf"^struct {struct}<(\d+)> {{", src, re.M)} == dims
        built = re.findall(r"case (\d+): return f\((\w+)\{\}", cases[str(entry.tables)])
        assert sorted(built) == sorted((str(d), tables) for d in dims)
    assert sorted(_build.KERNELS) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert len(set(_build.KERNELS)) == len(_build.KERNELS)


# --------------------------------------------------------------- CPU, bitwise
class _SplitThenAttend(torch.autograd.Function):
    """The path before the kernels took views: contiguous (B*H, N, D) copies
    into the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, fwd, bwd):
        o, lse = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.bwd = bwd
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*ctx.bwd(q, k, v, o, lse, do.to(q.dtype).contiguous()), None, None)


def _split_then_attend(qkv, h, fwd, bwd):
    b, n, w3 = qkv.shape
    d = w3 // 3 // h
    q, k, v = (t.reshape(b, n, h, d).transpose(1, 2).reshape(b * h, n, d).contiguous()
               for t in qkv.split(w3 // 3, dim=-1))
    o = _SplitThenAttend.apply(q, k, v, fwd, bwd)
    return o.reshape(b, h, n, d).transpose(1, 2).reshape(b, n, h * d)


def _vit_plain():
    return A.attention_fwd_plain, A.attention_bwd_plain


def _flash_plain(b, h, causal, alibi):
    slopes = torch.from_numpy(alibi_slopes(h)).float().repeat(b) if alibi else None
    return (lambda q, k, v: F.flash_fwd_plain(q, k, v, causal=causal, slopes=slopes),
            lambda q, k, v, o, lse, do: F.flash_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                                          slopes=slopes))


def _run(fn, qkv, g):
    x = qkv.clone().requires_grad_(True)
    out = fn(x)
    out.backward(g)
    return out.detach(), x.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,n,d", [(2, 4, 57, 64), (1, 2, 33, 88), (2, 2, 20, 16)])
def test_vit_attention_qkv_is_split_then_attend_bit_for_bit(dtype, b, h, n, d):
    rng = np.random.RandomState(b + h + n + d)
    qkv = torch.from_numpy(rng.randn(b, n, 3 * h * d).astype(np.float32) * 0.5).to(dtype)
    g = torch.from_numpy(rng.randn(b, n, h * d).astype(np.float32)).to(dtype)
    want = _run(lambda x: _split_then_attend(x, h, *_vit_plain()), qkv, g)
    got = _run(lambda x: A.vit_attention_qkv(x, h), qkv, g)
    views = _run(lambda x: A.vit_attention(*_heads.qkv_views(x, h)).transpose(1, 2).reshape(b, n, h * d),
                 qkv, g)
    for a, c, e in zip(got, views, want):
        assert a.dtype == dtype and torch.equal(a, e) and torch.equal(c, e)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal,alibi", [(True, False), (True, True), (False, False)],
                         ids=["causal", "causal_alibi", "full"])
def test_flash_attention_qkv_is_split_then_attend_bit_for_bit(dtype, causal, alibi):
    b, h, n, d = 2, 4, 37, 32
    rng = np.random.RandomState(7)
    qkv = torch.from_numpy(rng.randn(b, n, 3 * h * d).astype(np.float32) * 0.5).to(dtype)
    g = torch.from_numpy(rng.randn(b, n, h * d).astype(np.float32)).to(dtype)
    slopes = torch.from_numpy(alibi_slopes(h)).float() if alibi else None
    want = _run(lambda x: _split_then_attend(x, h, *_flash_plain(b, h, causal, alibi)), qkv, g)
    got = _run(lambda x: F.flash_attention_qkv(x, h, causal=causal, alibi_slopes=slopes), qkv, g)
    views = _run(lambda x: F.flash_attention(*_heads.qkv_views(x, h), causal=causal,
                                             alibi_slopes=slopes).transpose(1, 2).reshape(b, n, h * d),
                 qkv, g)
    for a, c, e in zip(got, views, want):
        assert a.dtype == dtype and torch.equal(a, e) and torch.equal(c, e)


def test_cpu_packed_forms_count_no_launch_and_no_copy():
    from robustvlm_tpu_torch.ops import kernels

    before = kernels.launches()
    x = torch.randn(1, 9, 3 * 2 * 16, requires_grad=True)
    (A.vit_attention_qkv(x, 2).sum() + F.flash_attention_qkv(x, 2, causal=True).sum()).backward()
    assert kernels.launches() == before


# ------------------------------------------------------------------ the card
def _card_site(kind, b, h, n, d, packed, causal, alibi, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = h * d

    def rand(*shape):
        return (torch.randn(*shape, generator=g, device="cuda") * 0.5).bfloat16()

    qkv = rand(b, n, 3 * w) if packed else None
    views = (_heads.qkv_views(qkv, h) if packed
             else tuple(_heads.heads_of(rand(b, n, w), h) for _ in range(3)))
    dout = rand(b, n, w)
    kw = {}
    if kind == "flash":
        kw["causal"] = causal
        if alibi:
            kw["slopes"] = torch.from_numpy(alibi_slopes(h)).float().cuda().repeat(b).contiguous()
    return qkv, views, dout, kw


CARD_CASES = [
    ("vitl14", "vit", 128, 16, 257, 64, True, False, False),
    ("evag14", "vit", 64, 16, 257, 88, True, False, False),
    ("opt", "flash", 64, 32, 96, 80, False, True, False),
    ("mpt", "flash", 64, 32, 34, 128, True, True, True),
    ("vitl14_tp2", "vit", 128, 8, 257, 64, True, False, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("label,kind,b,h,n,d,packed,causal,alibi", CARD_CASES,
                         ids=[c[0] for c in CARD_CASES])
def test_cuda_view_launches_are_the_contiguous_launch_bitwise(label, kind, b, h, n, d, packed,
                                                              causal, alibi):
    """O, lse, dQ, dK and dV from the callers' views (and, packed, into one
    fused gradient) equal the contiguous (B*H, N, D) launch bit for bit:
    only the addressing changed. No operand is copied."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    fwd, bwd = ((A.attention_fwd, A.attention_bwd) if kind == "vit"
                else (F.flash_fwd_cuda, F.flash_bwd_cuda))
    copied = "vit_attention_copied" if kind == "vit" else "flash_attention_copied"
    counters = A.LAUNCHES if kind == "vit" else F.LAUNCHES
    qkv, (q, k, v), dout, kw = _card_site(kind, b, h, n, d, packed, causal, alibi, seed=n + d)
    do = _heads.heads_of(dout, h)
    flat = [t.reshape(b * h, n, d).contiguous() for t in (q, k, v, do)]
    oc, lsec = fwd(*flat[:3], **kw)
    gc = bwd(*flat[:3], oc, lsec, flat[3], **kw)
    before = counters[copied]
    o = _heads.heads_of(torch.empty(b, n, h * d, dtype=torch.bfloat16, device="cuda"), h)
    _, lse = fwd(q, k, v, o, **kw)
    grads = (_heads.qkv_views(torch.empty_like(qkv), h) if packed
             else tuple(_heads.empty_out(t) for t in (q, k, v)))
    bwd(q, k, v, o, lse, do, grads, **kw)
    torch.cuda.synchronize()
    assert counters[copied] == before
    assert torch.equal(o.reshape(oc.shape), oc) and torch.equal(lse, lsec)
    for name, a, c in zip(("dq", "dk", "dv"), grads, gc):
        assert torch.equal(a.reshape(c.shape), c), name


@pytest.mark.cuda
@pytest.mark.parametrize("label,kind,b,h,n,d,packed,causal,alibi", CARD_CASES,
                         ids=[c[0] for c in CARD_CASES])
def test_cuda_callers_autograd_copies_nothing(label, kind, b, h, n, d, packed, causal, alibi):
    """The call sites' autograd path in bf16 (the packed Function, or the
    views one for OPT): the contiguous launch's bits, `*_copied` unmoved."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    qkv, views, dout, kw = _card_site(kind, b, h, n, d, packed, causal, alibi, seed=n + d + 1)
    slopes = kw["slopes"][:h].clone() if alibi else None
    flat = [t.reshape(b * h, n, d).contiguous() for t in (*views, _heads.heads_of(dout, h))]
    fwd, bwd = ((A.attention_fwd, A.attention_bwd) if kind == "vit"
                else (F.flash_fwd_cuda, F.flash_bwd_cuda))
    oc, lsec = fwd(*flat[:3], **kw)
    gc = bwd(*flat[:3], oc, lsec, flat[3], **kw)
    before = {**A.LAUNCHES, **F.LAUNCHES}
    if packed:
        x = qkv.clone().requires_grad_(True)
        out = (A.vit_attention_qkv(x, h) if kind == "vit"
               else F.flash_attention_qkv(x, h, causal=causal, alibi_slopes=slopes))
        out.backward(dout)
        got = _heads.qkv_views(x.grad, h)
    else:
        xs = [t.detach().clone().requires_grad_(True) for t in views]
        out = F.flash_attention(*xs, causal=causal, alibi_slopes=slopes).transpose(1, 2).reshape(b, n, h * d)
        out.backward(dout)
        got = [t.grad for t in xs]
    torch.cuda.synchronize()
    after = {**A.LAUNCHES, **F.LAUNCHES}
    assert after["vit_attention_copied"] == before["vit_attention_copied"]
    assert after["flash_attention_copied"] == before["flash_attention_copied"]
    assert torch.equal(out.reshape(b, n, h, d).transpose(1, 2).reshape(oc.shape), oc)
    for name, a, c in zip(("dq", "dk", "dv"), got, gc):
        assert torch.equal(a.reshape(c.shape), c), name


@pytest.mark.cuda
def test_cuda_float32_views_are_copied_and_counted():
    """float32 keeps the contiguous copies: the packed form still runs, and
    counts its launches as copied."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    x = torch.randn(2, 57, 3 * 4 * 64, device="cuda", requires_grad=True)
    before = A.LAUNCHES["vit_attention_copied"]
    out = A.vit_attention_qkv(x, 4)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    assert A.LAUNCHES["vit_attention_copied"] == before + 2
    ref = _split_then_attend(x.detach().cpu(), 4, *_vit_plain())
    assert float((out.detach().cpu() - ref).abs().max()) <= 1e-5 * math.sqrt(64)
