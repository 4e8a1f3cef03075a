"""The trace's reduction and the per-layer arithmetic on a made-up trace."""

from types import SimpleNamespace as NS

import pytest

from harness import readers
from harness.trace import breakdown, reduce_events

VIT_FWD = "void attn_fwd_wgmma_kernel<64, (anonymous namespace)::VitBf16Fwd<64> >(CUtensorMap)"
VIT_DQ = "void attn_bwd_dq_wgmma_kernel<64, (anonymous namespace)::VitBf16Bwd<64> >(CUtensorMap)"
VIT_DKV = "void attn_bwd_dkv_wgmma_kernel<64, (anonymous namespace)::VitBf16Bwd<64> >(CUtensorMap)"
FLASH = "void attn_fwd_wgmma_kernel<128, (anonymous namespace)::Bf16Fwd<128> >(CUtensorMap)"


def ev(name, start, end, kind="DeviceType.CUDA"):
    return NS(name=name, device_type=kind, time_range=NS(start=start, end=end))


EVENTS = [
    ev("nvjet_tst_256x128_gemm", 0, 100), ev(VIT_FWD, 100, 150), ev("elementwise_kernel", 200, 260),
    ev(VIT_DQ, 260, 300), ev(VIT_DKV, 290, 330), ev("Memcpy HtoD", 400, 410), ev(FLASH, 500, 510),
    ev("aten::mm", 150, 205, "DeviceType.CPU"), ev("aten::add", 330, 405, "DeviceType.CPU"),
    ev("cudaLaunchKernel", 160, 170, "DeviceType.CPU"),
]


def test_busy_gaps_and_groups():
    s = reduce_events(EVENTS, window_s=600e-6)
    # busy: 0-150, 200-330, 400-410, 500-510 (the dQ and dK/dV overlap merged)
    assert s["busy_s"] == pytest.approx(300e-6)
    assert s["kernels"] == 6
    assert s["groups"]["matmul"] == pytest.approx(100e-6)
    assert s["groups"]["port_kernels"] == pytest.approx((50 + 40 + 40 + 10) * 1e-6)
    assert s["groups"]["other"] == pytest.approx(60e-6)
    # the longest gaps first, named by the innermost host event running at their start
    assert [(n, round(d * 1e6)) for n, d in s["gaps"]] == [("python", 90), ("aten::add", 70), ("aten::mm", 50)]
    b = breakdown(s)
    assert b["device_ops"][0][0] == "nvjet_tst_256x128_gemm" and len(b["idle_gaps"]) == 3


def test_no_cuda_operation_fails():
    with pytest.raises(RuntimeError):
        reduce_events([e for e in EVENTS if "CPU" in e.device_type], 1.0)


def test_layer_arithmetic():
    s = reduce_events(EVENTS, window_s=600e-6)
    counts = {"fwd": (989e12 * 25e-6, 0), "bwd": (0, 3.35e12 * 40e-6)}
    ctx = {"trace": s, "traced_calls": 2, "traced_flops": 989e12 * 60e-6, "attention": {"vit": counts},
           "spans": {"attack_s": 3.0, "wall_s": 4.0}}
    assert readers.idle_pct(ctx) == pytest.approx(50.0)
    assert readers.launches_per(ctx, "traced_calls") == 3
    assert readers.mfu(ctx) == pytest.approx(10.0)
    assert readers.elementwise_pct(ctx) == pytest.approx(100 * 60 / 310)
    # one forward (bound 25 us) and one backward (40 us) over 130 us of the ViT kernels
    assert readers.roofline(ctx, "vit", readers.is_vit) == pytest.approx(100 * 65 / 130)
    assert readers.roofline(ctx, "flash_alibi", readers.is_flash) is None  # no counts given
    assert readers.span_share(ctx, "attack_s", "wall_s") == pytest.approx(75.0)
    assert readers.idle_pct({"trace": None}) is None
