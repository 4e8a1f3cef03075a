"""The arithmetic of the per-layer metrics, shared by their readers in
`metrics/`. Each takes the reader's context (the reduced trace, the traced
stretch's model calls or steps and FLOPs, the attention shapes, the
program's spans) and returns a number, or None where the context holds
nothing to read. A share of a peak or a roofline is never made up: no
trace, no number.

Peaks: NVIDIA H100 SXM, dense bf16 989 TFLOP/s, HBM3 3.35 TB/s (the data
sheet, at the 700 W limit; `chip_smoke.py`'s table).
"""

from __future__ import annotations

from typing import Optional

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# the port's attention kernels by name: bf16 forward, dQ and dK/dV kernels
# (csrc/attn_bf16_fwd.cuh, attn_bf16_bwd.cuh); the ViT instances carry the
# VitBf16* shapes of vit_attention.cu, the flash ones the Bf16* shapes of
# flash_attention.cu
FWD, DQ, DKV = "attn_fwd_wgmma_kernel", "attn_bwd_dq_wgmma_kernel", "attn_bwd_dkv_wgmma_kernel"


def _trace(ctx):
    return ctx.get("trace")


def idle_pct(ctx) -> Optional[float]:
    t = _trace(ctx)
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]


def launches_per(ctx, key: str) -> Optional[float]:
    t, n = _trace(ctx), ctx.get(key)
    if not t or not n:
        return None
    return t["kernels"] / n


def mfu(ctx) -> Optional[float]:
    t, flops = _trace(ctx), ctx.get("traced_flops")
    if not t or not flops:
        return None
    return 100.0 * flops / (t["window_s"] * PEAK_BF16_FLOPS)


def elementwise_pct(ctx) -> Optional[float]:
    t = _trace(ctx)
    if not t:
        return None
    total = sum(t["groups"].values())
    return 100.0 * t["groups"].get("other", 0.0) / total if total > 0 else None


def is_vit(name: str) -> bool:
    return "VitBf16" in name


def is_flash(name: str) -> bool:
    return "wgmma_kernel" in name and "VitBf16" not in name and "Bf16" in name


def roofline(ctx, which: str, match) -> Optional[float]:
    """The kernel's bound over its summed device time, in %: the bound of a
    launch is the larger of its operations over the bf16 peak and its
    bytes over the memory rate; a backward launch is its dQ and dK/dV
    kernels together."""
    t, counts = _trace(ctx), (ctx.get("attention") or {}).get(which)
    if not t or not counts:
        return None
    n_fwd = n_bwd = 0
    spent = 0.0
    for name, s, e in t["ops"]:
        if not match(name):
            continue
        if FWD in name:
            n_fwd += 1
        elif DQ in name:
            n_bwd += 1
        elif DKV not in name:
            continue
        spent += (e - s) * 1e-6
    if spent <= 0:
        return None

    def bound(ops_bytes):
        ops, nbytes = ops_bytes
        return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)

    return 100.0 * (n_fwd * bound(counts["fwd"]) + n_bwd * bound(counts["bwd"])) / spent


def span_share(ctx, part: str, whole: str) -> Optional[float]:
    spans = ctx.get("spans") or {}
    if not spans.get(whole):
        return None
    return 100.0 * spans.get(part, 0.0) / spans[whole]
