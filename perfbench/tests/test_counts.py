"""The FLOP and byte counts against sums worked by hand at two shapes."""

import pytest

from harness import registry

CLIP = registry.counts("clip-vit-l-14")
OF = registry.counts("openflamingo-9b")


def _clip(width, layers, patch, size, embed):
    return {"embed_dim": embed, "vision_cfg": {"image_size": size, "layers": layers, "width": width,
                                               "patch_size": patch}}


@pytest.mark.parametrize("width,layers,patch,size,embed", [(1024, 24, 14, 224, 768), (64, 2, 8, 32, 16)])
def test_vit_forward_by_hand(width, layers, patch, size, embed):
    n = (size // patch) ** 2 + 1
    per_layer = (2 * n * width * 3 * width + 2 * n * width * width + 2 * n * width * 4 * width
                 + 2 * n * 4 * width * width + 2 * n * n * width + 2 * n * n * width)
    total = 2 * (n - 1) * (3 * patch * patch) * width + layers * per_layer + 2 * width * embed
    cfg = _clip(width, layers, patch, size, embed)
    assert CLIP.forward_flops(cfg) == pytest.approx(total, rel=1e-12)
    # the pixel gradient: the products' input gradients and attention's 8 n^2 d
    assert CLIP.pixel_backward_flops(cfg) - CLIP.forward_flops(cfg) == pytest.approx(
        layers * 4 * n * n * width, rel=1e-12)


def test_vitl14_magnitudes():
    cfg = registry.config("clip-vit-l-14")
    # about 0.16 TFLOP an image forward (2 x 0.30 G parameters x 257 tokens, plus attention)
    assert 0.15e12 < CLIP.forward_flops(cfg) < 0.18e12
    it = CLIP.apgd_iteration_flops(cfg, 128, 1000)
    assert it == pytest.approx(128 * (CLIP.forward_flops(cfg) + CLIP.pixel_backward_flops(cfg)
                                      + 4 * 768 * 1000), rel=1e-12)
    step = CLIP.fare_step_flops(cfg, 128, 10)
    f, b, wb = CLIP.forward_flops(cfg), CLIP.pixel_backward_flops(cfg), CLIP.weight_backward_flops(cfg)
    assert step == pytest.approx(128 * (f + 11 * f + 10 * b + 2 * f + b + wb), rel=1e-12)


@pytest.mark.parametrize("batch,n,d,itm", [(128, 257, 64, 2), (8, 50, 64, 4)])
def test_vit_attention_launch_by_hand(batch, n, d, itm):
    cfg = _clip(16 * d, 1, 14, 14 * int((n - 1) ** 0.5), 8)
    got = CLIP.vit_attention_launch_counts(cfg, batch, "bfloat16" if itm == 2 else "float32")
    bh = batch * 16
    assert got["fwd"] == (4 * bh * n * n * d, 4 * bh * n * d * itm + 4 * bh * n)
    assert got["bwd"] == (10 * bh * n * n * d, 8 * bh * n * d * itm + 4 * bh * n)


@pytest.mark.parametrize("batch,t", [(16, 34), (1, 5)])
def test_flash_alibi_launch_by_hand(batch, t):
    cfg = registry.config("openflamingo-9b")
    got = OF.flash_alibi_launch_counts(cfg, batch, t, "bfloat16")
    bh, d = batch * 32, 128
    pairs = bh * t * (t + 1) / 2
    assert got["fwd"] == (4 * pairs * d, 4 * bh * t * d * 2 + 4 * bh * t)
    assert got["bwd"] == (10 * pairs * d, 8 * bh * t * d * 2 + 4 * bh * t)


def test_openflamingo_forward_by_hand():
    cfg = registry.config("openflamingo-9b")
    t = 34
    d, v = 4096, 50432
    mpt = 32 * (2 * t * d * 3 * d + 2 * t * d * d + 4 * t * d * 4 * d + 4 * (t * (t + 1) / 2) * d) + 2 * t * d * v
    xat = 8 * (2 * t * d * 512 + 2 * 64 * 1024 * 1024 + 2 * t * 512 * d + 4 * t * d * 4 * d + 4 * t * 64 * 512)
    per = 6 * (2 * 64 * 1024 * 512 + 2 * 320 * 1024 * 1024 + 2 * 64 * 512 * 1024 + 4 * 64 * 1024 * 4096
               + 4 * 64 * 320 * 512)
    vit = CLIP.forward_flops(dict(cfg["vision"], embed_dim=0))
    assert OF.forward_flops(cfg, t) == pytest.approx(vit + per + xat + mpt, rel=1e-12)
    # about 2 x 8.1 G parameters x 34 tokens for the LM, plus the tower
    assert 0.5e12 < OF.forward_flops(cfg, t) < 1.0e12
