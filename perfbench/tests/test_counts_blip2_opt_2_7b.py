"""BLIP-2 OPT-2.7B's FLOP and byte counts against sums worked by hand at
two shapes: the published widths and the small sizes."""

import pytest

import tiny
from harness import registry

B2 = registry.counts("blip2-opt-2.7b")


def _by_hand(v_w, v_l, v_f, v_p, v_s, q_w, q_l, q_f, nq, d, lm_l, ffn, vocab, t):
    n = (v_s // v_p) ** 2 + 1
    eva = 2 * (n - 1) * 3 * v_p * v_p * v_w + v_l * (8 * n * v_w * v_w + 4 * n * v_w * v_f)
    eva_att = v_l * 4 * n * n * v_w
    crosses = (q_l + 1) // 2  # layers 0, 2, ...
    qf = q_l * (8 * nq * q_w * q_w + 4 * nq * q_w * q_f) + crosses * (4 * nq * q_w * q_w + 4 * n * v_w * q_w)
    qf_att = q_l * 4 * nq * nq * q_w + crosses * 4 * nq * n * q_w
    m = nq + t
    lm = lm_l * (8 * m * d * d + 4 * m * d * ffn) + 2 * m * d * vocab + 2 * nq * q_w * d
    lm_att = lm_l * 4 * (m * (m + 1) / 2) * d
    return eva + qf + lm, eva_att + qf_att + lm_att


@pytest.mark.parametrize("small", [False, True], ids=["published", "small"])
def test_blip2_forward_and_backward_by_hand(small):
    cfg = tiny.small_config("blip2-opt-2.7b") if small else registry.config("blip2-opt-2.7b")
    v, q, tc = cfg["vision_config"], cfg["qformer_config"], cfg["text_config"]
    t = 64
    prod, att = _by_hand(v["hidden_size"], v["num_hidden_layers"], v["intermediate_size"], v["patch_size"],
                         v["image_size"], q["hidden_size"], q["num_hidden_layers"], q["intermediate_size"],
                         cfg["num_query_tokens"], tc["hidden_size"], tc["num_hidden_layers"], tc["ffn_dim"],
                         tc["vocab_size"], t)
    assert B2.forward_flops(cfg, t) == pytest.approx(prod + att, rel=1e-12)
    assert B2.pixel_backward_flops(cfg, t) == pytest.approx(prod + 2 * att, rel=1e-12)
    assert B2.apgd_iteration_flops(cfg, 64, t) == pytest.approx(64 * (2 * prod + 3 * att), rel=1e-12)


def test_blip2_magnitudes():
    cfg = registry.config("blip2-opt-2.7b")
    # EVA about 0.52 TFLOP an image (2 x 0.98 G parameters x 257 tokens, plus
    # attention), OPT about 0.5 over 96 positions (2 x 2.5 G x 96, plus the
    # head): about 1 TFLOP an image forward
    assert 0.9e12 < B2.forward_flops(cfg, 64) < 1.2e12


@pytest.mark.parametrize("batch,dtype", [(64, "bfloat16"), (2, "float32")])
def test_blip2_attention_launch_by_hand(batch, dtype):
    cfg = registry.config("blip2-opt-2.7b")
    itm = 2 if dtype == "bfloat16" else 4
    bh, n, d = batch * 16, 257, 88
    got = B2.vit_attention_launch_counts(cfg, batch, dtype)
    assert got["fwd"] == (4 * bh * n * n * d, 4 * bh * n * d * itm + 4 * bh * n)
    assert got["bwd"] == (10 * bh * n * n * d, 8 * bh * n * d * itm + 4 * bh * n)
    bh, t, d = batch * 32, 96, 80
    pairs = bh * t * (t + 1) / 2
    got = B2.flash_launch_counts(cfg, batch, t, dtype)
    assert got["fwd"] == (4 * pairs * d, 4 * bh * t * d * itm + 4 * bh * t)
    assert got["bwd"] == (10 * pairs * d, 8 * bh * t * d * itm + 4 * bh * t)
