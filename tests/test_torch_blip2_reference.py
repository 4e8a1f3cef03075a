"""BLIP-2 in the port against the benchmark's plain reference
(`perfbench/reference/blip2.py`, plain float32 PyTorch written from HF's
`Blip2ForConditionalGeneration`, which imports nothing of the port), at
`test-tiny` on the CPU from seeded random weights: the logits, the
per-example caption loss and its pixel gradient. And the CPU routes of
the EVA and OPT blocks, which send a CUDA tensor to the port's kernels,
against the arithmetic they ran before the kernels (frozen copies below),
bit for bit, forward and backward."""

import importlib.util
import math
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from robustvlm_tpu_torch.models.blip2 import Blip2, blip2_forward, blip2_per_sample_loss, init_random_state
from robustvlm_tpu_torch.models.blip2.model import BLIP2_CONFIGS

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "perfbench"


def _reference():
    if str(BENCH) not in sys.path:  # the reference imports its package's `reference.common`
        sys.path.insert(0, str(BENCH))
    spec = importlib.util.spec_from_file_location("blip2_plain_reference", BENCH / "reference" / "blip2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R = _reference()
CFG = BLIP2_CONFIGS["test-tiny"]


def _hf_config(cfg) -> dict:
    """The port's config in the HF keys the reference reads."""
    v, q, o = cfg.vision, cfg.qformer, cfg.opt
    return {"vision_config": {"hidden_size": v.width, "num_hidden_layers": v.layers, "num_attention_heads": v.heads,
                              "intermediate_size": v.intermediate, "image_size": v.image_size,
                              "patch_size": v.patch_size, "layer_norm_eps": v.norm_eps},
            "qformer_config": {"hidden_size": q.width, "num_hidden_layers": q.layers, "num_attention_heads": q.heads,
                               "intermediate_size": q.intermediate, "cross_attention_frequency": q.xattn_every,
                               "encoder_hidden_size": v.width, "layer_norm_eps": q.norm_eps},
            "num_query_tokens": cfg.num_query_tokens,
            "text_config": {"hidden_size": o.dim, "num_hidden_layers": o.n_layers, "num_attention_heads": o.n_heads,
                            "ffn_dim": o.ffn_dim, "vocab_size": o.vocab_size,
                            "max_position_embeddings": o.max_seq_len, "layer_norm_eps": o.norm_eps}}


@pytest.fixture(scope="module")
def tiny():
    """Weights whose biases, gains and class embedding are drawn too (the
    random init leaves biases 0 and gains 1), so every term is compared."""
    state = init_random_state(CFG, 11)
    gen = torch.Generator().manual_seed(12)
    for k, v in state.items():
        if v.dim() == 1:
            state[k] = v + 0.05 * torch.randn(v.shape, generator=gen)
    state["opt.lm_head"] = state["opt.tok_embedding"].T.contiguous()
    return state, Blip2.from_state(CFG, state)


def _inputs(seed=13, b=3, t=12):
    gen = torch.Generator().manual_seed(seed)
    size = CFG.vision.image_size
    x = torch.rand(b, 3, size, size, generator=gen)
    ids = torch.randint(3, CFG.opt.vocab_size, (b, t), generator=gen)
    mask = torch.zeros(b, t)
    for i, start in enumerate((2, 4, 5)[:b]):
        mask[i, start:t - i] = 1.0
    return x, ids, mask


def test_logits_match_the_reference(tiny):
    state, model = tiny
    x, ids, _ = _inputs()
    got = blip2_forward(model, x, ids, compute_dtype=torch.float32)
    ref = R.forward(state, _hf_config(CFG), x, ids)
    assert got.shape == ref.shape == (3, CFG.num_query_tokens + ids.shape[1], CFG.opt.vocab_size)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


def test_loss_and_pixel_gradient_match_the_reference(tiny):
    state, model = tiny
    x, ids, mask = _inputs()
    xp, xr = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got = blip2_per_sample_loss(model, xp, ids, ids, mask, compute_dtype=torch.float32)
    ref = R.per_example_loss(state, _hf_config(CFG), xr, ids, mask)
    assert float(((got - ref).abs() / ref.abs()).max().detach()) <= 1e-5
    (gp,) = torch.autograd.grad(got.sum(), xp)
    (gr,) = torch.autograd.grad(ref.sum(), xr)
    rel = (gp - gr).flatten(1).norm(dim=1) / gr.flatten(1).norm(dim=1)
    assert float(gr.abs().max()) > 0 and float(rel.max()) <= 1e-4, rel


def test_caption_tokens_match_the_adapter():
    """The reference's hash tokens and teacher-forced mask are the BLIP-2
    adapter's for the eval's caption prompt."""
    from robustvlm_tpu_torch.vlm_eval.eval_models import Blip2EvalModel, WordTokenizer

    model = Blip2.from_state(CFG, init_random_state(CFG, 0))
    adapter = Blip2EvalModel(model, WordTokenizer(), compute_dtype=torch.float32)
    prompt = "A photo of two dogs on grassA photo of a red busA photo of a man riding a horse"
    adapter.set_inputs([prompt])
    ids, mask = R.teacher_forced(prompt)
    tokens, labels, amask = adapter.bound_args[1:]
    assert tokens[0].tolist() == ids == labels[0].tolist()
    assert amask[0].tolist() == mask
    assert R.served_ids(adapter.tok.decode([5, 77, 300])) == [5, 77, 300]


# ------------------------------------------------ the blocks' CPU routes
def _old_layer_norm(x, g, b, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g.float() + b.float()).to(x.dtype)


def _old_mha(q, k, v, heads):
    b, tq, w = q.shape
    tk, hd = k.shape[1], w // heads
    q, k, v = (t.reshape(b, -1, heads, hd).transpose(1, 2) for t in (q, k, v))
    s = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v).transpose(1, 2).reshape(b, tq, w)


def _old_causal(q, k, v):
    s = torch.matmul(q, k.transpose(-1, -2)).float() * (1.0 / math.sqrt(q.shape[-1]))
    tq, tk = q.shape[2], k.shape[2]
    mask = (torch.arange(tk)[None, :] <= (torch.arange(tq) + (tk - tq))[:, None])[None]
    s = torch.where(mask[:, None], s, -1e30)
    return torch.matmul(torch.softmax(s, dim=-1).to(q.dtype), v)


def _lin(h, w, b):
    return h @ w.to(h.dtype) + b.to(h.dtype)


def _old_vision_block(blk, h):
    vc, a, m = blk.vc, blk.attn, blk.mlp
    x = _old_layer_norm(h, blk.ln_1.g, blk.ln_1.b, vc.norm_eps)
    q, k, v = _lin(x, a.qkv_w, a.qkv_b).chunk(3, dim=-1)
    h = h + _lin(_old_mha(q, k, v, vc.heads), a.out_w, a.out_b)
    x = _old_layer_norm(h, blk.ln_2.g, blk.ln_2.b, vc.norm_eps)
    return h + _lin(F.gelu(_lin(x, m.fc_w, m.fc_b)), m.proj_w, m.proj_b)


def _old_opt_block(blk, x):
    cfg, a, m = blk.cfg, blk.attn, blk.mlp
    b, t, _ = x.shape

    def heads(y):
        return y.reshape(b, t, cfg.n_heads, cfg.head_dim).transpose(1, 2)

    h = _old_layer_norm(x, blk.ln1.g, blk.ln1.b, cfg.norm_eps)
    q, k, v = (heads(_lin(h, getattr(a, f"w{n}"), getattr(a, f"b{n}"))) for n in "qkv")
    att = _old_causal(q, k, v).transpose(1, 2).reshape(b, t, cfg.dim)
    x = x + _lin(att, a.wo, a.bo)
    h = _old_layer_norm(x, blk.ln2.g, blk.ln2.b, cfg.norm_eps)
    return x + _lin(F.relu(_lin(h, m.fc1, m.b1)), m.fc2, m.b2)


def _bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32),
                                              b.view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("which", ["eva", "opt"])
def test_block_cpu_route_bitwise_equals_old(tiny, which, dtype):
    _, model = tiny
    blk = model.visual.blocks[1] if which == "eva" else model.opt.blocks[1]
    old = _old_vision_block if which == "eva" else _old_opt_block
    width = CFG.vision.width if which == "eva" else CFG.opt.dim
    gen = torch.Generator().manual_seed(14)
    x = torch.randn(2, 9, width, generator=gen).to(dtype)
    dy = torch.randn(2, 9, width, generator=gen).to(dtype)
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    new, ref = blk(xs[0]), old(blk, xs[1])
    assert _bits_equal(new, ref)
    (gn,), (go,) = torch.autograd.grad(new, xs[0], dy), torch.autograd.grad(ref, xs[1], dy)
    assert _bits_equal(gn, go)


def test_forward_names_its_stages(tiny):
    """Under a profiler window the loss's forward records `blip2.vision`
    and `blip2.qformer` (the image features) and `blip2.lm`, in that order,
    under the caller's span; without a window it records nothing."""
    from torch.profiler import ProfilerActivity, profile

    from robustvlm_tpu_torch.utils import profiling

    _, model = tiny
    x, ids, mask = _inputs()
    profiling.reset()
    blip2_per_sample_loss(model, x, ids, ids, mask, compute_dtype=torch.float32)
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("apgd.forward"):
            blip2_per_sample_loss(model, x, ids, ids, mask, compute_dtype=torch.float32)
    log = profiling.spans()
    profiling.reset()
    outer = next(s for s in log if s["name"] == "apgd.forward")
    stages = [s for s in log if s["parent"] == outer["id"]]
    assert [s["name"] for s in stages] == ["blip2.vision", "blip2.qformer", "blip2.lm"]
    assert all(s["complete"] for s in stages)
