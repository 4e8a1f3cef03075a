"""OPT decoder (the BLIP-2 language model) as PyTorch modules.

Counterpart of `robustvlm_tpu/models/opt/model.py`: HF `OPTForCausalLM`'s
pre-LN layout (`do_layer_norm_before`), learned positional embeddings with
OPT's offset of 2, causal multi-head attention with a float32 softmax, a
ReLU MLP, biases everywhere, and the LM head tied to the token embedding in
every release (held as its own (W, V) leaf, as the JAX tree holds it).
Parameter names and layouts are the JAX tree's (linear weights (in, out)
for `x @ w`), so a JAX tree carries across by name (`convert.py`).

- Causal attention without a key mask (the teacher-forced forward the
  attacks differentiate) goes through the port's `flash_attention` on a
  CUDA tensor (its kernels at head dim 80 for OPT-2.7B), handed the heads
  as views of the q, k and v projections; it returns them token-major, so
  merging them back is free. The paths with a
  cache or a key mask (prefill with left padding, decode), and every CPU
  tensor, stay plain PyTorch, as in JAX (no Pallas kernel there): scores
  in the compute dtype, then float32, an explicit query-position mask and
  a valid-key mask filled with -1e30, P cast back to the compute dtype
  before P V.
- LayerNorm and the MLP's bias + ReLU are `ops/kernels/block_ops.py`'s on
  a CUDA tensor (one kernel each way); a CPU tensor keeps the arithmetic
  below, op for op.
- Layers are an `nn.ModuleList` walked by a Python loop (JAX scans stacked
  blocks); `remat` recomputes each block in the backward
  (`torch.utils.checkpoint`). The KV cache is one (L, B, H, N, hd) buffer
  per k and v, written in place; the cached path takes no `remat`.
- A block split over the mesh's `model` axis (`parallel/mesh.shard_params`
  sets its `tp`) holds this rank's heads of q, k and v and its ffn columns
  (with its slice of fc1's bias, b1), adds its slice of the replicated q, k
  and v biases, and adds the out and fc2 biases once, after the sum over
  `model` (`parallel/tensor_parallel.py`). A split LM head holds this rank's
  vocabulary columns; its logits are gathered before any argmax or
  cross-entropy. A cache holds the rank's heads (`local_heads`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from robustvlm_tpu_torch.models.llama.model import _cache_write
from robustvlm_tpu_torch.ops.kernels import block_ops
from robustvlm_tpu_torch.ops.kernels.flash_attention import flash_attention
from robustvlm_tpu_torch.parallel.tensor_parallel import (
    column_parallel,
    gather_from_model,
    local,
    row_parallel,
    split_to_model,
)

POS_OFFSET = 2  # OPT embeds position i at row i + 2 (HF modeling_opt.py)


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    name: str
    dim: int
    n_layers: int
    n_heads: int
    ffn_dim: int
    vocab_size: int = 50272
    max_seq_len: int = 2048
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


OPT_CONFIGS: Dict[str, OPTConfig] = {
    "opt-125m": OPTConfig("opt-125m", 768, 12, 12, 3072),
    "opt-2.7b": OPTConfig("opt-2.7b", 2560, 32, 32, 10240),
    "opt-6.7b": OPTConfig("opt-6.7b", 4096, 32, 32, 16384),
    "test-tiny": OPTConfig("test-tiny", 64, 2, 4, 128, vocab_size=128, max_seq_len=64),
}


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with float32 statistics, cast back to x's dtype: the
    `block_ops` kernels for a CUDA tensor, this arithmetic for a CPU one."""
    if x.is_cuda:
        return block_ops.layer_norm(x, g, b, eps)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g.float() + b.float()).to(x.dtype)


def _attn(q, k, v, *, q_positions=None, kv_mask=None) -> torch.Tensor:
    """Causal attention, q (B, H, Tq, hd), k/v (B, H, Tk, hd): key j is
    visible from query position p when j <= p (q_positions (Tq,), default
    the last Tq slots) and kv_mask (B, Tk) marks it valid."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    tq, tk = q.shape[2], k.shape[2]
    qpos = torch.arange(tq, device=q.device) + (tk - tq) if q_positions is None else q_positions
    jj = torch.arange(tk, device=q.device)
    mask = (jj[None, :] <= qpos[:, None])[None]  # (1, Tq, Tk)
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, :]
    s = torch.where(mask[:, None], s, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def _causal(q, k, v, kv_mask=None) -> torch.Tensor:
    """`_attn` without a cache: the `flash_attention` kernels for CUDA
    tensors when no key is masked, else the plain version."""
    if q.is_cuda and kv_mask is None:
        return flash_attention(q, k, v, causal=True)
    return _attn(q, k, v, kv_mask=kv_mask)


def _lin(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h @ w + b with the weights cast to h's dtype."""
    return h @ w.to(h.dtype) + b.to(h.dtype)


def _col(h: torch.Tensor, w, b, tp, b_split: bool = False) -> torch.Tensor:
    """`_lin`, in a split module (`tp`) on this rank's columns of w: b is
    split with them (`b_split`) or replicated and sliced here."""
    if not tp:
        return _lin(h, w, b)
    b = local(b) if b_split else split_to_model(b, tp)
    return column_parallel(h, local(w).to(h.dtype), tp) + b.to(h.dtype)


def _col_act(h: torch.Tensor, w, b, tp, act: str) -> torch.Tensor:
    """`act(_col(h, w, b, tp, b_split=True))`, the bias add and the
    activation in one `block_ops.bias_act` (the same arithmetic on the CPU)."""
    y = column_parallel(h, local(w).to(h.dtype), tp) if tp else h @ w.to(h.dtype)
    return block_ops.bias_act(y, local(b), act)


def _row(h: torch.Tensor, w, b, tp) -> torch.Tensor:
    """`_lin`, in a split module summed over `model`, b added once after."""
    if not tp:
        return _lin(h, w, b)
    return row_parallel(h, local(w).to(h.dtype), tp) + b.to(h.dtype)


class LayerNorm(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(width))
        self.b = nn.Parameter(torch.zeros(width))


class Attention(nn.Module):
    def __init__(self, w: int):
        super().__init__()
        for n in "qkvo":
            setattr(self, f"w{n}", nn.Parameter(torch.zeros(w, w)))
            setattr(self, f"b{n}", nn.Parameter(torch.zeros(w)))


class MLP(nn.Module):
    def __init__(self, w: int, f: int):
        super().__init__()
        self.fc1 = nn.Parameter(torch.zeros(w, f))
        self.b1 = nn.Parameter(torch.zeros(f))
        self.fc2 = nn.Parameter(torch.zeros(f, w))
        self.b2 = nn.Parameter(torch.zeros(w))


class Block(nn.Module):
    tp = None  # parallel.tensor_parallel.TensorParallel when split over `model`

    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.cfg = cfg
        self.ln1 = LayerNorm(cfg.dim)
        self.attn = Attention(cfg.dim)
        self.ln2 = LayerNorm(cfg.dim)
        self.mlp = MLP(cfg.dim, cfg.ffn_dim)

    def tp_layout(self, m: int):
        """{parameter: (split dim, blocks)} over a `model` axis of m, or None
        (the block stays whole) when m does not divide the heads or the ffn
        width. The q, k and v biases are replicated (sliced at use), as the
        JAX package gives them no rule; b1 splits with fc1's columns."""
        if self.cfg.n_heads % m or self.cfg.ffn_dim % m:
            return None
        return {"attn.wq": (1, 1), "attn.wk": (1, 1), "attn.wv": (1, 1), "attn.wo": (0, 1),
                "mlp.fc1": (1, 1), "mlp.b1": (0, 1), "mlp.fc2": (0, 1)}

    def forward(self, x, kv_mask=None, cache=None, pos=None):
        """One decoder layer. cache: (k, v) buffers (B, H, N, hd) written in
        place at token offset `pos`; kv_mask (B, Tk) marks valid keys."""
        cfg, tp = self.cfg, self.tp
        b, t, _ = x.shape
        cd = x.dtype
        a, m = self.attn, self.mlp
        n_heads = cfg.n_heads // tp.size if tp else cfg.n_heads

        def heads(y):
            return y.reshape(b, t, n_heads, cfg.head_dim).transpose(1, 2)

        h = layer_norm(x, self.ln1.g, self.ln1.b, cfg.norm_eps)
        q, k, v = (heads(_col(h, getattr(a, f"w{n}"), getattr(a, f"b{n}"), tp)) for n in "qkv")
        if cache is not None:
            ck = _cache_write(cache[0], k.to(cache[0].dtype), pos)
            cv = _cache_write(cache[1], v.to(cache[1].dtype), pos)
            att = _attn(q, ck.to(cd), cv.to(cd), q_positions=int(pos) + torch.arange(t, device=x.device),
                        kv_mask=kv_mask)
        else:
            att = _causal(q, k, v, kv_mask)
        att = att.transpose(1, 2).reshape(b, t, n_heads * cfg.head_dim)
        x = x + _row(att, a.wo, a.bo, tp)
        h = layer_norm(x, self.ln2.g, self.ln2.b, cfg.norm_eps)
        h = _col_act(h, m.fc1, m.b1, tp, "relu")
        return x + _row(h, m.fc2, m.b2, tp)


class OPT(nn.Module):
    """Token and position embeddings, decoder blocks, the final norm and the
    LM head. Parameters are created frozen; load a state dict (`convert.py`)
    with `from_state`."""

    tp = None  # set when the LM head is split over `model`

    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.dim))
        self.pos_embedding = nn.Parameter(torch.zeros(cfg.max_seq_len + POS_OFFSET, cfg.dim))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.final_norm = LayerNorm(cfg.dim)
        self.lm_head = nn.Parameter(torch.zeros(cfg.dim, cfg.vocab_size))
        self.requires_grad_(False)

    @classmethod
    def from_state(cls, cfg: OPTConfig, state: Dict[str, torch.Tensor]) -> "OPT":
        """A model that holds `state`'s tensors themselves (no copy)."""
        with torch.device("meta"):
            model = cls(cfg)
        model.load_state_dict(state, assign=True, strict=True)
        return model.requires_grad_(False)

    def tp_layout(self, m: int):
        """The LM head's vocabulary columns over a `model` axis of m, unless m
        does not divide the vocabulary."""
        return None if self.cfg.vocab_size % m else {"lm_head": (1, 1)}


def local_heads(model: OPT) -> int:
    """The heads a rank's blocks hold (all of them on a whole model): the
    head count of its KV cache."""
    tp = model.blocks[0].tp if len(model.blocks) else None
    return model.cfg.n_heads // tp.size if tp else model.cfg.n_heads


def _lm_head(model: OPT, h: torch.Tensor) -> torch.Tensor:
    """Float32 logits over the whole vocabulary (a split head's gathered)."""
    tp = model.tp
    if tp is None:
        return (h @ model.lm_head.to(h.dtype)).float()
    return gather_from_model(column_parallel(h, local(model.lm_head).to(h.dtype), tp).float(), tp)


def opt_forward(
    model: OPT,
    tokens: Optional[torch.Tensor] = None,
    *,
    inputs_embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    compute_dtype=torch.bfloat16,
    remat: bool = False,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos=None,
    kv_mask: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
):
    """Causal LM forward -> float32 logits (B, T, V). `inputs_embeds` is the
    BLIP-2 splice entry (query outputs before the token embeddings);
    `positions` (T,) or (B, T) index the learned position table (default
    cache_pos + 0..T-1). With `cache` + `cache_pos`, the decode path: returns
    (logits, cache), the cache updated in place."""
    cfg = model.cfg
    if inputs_embeds is None:
        inputs_embeds = model.tok_embedding[tokens]
    x = inputs_embeds.to(compute_dtype)
    b, t, _ = x.shape
    if positions is None:
        start = int(cache_pos) if cache_pos is not None else 0
        positions = start + torch.arange(t, device=x.device)
    # a position past the table reads its last row, as JAX's clamped gather
    # does (test-tiny's 64 positions hold fewer than its 4 queries + 64 tokens)
    rows = (positions + POS_OFFSET).clamp(max=model.pos_embedding.shape[0] - 1)
    x = x + model.pos_embedding[rows].to(compute_dtype)
    fn = model.final_norm

    if cache is not None:
        cache_len = cache["k"].shape[3]
        if kv_mask is not None and kv_mask.shape[1] < cache_len:
            pad = torch.zeros(b, cache_len - kv_mask.shape[1], dtype=torch.bool, device=x.device)
            kv_mask = torch.cat([kv_mask, pad], dim=1)
        for i, blk in enumerate(model.blocks):
            x = blk(x, kv_mask, cache=(cache["k"][i], cache["v"][i]), pos=cache_pos)
        h = layer_norm(x, fn.g, fn.b, cfg.norm_eps)
        return _lm_head(model, h), cache

    for blk in model.blocks:
        if remat and torch.is_grad_enabled():
            x = checkpoint(blk, x, kv_mask, use_reentrant=False)
        else:
            x = blk(x, kv_mask)
    x = layer_norm(x, fn.g, fn.b, cfg.norm_eps)
    if return_hidden:
        return x
    return _lm_head(model, x)


def init_opt_cache(cfg: OPTConfig, batch: int, max_len: Optional[int] = None,
                   dtype=torch.bfloat16, device=None, n_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Stacked per-layer KV buffers (L, B, H, N, hd). `n_heads` is the heads
    a rank holds (`local_heads`: a split model's H / m), all by default."""
    n = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, n_heads or cfg.n_heads, n, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
