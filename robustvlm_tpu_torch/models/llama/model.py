"""LLaMA/Vicuna decoder as PyTorch modules.

Counterpart of `robustvlm_tpu/models/llama/model.py`: RMSNorm with float32
statistics, rotary position embeddings (HF half-split), SwiGLU MLP, causal
multi-head attention with optional grouped KV heads, untied LM head, the
`inputs_embeds` entry for the LLaVA splice, and the KV-cache decode path.
Parameter names and layouts are the JAX tree's (linear weights (in, out)
for `x @ w`), so a JAX tree carries across by name (`convert.py`).

- Full-sequence causal attention (no cache, no key mask) goes through the
  port's `flash_attention` (CUDA kernels on the card); the cached decode
  path stays masked plain attention, as in JAX.
- The cache holds the compute dtype, or int8 codes with float32 scales per
  (batch, head, token) (`init_cache(kv_bits=8)`, `_quantize_kv`): the
  scales are applied to the score columns and the softmax probabilities,
  never to the cached elements, in JAX's order of operations.
- Layers are an `nn.ModuleList` walked by a Python loop (JAX scans stacked
  blocks); `remat` wraps each block of the full-sequence path in
  `torch.utils.checkpoint` (JAX: `jax.checkpoint` around the scan body).
  The KV cache is one (L, B, Hkv, N, hd) buffer per k and v (and one (L, B,
  Hkv, N) per scale), written in place; a (B,) vector of offsets writes each
  row of the batch at its own depth (continuous batching) without leaving
  the device.
- Every block matmul and the LM head go through `ops/quant.qmatmul`: a
  plain weight is cast to the compute dtype (a model already held in that
  dtype casts nothing); a quantized leaf (serving) takes its int8 or packed
  int4 path, the latter the `q4_matmul` kernel on decode-shaped CUDA
  operands.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from robustvlm_tpu_torch.ops.kernels.flash_attention import flash_attention
from robustvlm_tpu_torch.ops.quant import qmatmul
from robustvlm_tpu_torch.parallel.tensor_parallel import (
    column_parallel,
    gather_from_model,
    local,
    row_parallel,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    name: str
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    ffn_dim: int
    vocab_size: int
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_seq_len: int = 2048

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


LLAMA_CONFIGS: Dict[str, LlamaConfig] = {
    # Vicuna-7B-v1.5 (the LLaVA-1.5-7B LM) == LLaMA-2-7B geometry
    "llama-7b": LlamaConfig("llama-7b", 4096, 32, 32, 32, 11008, 32000, max_seq_len=4096),
    "test-tiny": LlamaConfig("test-tiny", 64, 2, 4, 4, 128, 512, max_seq_len=128),
    "test-tiny-gqa": LlamaConfig("test-tiny-gqa", 64, 2, 4, 2, 128, 512, max_seq_len=128),
}


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * g.to(x.dtype)


def rope_freqs(cfg: LlamaConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (B?, T, head_dim/2) for integer positions."""
    hd = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                                  device=positions.device) / hd))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, T, hd); cos/sin (T, hd/2) or (B, T, hd/2). HF half-split:
    rotate_half(x) = (-x2, x1) with x1 = x[..., :hd/2]."""
    hd2 = x.shape[-1] // 2
    x1, x2 = x[..., :hd2], x[..., hd2:]
    if cos.dim() == 2:
        cos, sin = cos[None, None], sin[None, None]
    else:
        cos, sin = cos[:, None], sin[:, None]
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    b, h, t, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, t, d).reshape(b, h * n_rep, t, d)


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, head, token) absmax int8 quantization of new K/V rows:
    (B, H, T, hd) -> (int8 codes, float32 scales (B, H, T)). Rounds half to
    even and clips to +-127, so the codes are JAX's on the same input."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def _attn(q, k, v, *, q_positions=None, kv_mask=None, k_scale=None, v_scale=None) -> torch.Tensor:
    """Causal attention: q (B, Hq, Tq, hd), k/v (B, Hkv, Tk, hd). A full
    sequence without key mask takes `flash_attention`; otherwise (cached
    decode: Tq < Tk) key j is visible from query position p when j <= p
    (q_positions (Tq,) or (B, Tq), default the last Tq slots) and kv_mask
    (B, Tk) marks it valid. k_scale/v_scale (B, Hkv, Tk) dequantize an int8
    cache: the codes are cast to q's dtype, k's scale multiplies the float32
    score columns and v's the float32 probabilities before their cast."""
    n_rep = q.shape[1] // k.shape[1]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    if k_scale is not None:
        b_, h_, t_ = k_scale.shape

        def rep3(sc):
            return sc[:, :, None].expand(b_, h_, n_rep, t_).reshape(b_, h_ * n_rep, t_)

        k_scale, v_scale = rep3(k_scale), rep3(v_scale)
        k, v = k.to(q.dtype), v.to(q.dtype)
    tq, tk = q.shape[2], k.shape[2]
    if tq == tk and kv_mask is None and q_positions is None:
        return flash_attention(q, k, v, causal=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * (1.0 / math.sqrt(q.shape[-1]))
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    qpos = torch.arange(tq, device=q.device) + (tk - tq) if q_positions is None else q_positions
    jj = torch.arange(tk, device=q.device)
    if qpos.dim() == 1:
        mask = (jj[None, :] <= qpos[:, None])[None]        # (1, Tq, Tk)
    else:
        mask = jj[None, None, :] <= qpos[:, :, None]       # (B, Tq, Tk)
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, :]
    s = torch.where(mask[:, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


def _cache_write(buf: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Write `new` (B, H, T, ...) into `buf` at token offset `pos`, in place.
    pos: an int or 0-dim tensor (one offset for the batch), or a (B,) tensor
    of per-slot offsets (continuous batching), written by one indexed copy
    on the buffer's device: no offset is read back to the host."""
    t = new.shape[2]
    if not torch.is_tensor(pos) or pos.dim() == 0:
        p = int(pos)
        buf[:, :, p:p + t] = new
        return buf
    pos = pos.to(buf.device)
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]          # (B, 1)
    slots = pos[:, None] + torch.arange(t, device=buf.device)[None, :]     # (B, T)
    buf[rows, :, slots] = new.transpose(1, 2)  # (B, T, H, ...) at [b, :, slot]
    return buf


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        kv = cfg.n_kv_heads * cfg.head_dim
        self.wq = nn.Parameter(torch.zeros(cfg.dim, cfg.dim))
        self.wk = nn.Parameter(torch.zeros(cfg.dim, kv))
        self.wv = nn.Parameter(torch.zeros(cfg.dim, kv))
        self.wo = nn.Parameter(torch.zeros(cfg.dim, cfg.dim))


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.w_gate = nn.Parameter(torch.zeros(cfg.dim, cfg.ffn_dim))
        self.w_up = nn.Parameter(torch.zeros(cfg.dim, cfg.ffn_dim))
        self.w_down = nn.Parameter(torch.zeros(cfg.ffn_dim, cfg.dim))


class Block(nn.Module):
    tp = None  # parallel.tensor_parallel.TensorParallel when split over `model`

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = nn.Parameter(torch.ones(cfg.dim))
        self.ffn_norm = nn.Parameter(torch.ones(cfg.dim))
        self.attn = Attention(cfg)
        self.mlp = MLP(cfg)

    def tp_layout(self, m: int):
        """{parameter: (split dim, blocks)} over a `model` axis of m, or None
        (the block stays whole) when m does not divide the heads, the kv
        heads or the ffn width, or a weight is quantized."""
        cfg, a, f = self.cfg, self.attn, self.mlp
        weights = (a.wq, a.wk, a.wv, a.wo, f.w_gate, f.w_up, f.w_down)
        if (cfg.n_heads % m or cfg.n_kv_heads % m or cfg.ffn_dim % m
                or not all(isinstance(w, nn.Parameter) for w in weights)):
            return None
        names = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.w_gate", "mlp.w_up", "mlp.w_down")
        return {n: (0 if n in ("attn.wo", "mlp.w_down") else 1, 1) for n in names}

    def forward(self, x, cos, sin, *, cache=None, pos=None, kv_mask=None):
        """One decoder layer. cache: (k, v) buffers (B, Hkv, N, hd), or (k, v,
        ks, vs) of an int8 cache with its (B, Hkv, N) scales, written in
        place at `pos` (int, or (B,) per-slot offsets); kv_mask (B, N) marks
        valid key slots."""
        cfg, tp = self.cfg, self.tp
        b, t, _ = x.shape
        cd = x.dtype
        a = self.attn
        n_heads, n_kv = (cfg.n_heads // tp.size, cfg.n_kv_heads // tp.size) if tp else (cfg.n_heads, cfg.n_kv_heads)

        def heads(y, n):
            return y.reshape(b, t, n, cfg.head_dim).transpose(1, 2)

        def col(w):  # a split block's column-parallel product, else qmatmul
            return column_parallel(h, local(w).to(cd), tp) if tp else qmatmul(h, w)

        h = rms_norm(x, self.attn_norm, cfg.norm_eps)
        q = apply_rope(heads(col(a.wq), n_heads), cos, sin)
        k = apply_rope(heads(col(a.wk), n_kv), cos, sin)
        v = heads(col(a.wv), n_kv)
        if cache is not None:
            qpos = (pos[:, None] if torch.is_tensor(pos) and pos.dim() == 1 else pos) + \
                torch.arange(t, device=x.device)
            if len(cache) == 4:  # int8 KV cache (see _quantize_kv)
                (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
                ck, cv, cks, cvs = (_cache_write(buf, new, pos)
                                    for buf, new in zip(cache, (kq, vq, ks, vs)))
                att = _attn(q, ck, cv, q_positions=qpos, kv_mask=kv_mask, k_scale=cks, v_scale=cvs)
            else:
                ck = _cache_write(cache[0], k.to(cache[0].dtype), pos)
                cv = _cache_write(cache[1], v.to(cache[1].dtype), pos)
                att = _attn(q, ck, cv, q_positions=qpos, kv_mask=kv_mask)
        else:
            att = _attn(q, k, v, kv_mask=kv_mask)
        att = att.transpose(1, 2).reshape(b, t, n_heads * cfg.head_dim).to(cd)
        x = x + (row_parallel(att, local(a.wo).to(cd), tp) if tp else qmatmul(att, a.wo))

        m = self.mlp
        h = rms_norm(x, self.ffn_norm, cfg.norm_eps)
        gate = F.silu(col(m.w_gate))
        y = gate * col(m.w_up)
        return x + (row_parallel(y, local(m.w_down).to(cd), tp) if tp else qmatmul(y, m.w_down))


class Llama(nn.Module):
    """Embedding, decoder blocks, final norm and LM head. Parameters are
    created frozen; load a state dict (convert.py) or random weights."""

    tp = None  # set when the LM head is split over `model`

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.dim))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.norm = nn.Parameter(torch.ones(cfg.dim))
        self.lm_head = nn.Parameter(torch.zeros(cfg.dim, cfg.vocab_size))
        self.requires_grad_(False)

    def tp_layout(self, m: int):
        """The LM head's vocabulary columns over a `model` axis of m, unless m
        does not divide the vocabulary or the head is quantized."""
        if self.cfg.vocab_size % m or not isinstance(self.lm_head, nn.Parameter):
            return None
        return {"lm_head": (1, 1)}


def local_kv_heads(model: Llama) -> int:
    """The kv heads a rank's blocks hold (all of them on a whole model): the
    head count of its KV cache."""
    tp = model.blocks[0].tp if len(model.blocks) else None
    return model.cfg.n_kv_heads // tp.size if tp else model.cfg.n_kv_heads


def _lm_head(model: Llama, h: torch.Tensor) -> torch.Tensor:
    """Float32 logits over the whole vocabulary (a split head's gathered)."""
    tp = model.tp
    if tp is None:
        return qmatmul(h, model.lm_head).float()
    return gather_from_model(column_parallel(h, local(model.lm_head).to(h.dtype), tp).float(), tp)


def llama_forward(
    model: Llama,
    tokens: Optional[torch.Tensor] = None,
    *,
    inputs_embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    compute_dtype=torch.bfloat16,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos=None,
    kv_mask: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
    remat: bool = False,
    unroll_blocks: bool = False,
):
    """Causal LM forward -> float32 logits (B, T, V).

    Exactly one of `tokens` / `inputs_embeds`. With `cache` + `cache_pos`,
    runs the decode path and returns (logits, cache), the cache updated in
    place. `kv_mask` (B, Tk) marks valid key slots (left-padded batches).
    `remat` recomputes each block in the backward (`torch.utils.checkpoint`;
    the flash forward runs again there); the cached path takes none."""
    if unroll_blocks:
        raise NotImplementedError(
            "llama_forward: unroll_blocks is JAX scan machinery; the port's blocks are a Python loop")
    cfg = model.cfg
    if inputs_embeds is None:
        inputs_embeds = model.tok_embedding[tokens]
    x = inputs_embeds.to(compute_dtype)
    b, t, _ = x.shape
    if positions is None:
        start = int(cache_pos) if cache_pos is not None else 0
        positions = start + torch.arange(t, device=x.device)
    cos, sin = rope_freqs(cfg, positions)

    if cache is not None:
        cache_len = cache["k"].shape[3]
        if kv_mask is not None and kv_mask.shape[1] < cache_len:
            # unwritten slots are invalid keys (also excluded by position)
            pad = torch.zeros(b, cache_len - kv_mask.shape[1], dtype=torch.bool, device=x.device)
            kv_mask = torch.cat([kv_mask, pad], dim=1)
        keys = ("k", "v", "ks", "vs") if "ks" in cache else ("k", "v")
        for i, blk in enumerate(model.blocks):
            x = blk(x, cos, sin, cache=tuple(cache[key][i] for key in keys), pos=cache_pos,
                    kv_mask=kv_mask)
        h = rms_norm(x, model.norm, cfg.norm_eps)
        return _lm_head(model, h), cache

    for blk in model.blocks:
        if remat and torch.is_grad_enabled():
            x = checkpoint(blk, x, cos, sin, kv_mask=kv_mask, use_reentrant=False)
        else:
            x = blk(x, cos, sin, kv_mask=kv_mask)
    x = rms_norm(x, model.norm, cfg.norm_eps)
    if return_hidden:
        return x
    return _lm_head(model, x)


def init_cache(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None,
               dtype=torch.bfloat16, kv_bits: int = 0, device=None,
               n_kv_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Stacked per-layer KV buffers (L, B, Hkv, N, hd). kv_bits=8 holds int8
    codes with float32 scales (L, B, Hkv, N) per layer, batch, head and
    token (`_quantize_kv`). `n_kv_heads` is the heads a rank holds
    (`local_kv_heads`: a split model's n_kv_heads / m), all by default."""
    n = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, n_kv_heads or cfg.n_kv_heads, n, cfg.head_dim)
    if kv_bits:
        if kv_bits != 8:
            raise ValueError(f"kv_bits must be 0 or 8, got {kv_bits}")
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "vs": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
