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
- Layers are an `nn.ModuleList` walked by a Python loop (JAX scans stacked
  blocks). The KV cache is one (L, B, Hkv, N, hd) buffer per k and v,
  written in place.
- Weights are cast to the compute dtype at each matmul (the JAX
  `qmatmul` convention for plain leaves); a model already held in that
  dtype casts nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from robustvlm_tpu_torch.ops.kernels.flash_attention import flash_attention


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


def _attn(q, k, v, *, q_positions=None, kv_mask=None) -> torch.Tensor:
    """Causal attention: q (B, Hq, Tq, hd), k/v (B, Hkv, Tk, hd). A full
    sequence without key mask takes `flash_attention`; otherwise (cached
    decode: Tq < Tk) key j is visible from query position p when j <= p
    (q_positions (Tq,) or (B, Tq), default the last Tq slots) and kv_mask
    (B, Tk) marks it valid."""
    n_rep = q.shape[1] // k.shape[1]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    tq, tk = q.shape[2], k.shape[2]
    if tq == tk and kv_mask is None and q_positions is None:
        return flash_attention(q, k, v, causal=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * (1.0 / math.sqrt(q.shape[-1]))
    qpos = torch.arange(tq, device=q.device) + (tk - tq) if q_positions is None else q_positions
    jj = torch.arange(tk, device=q.device)
    if qpos.dim() == 1:
        mask = (jj[None, :] <= qpos[:, None])[None]        # (1, Tq, Tk)
    else:
        mask = jj[None, None, :] <= qpos[:, :, None]       # (B, Tq, Tk)
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, :]
    s = torch.where(mask[:, None], s, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _cache_write(buf: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Write `new` (B, H, T, ...) into `buf` at token offset `pos`, in place.
    pos: an int or 0-dim tensor (one offset for the batch), or a (B,) tensor
    of per-slot offsets (continuous batching)."""
    t = new.shape[2]
    if not torch.is_tensor(pos) or pos.dim() == 0:
        p = int(pos)
        buf[:, :, p:p + t] = new
        return buf
    for i, p in enumerate(pos.tolist()):
        buf[i, :, p:p + t] = new[i]
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
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = nn.Parameter(torch.ones(cfg.dim))
        self.ffn_norm = nn.Parameter(torch.ones(cfg.dim))
        self.attn = Attention(cfg)
        self.mlp = MLP(cfg)

    def forward(self, x, cos, sin, *, cache=None, pos=None, kv_mask=None):
        """One decoder layer. cache: (k, v) buffers (B, Hkv, N, hd) written
        in place at `pos` (int, or (B,) per-slot offsets); kv_mask (B, N)
        marks valid key slots."""
        cfg = self.cfg
        b, t, _ = x.shape
        cd = x.dtype
        a = self.attn

        def heads(y, n):
            return y.reshape(b, t, n, cfg.head_dim).transpose(1, 2)

        h = rms_norm(x, self.attn_norm, cfg.norm_eps)
        q = apply_rope(heads(h @ a.wq.to(cd), cfg.n_heads), cos, sin)
        k = apply_rope(heads(h @ a.wk.to(cd), cfg.n_kv_heads), cos, sin)
        v = heads(h @ a.wv.to(cd), cfg.n_kv_heads)
        if cache is not None:
            qpos = (pos[:, None] if torch.is_tensor(pos) and pos.dim() == 1 else pos) + \
                torch.arange(t, device=x.device)
            ck = _cache_write(cache[0], k.to(cache[0].dtype), pos)
            cv = _cache_write(cache[1], v.to(cache[1].dtype), pos)
            att = _attn(q, ck, cv, q_positions=qpos, kv_mask=kv_mask)
        else:
            att = _attn(q, k, v, kv_mask=kv_mask)
        att = att.transpose(1, 2).reshape(b, t, cfg.dim)
        x = x + att.to(cd) @ a.wo.to(cd)

        m = self.mlp
        h = rms_norm(x, self.ffn_norm, cfg.norm_eps)
        gate = F.silu(h @ m.w_gate.to(cd))
        return x + (gate * (h @ m.w_up.to(cd))) @ m.w_down.to(cd)


class Llama(nn.Module):
    """Embedding, decoder blocks, final norm and LM head. Parameters are
    created frozen; load a state dict (convert.py) or random weights."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.dim))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.norm = nn.Parameter(torch.ones(cfg.dim))
        self.lm_head = nn.Parameter(torch.zeros(cfg.dim, cfg.vocab_size))
        self.requires_grad_(False)


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
    place. `kv_mask` (B, Tk) marks valid key slots (left-padded batches)."""
    if remat:
        raise NotImplementedError("llama_forward: remat is not ported (ROADMAP A7, training)")
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
        if "ks" in cache:
            raise NotImplementedError(
                "llama_forward: the int8 KV cache is not ported (ROADMAP A13, serving)")
        cache_len = cache["k"].shape[3]
        if kv_mask is not None and kv_mask.shape[1] < cache_len:
            # unwritten slots are invalid keys (also excluded by position)
            pad = torch.zeros(b, cache_len - kv_mask.shape[1], dtype=torch.bool, device=x.device)
            kv_mask = torch.cat([kv_mask, pad], dim=1)
        for i, blk in enumerate(model.blocks):
            x = blk(x, cos, sin, cache=(cache["k"][i], cache["v"][i]), pos=cache_pos,
                    kv_mask=kv_mask)
        h = rms_norm(x, model.norm, cfg.norm_eps)
        return (h @ model.lm_head.to(h.dtype)).float(), cache

    for blk in model.blocks:
        x = blk(x, cos, sin, kv_mask=kv_mask)
    x = rms_norm(x, model.norm, cfg.norm_eps)
    if return_hidden:
        return x
    return (x @ model.lm_head.to(x.dtype)).float()


def init_cache(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None,
               dtype=torch.bfloat16, kv_bits: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """Stacked per-layer KV buffers (L, B, Hkv, N, hd)."""
    if kv_bits:
        raise NotImplementedError("init_cache: the int8 KV cache is not ported (ROADMAP A13, serving)")
    n = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, n, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
