"""MPT decoder (the OpenFlamingo-9B language model) as PyTorch modules.

Counterpart of `robustvlm_tpu/models/mpt/model.py`: pre-LN blocks
(LayerNorm with float32 statistics and no bias: `block_ops.layer_norm`,
one-pass kernels on a CUDA tensor), fused Wqkv attention with an ALiBi
bias and no positional embeddings, a 4x exact-GELU MLP and the LM head tied
to the token embedding, float32 logits. Bias-free throughout, as every MPT
configuration here is (the JAX config's `no_bias=True`). Parameter
names and layouts are the JAX tree's (linear weights (in, out) for
`x @ w`), so a JAX tree carries across by name (`convert.py`).

- ALiBi: slope_h = 2^(-(h+1) * 8 / n') over the next power of two n' of the
  head count, interleaved back down to n heads; the bias is
  -slope * (i - j).
- The full-sequence causal path (no cache, no key mask, no shifted
  positions) goes through the port's `flash_attention_qkv` with the slopes
  on every device: the CUDA kernels on the card, which read the heads out of
  the fused Wqkv projection, their plain version on the CPU. The JAX
  package chooses its Pallas kernel by a shape rule measured on a TPU v5e
  (head dim 128, 1024 tokens or more, 64 batch x head rows or more); that
  measurement does not carry over, so the port takes the kernel
  whatever the length, as its LLaMA does. The function is the same either
  way. The cached and masked paths stay masked plain attention, as in JAX.
- `layer_hook(i, x) -> x` runs before each block: the insertion point of
  Flamingo's gated cross-attention.
- Layers are an `nn.ModuleList` walked by a Python loop (JAX scans stacked
  blocks). The KV cache is one (L, B, H, N, hd) buffer per k and v, written
  in place.
- Every block matmul and the LM head go through `ops/quant.qmatmul`: a
  plain weight is cast to the compute dtype (a model already held in that
  dtype casts nothing).
- A block split over the mesh's `model` axis (`parallel/mesh.shard_params`
  sets its `tp`) holds this rank's heads of the fused [q|k|v] columns and
  ffn columns, runs attention on its H/m heads with its slice of the ALiBi
  slopes (`alibi_slopes(H)[r*H/m:(r+1)*H/m]`, not `alibi_slopes(H/m)`, a
  different series) and sums the out and down products over `model`
  (`parallel/tensor_parallel.py`). The LM head, tied to the embedding,
  stays whole. A quantized block stays whole. A cache holds the rank's
  heads (`local_heads`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from robustvlm_tpu_torch.models.llama.model import _cache_write
from robustvlm_tpu_torch.ops.kernels import block_ops
from robustvlm_tpu_torch.ops.kernels.flash_attention import flash_attention_qkv
from robustvlm_tpu_torch.ops.quant import qmatmul
from robustvlm_tpu_torch.parallel.tensor_parallel import column_parallel, local, row_parallel


@dataclasses.dataclass(frozen=True)
class MPTConfig:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    vocab_size: int
    expansion_ratio: int = 4
    norm_eps: float = 1e-5
    alibi_bias_max: float = 8.0
    max_seq_len: int = 2048

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


MPT_CONFIGS: Dict[str, MPTConfig] = {
    # mosaicml/mpt-7b as OpenFlamingo-9B uses it (the vocabulary holds the
    # <image> and <|endofchunk|> tokens Flamingo adds)
    "mpt-7b": MPTConfig("mpt-7b", 4096, 32, 32, 50432),
    "mpt-1b": MPTConfig("mpt-1b", 2048, 24, 16, 50368),
    "test-tiny": MPTConfig("test-tiny", 64, 2, 4, 512, max_seq_len=128),
}


def alibi_slopes(n_heads: int, alibi_bias_max: float = 8.0) -> np.ndarray:
    """(n_heads,) float32 slopes (the reference's gen_slopes)."""
    n2 = 2 ** math.ceil(math.log2(n_heads))
    m = np.arange(1, n2 + 1, dtype=np.float32) * (alibi_bias_max / n2)
    slopes = 1.0 / np.power(2.0, m)
    if n2 != n_heads:
        slopes = np.concatenate([slopes[1::2], slopes[::2]])[:n_heads]
    return slopes.astype(np.float32)


def layer_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """Bias-free LayerNorm with float32 statistics, cast back to x's dtype."""
    return block_ops.layer_norm(x, g, None, eps)


def _attn_masked(q, k, v, slopes: torch.Tensor, *, q_positions: torch.Tensor,
                 kv_mask: Optional[torch.Tensor], kv_positions: Optional[torch.Tensor] = None):
    """ALiBi causal attention on true positions: q (B, H, Tq, hd), k/v
    (B, H, Tk, hd); q_positions (Tq,) or (B, Tq); kv_positions (B, Tk) the
    key slots' true positions (default 0..Tk-1), needed when padding sits
    mid-sequence; kv_mask (B, Tk) marks valid keys. Bias -slope * (i - j)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    tk = k.shape[2]
    jj = (torch.arange(tk, device=q.device)[None, None, :] if kv_positions is None
          else kv_positions[:, None, :])
    qpos = q_positions[None] if q_positions.dim() == 1 else q_positions
    rel = qpos[:, :, None] - jj                                    # (B?, Tq, Tk) = i - j
    s = s - slopes.float()[None, :, None, None] * rel[:, None].float()
    mask = rel >= 0
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, :]
    s = torch.where(mask[:, None], s, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


class Attention(nn.Module):
    def __init__(self, cfg: MPTConfig):
        super().__init__()
        d = cfg.d_model
        self.wqkv = nn.Parameter(torch.zeros(d, 3 * d))
        self.out_w = nn.Parameter(torch.zeros(d, d))


class MLP(nn.Module):
    def __init__(self, cfg: MPTConfig):
        super().__init__()
        d, f = cfg.d_model, cfg.expansion_ratio * cfg.d_model
        self.up_w = nn.Parameter(torch.zeros(d, f))
        self.down_w = nn.Parameter(torch.zeros(f, d))


class Block(nn.Module):
    tp = None  # parallel.tensor_parallel.TensorParallel when split over `model`

    def __init__(self, cfg: MPTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.norm_1 = nn.Parameter(torch.ones(d))
        self.norm_2 = nn.Parameter(torch.ones(d))
        self.attn = Attention(cfg)
        self.mlp = MLP(cfg)

    def tp_layout(self, m: int):
        """{parameter: (split dim, blocks)} over a `model` axis of m, or None
        (the block stays whole) when m does not divide the heads or the ffn
        width, or a weight is quantized."""
        a, f = self.attn, self.mlp
        if (self.cfg.n_heads % m or f.up_w.shape[1] % m
                or not all(isinstance(w, nn.Parameter) for w in (a.wqkv, a.out_w, f.up_w, f.down_w))):
            return None
        return {"attn.wqkv": (1, 3), "attn.out_w": (0, 1), "mlp.up_w": (1, 1), "mlp.down_w": (0, 1)}

    def forward(self, x, slopes, *, cache=None, pos=None, kv_mask=None, positions=None,
                kv_positions=None):
        """One decoder layer. cache: (k, v) buffers (B, H, N, hd) written in
        place at `pos`; kv_mask (B, Tk) marks valid keys. `slopes` are all H
        heads' (a split block takes its own)."""
        cfg, tp = self.cfg, self.tp
        b, t, _ = x.shape
        cd = x.dtype
        a, m = self.attn, self.mlp
        n_heads = cfg.n_heads // tp.size if tp else cfg.n_heads
        if tp:
            slopes = slopes[tp.rank * n_heads:(tp.rank + 1) * n_heads]

        def col(h, w):  # a split block's column-parallel product, else qmatmul
            return column_parallel(h, local(w).to(cd), tp) if tp else qmatmul(h, w)

        def row(h, w):  # the sum over `model` of the row-parallel product
            return row_parallel(h, local(w).to(cd), tp) if tp else qmatmul(h, w)

        h = layer_norm(x, self.norm_1, cfg.norm_eps)
        qkv = col(h, a.wqkv)
        w = n_heads * cfg.head_dim
        if cache is None and kv_mask is None and positions is None:
            att = flash_attention_qkv(qkv, n_heads, causal=True, alibi_slopes=slopes)
        else:
            q, k, v = (y.reshape(b, t, n_heads, cfg.head_dim).transpose(1, 2)
                       for y in qkv.split(w, dim=-1))
            if cache is not None:
                slot_q = None if pos is None else int(pos) + torch.arange(t, device=x.device)
                ck = _cache_write(cache[0], k.to(cache[0].dtype), pos)
                cv = _cache_write(cache[1], v.to(cache[1].dtype), pos)
                if kv_positions is not None:
                    # true token positions for q and k: exact ALiBi distances
                    # even with mid-sequence padding
                    qp = positions if positions is not None else slot_q
                    att = _attn_masked(q, ck, cv, slopes, q_positions=qp, kv_mask=kv_mask,
                                       kv_positions=kv_positions)
                else:
                    # a uniform left pad: slot distances are token distances
                    att = _attn_masked(q, ck, cv, slopes, q_positions=slot_q, kv_mask=kv_mask)
            else:
                qp = positions if positions is not None else torch.arange(t, device=x.device)
                att = _attn_masked(q, k, v, slopes, q_positions=qp, kv_mask=kv_mask)
            att = att.transpose(1, 2).reshape(b, t, w)
        x = x + row(att.to(cd), a.out_w)
        h = layer_norm(x, self.norm_2, cfg.norm_eps)
        return x + row(F.gelu(col(h, m.up_w)), m.down_w)


class MPT(nn.Module):
    """Token embedding (also the LM head), decoder blocks and the final
    norm. Parameters are created frozen; load a state dict (`convert.py`)
    with `from_state`."""

    def __init__(self, cfg: MPTConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_model))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.norm_f = nn.Parameter(torch.ones(cfg.d_model))
        self.requires_grad_(False)

    @classmethod
    def from_state(cls, cfg: MPTConfig, state: Dict[str, torch.Tensor]) -> "MPT":
        """A model that holds `state`'s tensors themselves (no copy)."""
        with torch.device("meta"):
            model = cls(cfg)
        model.load_state_dict(state, assign=True, strict=True)
        return model.requires_grad_(False)


def mpt_forward(
    model: MPT,
    tokens: Optional[torch.Tensor] = None,
    *,
    inputs_embeds: Optional[torch.Tensor] = None,
    compute_dtype=torch.bfloat16,
    remat: bool = False,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos=None,
    kv_mask: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    layer_hook=None,
    return_hidden: bool = False,
):
    """Causal MPT forward -> float32 logits (B, T, V), the LM head tied to
    the token embedding. With `cache` + `cache_pos`, the decode path: returns
    (logits, cache), the cache updated in place. `kv_mask` (B, Tk) marks
    valid keys (left-padded batches); `positions` are the queries' true
    positions on the uncached path; `layer_hook(i, x) -> x` runs before
    block i. `remat` recomputes each block (not the hook) in the backward
    (`torch.utils.checkpoint`); the cached path takes none."""
    cfg = model.cfg
    if inputs_embeds is None:
        inputs_embeds = model.tok_embedding[tokens]
    x = inputs_embeds.to(compute_dtype)
    slopes = torch.from_numpy(alibi_slopes(cfg.n_heads, cfg.alibi_bias_max)).to(x.device)
    hook = layer_hook or (lambda i, h: h)

    if cache is not None:
        cache_len = cache["k"].shape[3]
        if kv_mask is not None and kv_mask.shape[1] < cache_len:
            pad = torch.zeros(x.shape[0], cache_len - kv_mask.shape[1], dtype=torch.bool,
                              device=x.device)
            kv_mask = torch.cat([kv_mask, pad], dim=1)
        for i, blk in enumerate(model.blocks):
            x = blk(hook(i, x), slopes, cache=(cache["k"][i], cache["v"][i]), pos=cache_pos,
                    kv_mask=kv_mask, positions=positions, kv_positions=kv_positions)
        h = layer_norm(x, model.norm_f, cfg.norm_eps)
        return qmatmul(h, model.tok_embedding.T).float(), cache

    for i, blk in enumerate(model.blocks):
        x = hook(i, x)
        if remat and torch.is_grad_enabled():
            x = checkpoint(blk, x, slopes, kv_mask=kv_mask, positions=positions, use_reentrant=False)
        else:
            x = blk(x, slopes, kv_mask=kv_mask, positions=positions)
    x = layer_norm(x, model.norm_f, cfg.norm_eps)
    if return_hidden:
        return x
    return qmatmul(x, model.tok_embedding.T).float()


def local_heads(model: MPT) -> int:
    """The heads a rank's blocks hold (all of them on a whole model): the
    head count of its KV cache."""
    tp = model.blocks[0].tp if len(model.blocks) else None
    return model.cfg.n_heads // tp.size if tp else model.cfg.n_heads


def init_mpt_cache(cfg: MPTConfig, batch: int, max_len: Optional[int] = None,
                   dtype=torch.bfloat16, device=None, n_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Stacked per-layer KV buffers (L, B, H, N, hd). `n_heads` is the heads
    a rank holds (`local_heads`: a split model's H / m), all by default."""
    n = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, n_heads or cfg.n_heads, n, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
