"""Weight-only quantization of the LM for the autoregressive decode path.

Counterpart of `robustvlm_tpu/ops/quant.py`. Decoding at small batch reads
every LM weight once per token to do about one multiply-add per weight
element, so its time is the weight bytes over the memory rate: int8 halves
the bf16 bytes, packed int4 halves them again.

- int8 (`QuantizedWeight`): symmetric per output column, q = round(w / s),
  s = max|w| / 127 over the contraction axis; y = (x @ q) * s, the scale in
  float32 after the dot and the result cast once.
- int4 (`PackedQ4Weight`): symmetric per group of G contiguous rows of K and
  output column, s = max|w| / 7, codes clipped to [-7, 7] and stored + 8,
  two per byte along K in the half-split pairing: byte r holds row r (low
  nibble) and row r + K/2 (high nibble). x @ W is then x_lo @ W_lo +
  x_hi @ W_hi, each half an elementwise decode of the bytes.

Rounding is the JAX package's (`torch.round` rounds half to even, as
`jnp.round` does), so the codes of the same float32 weights are the same.
Quantization touches generation only: the attack and loss paths run the fp
model (the threat model is defined on it) and refuse quantized leaves. Norms,
the token embedding, the vision tower and the projector stay fp.

The quantized leaves are small modules whose buffers hold the tensors; one
takes the place of an `nn.Parameter` in the model (`install_quantized`,
`quantize_decode_params_inplace`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import torch
from torch import nn

from robustvlm_tpu_torch.ops.kernels.q4_matmul import q4_matmul


class QuantizedWeight(nn.Module):
    """int8 codes q (..., K, N) and float32 per-column scales s (..., 1, N)."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)


class PackedQ4Weight(nn.Module):
    """uint8 p (..., K/2, N), two biased int4 codes a byte (low nibble row r,
    high nibble row r + K/2), and float32 scales s (..., K/G, 1, N), one per
    G rows and column; G = K // s.shape[-3], and K/2 is a multiple of G so
    that each half holds whole groups."""

    def __init__(self, p: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.register_buffer("p", p)
        self.register_buffer("s", s)


WeightLike = Union[torch.Tensor, QuantizedWeight, PackedQ4Weight]
QUANTIZED = (QuantizedWeight, PackedQ4Weight)


def quantize_q8(w: torch.Tensor, *, contract_axis: int = -2) -> QuantizedWeight:
    """Symmetric per-output-channel int8: max|w| over the contraction axis."""
    wf = w.float()
    amax = wf.abs().amax(dim=contract_axis, keepdim=True)
    s = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return QuantizedWeight(q, s)


def quantize_q4(w: torch.Tensor, *, group_size: int = 128, contract_axis: int = -2) -> PackedQ4Weight:
    """Symmetric group-wise int4 packed two a byte along K (axis -2 only)."""
    if contract_axis not in (-2, w.dim() - 2):
        raise ValueError("quantize_q4 packs along axis -2 only")
    k, n = w.shape[-2], w.shape[-1]
    if k % 2:
        raise ValueError(f"contraction dim must be even to pack, got {k}")
    # each half covers whole groups (the split dot scales each half by its
    # own groups): g divides K/2
    g = min(group_size, k // 2)
    if (k // 2) % g:
        raise ValueError(f"group_size {g} must divide K/2={k // 2} (half-split packing)")
    wg = w.float().reshape(*w.shape[:-2], k // g, g, n)
    amax = wg.abs().amax(dim=-2, keepdim=True)
    s = torch.clamp(amax, min=1e-12) / 7.0  # (..., K/g, 1, N)
    q = torch.clamp(torch.round(wg / s), -7, 7).to(torch.int8)
    b = (q.reshape(w.shape) + 8).to(torch.uint8)  # codes in [1, 15]
    lo, hi = b[..., : k // 2, :], b[..., k // 2:, :]
    return PackedQ4Weight((lo | (hi << 4)).contiguous(), s)


def _decode_q4_halves(w: PackedQ4Weight, dtype):
    """The two K-halves as (..., K/2, N) scaled weights in `dtype`."""
    p = w.p
    kh, n = p.shape[-2], p.shape[-1]
    ng = w.s.shape[-3]
    ngh, g = ng // 2, (kh * 2) // ng
    out = []
    for nib, s in ((p & 0x0F, w.s[..., :ngh, :, :]), (p >> 4, w.s[..., ngh:, :, :])):
        q = nib.to(torch.int8) - 8
        qg = q.reshape(*p.shape[:-2], ngh, g, n)
        out.append((qg.float() * s).reshape(*p.shape[:-2], kh, n).to(dtype))
    return out[0], out[1]


def dequantize(w, dtype=torch.float32) -> torch.Tensor:
    if isinstance(w, PackedQ4Weight):
        return torch.cat(_decode_q4_halves(w, dtype), dim=-2)
    return (w.q.float() * w.s).to(dtype)


def qmatmul(x: torch.Tensor, w: WeightLike) -> torch.Tensor:
    """x @ w for a plain tensor (cast to x's dtype), a QuantizedWeight (int8
    codes, the scale after the dot) or a PackedQ4Weight.

    A PackedQ4Weight routes as in the JAX package, which sends it to the
    Pallas kernel only on its accelerator and only for decode-shaped
    operands: a CUDA x whose shape `q4_matmul` takes (at most 32 flattened
    rows, a 2-D weight, N with a strip) goes to the CUDA kernel, with no
    fallback around it. Everything else takes the split dot x_lo @ W_lo +
    x_hi @ W_hi on the decoded halves, the JAX package's own XLA path (not a
    fallback): the CPU, whatever the shape, as JAX on the CPU does; the
    prefill's hundreds of rows; shapes the kernel does not take."""
    if isinstance(w, QuantizedWeight):
        y = x @ w.q.to(x.dtype)
        # the scale in float32 and one cast: a bf16 scale would round twice
        return (y.float() * w.s).to(x.dtype)
    if isinstance(w, PackedQ4Weight):
        if x.device.type == "cuda":
            y = q4_matmul(x, w.p, w.s)
            if y is not None:
                return y
        lo, hi = _decode_q4_halves(w, x.dtype)
        kh = lo.shape[-2]
        return x[..., :kh] @ lo + x[..., kh:] @ hi
    return x @ w.to(x.dtype)


def _quantize_one(a: torch.Tensor, bits: int, group_size: int):
    if bits == 8:
        return quantize_q8(a, contract_axis=-2)
    if bits == 4:
        return quantize_q4(a, group_size=group_size, contract_axis=-2)
    raise ValueError(f"bits must be 8 or 4, got {bits}")


def _is_block_matrix(name: str, a: torch.Tensor, min_size: int) -> bool:
    """A matmul weight of a decoder block, selected BY KEY: a leaf of the
    `attn` or `mlp` group that is not a bias (`*_b`) and has min_size
    elements (the norms are not under those groups)."""
    parts = name.split(".")
    return (len(parts) >= 2 and parts[-2] in ("attn", "mlp") and not parts[-1].endswith("_b")
            and a.numel() >= min_size)


def quantize_lm_blocks(blocks: Mapping[str, torch.Tensor], *, min_size: int = 1 << 16,
                       bits: int = 8, group_size: int = 128) -> Dict[str, object]:
    """Quantize the matmul weights of decoder blocks given as a state dict
    (names like `<i>.attn.wq`, `<i>.mlp.w_down`, any prefix); every other
    entry passes through."""
    return {k: _quantize_one(v, bits, group_size) if _is_block_matrix(k, v, min_size) else v
            for k, v in blocks.items()}


def quantize_llama_decode_params(state: Mapping[str, torch.Tensor], *, quantize_lm_head: bool = True,
                                 min_size: int = 1 << 16, bits: int = 8,
                                 group_size: int = 128) -> Dict[str, object]:
    """The decode-serving layout of a `Llava` state dict, functionally: the
    LM block weights (`llama.blocks.*`) and, by default, `llama.lm_head`
    become quantized leaves; the token embedding, the norms, the vision
    tower and the projector stay fp. `Llava.from_state` takes the result."""
    blocks = {k: v for k, v in state.items() if k.startswith("llama.blocks.")}
    out = dict(state)
    out.update(quantize_lm_blocks(blocks, min_size=min_size, bits=bits, group_size=group_size))
    if quantize_lm_head and "llama.lm_head" in out:
        out["llama.lm_head"] = _quantize_one(out["llama.lm_head"], bits, group_size)
    return out


def _put(module: nn.Module, name: str, leaf: nn.Module) -> None:
    """`leaf` in place of the parameter `name` of `module`."""
    delattr(module, name)
    setattr(module, name, leaf)


@torch.no_grad()
def quantize_decode_params_inplace(model: nn.Module, *, quantize_lm_head: bool = True,
                                   min_size: int = 1 << 16, bits: int = 8,
                                   group_size: int = 128) -> nn.Module:
    """SERVING-ONLY progressive quantization of a `Llava` (or `Llama`) in
    place: the same leaves as `quantize_llama_decode_params`, one at a time,
    each fp parameter dropped from the model before the next is quantized, so
    that the device holds the fp model plus one quantized leaf at most (when
    the model holds the only reference to its weights). The fp weights are
    gone afterwards: the loss path refuses the model. Returns `model`."""
    llama = getattr(model, "llama", model)
    for i, blk in enumerate(llama.blocks):
        for grp_name in ("attn", "mlp"):
            grp = getattr(blk, grp_name)
            for name in list(grp._parameters):
                if _is_block_matrix(f"{i}.{grp_name}.{name}", grp._parameters[name], min_size):
                    _put(grp, name, _quantize_one(grp._parameters[name], bits, group_size))
    if quantize_lm_head:
        _put(llama, "lm_head", _quantize_one(llama.lm_head, bits, group_size))
    return model


def install_quantized(model: nn.Module, state: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """Put each quantized leaf of `state` into `model` in place of the
    parameter of its name, and return `state` with those leaves flattened
    into their buffers (`<name>.q` or `<name>.p`, and `<name>.s`), ready for
    `load_state_dict`."""
    flat: Dict[str, torch.Tensor] = {}
    for name, v in state.items():
        if isinstance(v, QUANTIZED):
            parent, _, leaf = name.rpartition(".")
            _put(model.get_submodule(parent), leaf, v)
            flat.update({f"{name}.{k}": b for k, b in v.named_buffers()})
        else:
            flat[name] = v
    return flat


def has_quantized(model: nn.Module) -> bool:
    return any(isinstance(m, QUANTIZED) for m in model.modules())
