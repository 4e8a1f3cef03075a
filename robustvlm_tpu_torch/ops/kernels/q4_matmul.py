"""Packed-int4 weight matmul, the decode step's hot op: CUDA kernel and its
plain version.

Counterpart of `robustvlm_tpu/ops/pallas/q4_matmul.py`. The kernel in
`csrc/q4_matmul.cu` replaces `_q4_matmul_2d` and both of its bodies:
`_kernel_group` (the default) and `_kernel` (`Q4_KERNEL=shift`), read at
call time as `_use_group_kernel` reads it. `q4_matmul_reference` computes
each body's function in PyTorch:

- x (B, K) is cast to bf16 and split into halves x_lo, x_hi (K/2 each);
  the uint8 p (K/2, N) holds row r of W_lo in its low nibble and row r of
  W_hi in its high nibble, code q meaning q - 8; s (K/G, 1, N) float32 holds
  one scale per G rows, the first K/(2G) groups for W_lo;
- group: per group, the float32 dot of x_h with the unscaled (q - 8) rows,
  times the group's scale, summed over groups; out = y_lo + y_hi;
- shift: w_h = bf16(bf16(q - 8) * bf16(s)), out = x_lo . w_lo + x_hi . w_hi
  with float32 sums;
- the result in x's dtype.

`q4_matmul` flattens leading dims and returns None exactly where the JAX
function does (p not 2-D, K mismatch, more than 32 flattened rows, no strip
from `_pick_bn`'s rule), so `ops/quant.qmatmul` routes the same shapes in
both packages. CPU tensors take the plain version; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Dict, Optional

import torch

from robustvlm_tpu_torch.ops.kernels import _build

# launches of the CUDA kernel (not of the plain version), per body, and per
# body and row count ("q4_matmul_group@4": a continuous-batching step of 4
# lanes; "@8": a speculative verify step at k = 7)
LAUNCHES = {"q4_matmul_group": 0, "q4_matmul_shift": 0}
LAUNCHES_BY_ROWS: Dict[str, int] = {}

MAX_ROWS = 32  # decode-sized activations; larger batches take the split dot
KERNEL_COLS = 128  # N must be a multiple of this (every N that pick_strip admits is)

# `_pick_bn`'s rule (the JAX kernel's strip widths and its VMEM budget for two
# decoded bf16 halves). It sizes nothing here; it decides which shapes are
# eligible, so that the two packages route the same shapes to their kernels.
_BN_CANDIDATES = (512, 384, 256, 128)
_DECODED_VMEM_BUDGET = 8 * 2**20


def pick_strip(kh: int, n: int) -> Optional[int]:
    for bn in _BN_CANDIDATES:
        if n % bn == 0 and 2 * (kh * bn * 2) <= _DECODED_VMEM_BUDGET:
            return bn
    return None


def use_group_kernel() -> bool:
    """The group body unless Q4_KERNEL says otherwise (read at each call)."""
    return os.environ.get("Q4_KERNEL", "group") == "group"


# ------------------------------------------------------------- plain version
def q4_matmul_reference(x: torch.Tensor, p: torch.Tensor, s: torch.Tensor, *,
                        group: Optional[bool] = None) -> torch.Tensor:
    """x (B, K) times the packed weight (p (K/2, N) uint8, s (K/G, 1, N)
    float32) -> (B, N) in x's dtype: the function of the group body (or, with
    group=False, of the shift body)."""
    if group is None:
        group = use_group_kernel()
    b = x.shape[0]
    kh, n = p.shape
    ng = s.shape[0]
    ngh, g = ng // 2, kh // (ng // 2)
    xb = x.to(torch.bfloat16)
    s2 = s.reshape(ng, n).float()
    out = None
    for h, (nib, sh) in enumerate(((p & 0x0F, s2[:ngh]), (p >> 4, s2[ngh:]))):
        xh = xb[:, h * kh:(h + 1) * kh].float()
        q = nib.to(torch.int32) - 8
        if group:
            part = torch.bmm(xh.reshape(b, ngh, g).transpose(0, 1),
                             q.float().reshape(ngh, g, n))     # (ngh, B, N)
            y = (part * sh[:, None, :]).sum(dim=0)
        else:
            w = q.to(torch.bfloat16).reshape(ngh, g, n) * sh.to(torch.bfloat16)[:, None, :]
            y = xh @ w.reshape(kh, n).float()
        out = y if out is None else out + y
    return out.to(x.dtype)


# ----------------------------------------------------------------- CUDA path
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("q4_matmul"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from q4_matmul.cu."""
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.q4_matmul.argtypes = [ptr, ptr, ptr, ptr, i, i, i, i, i, i, ptr]
    lib.q4_matmul.restype = ctypes.c_int
    return lib


def _check_cuda(x: torch.Tensor, p: torch.Tensor, s: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q4_matmul: the kernel takes float32 or bfloat16 x, got {x.dtype}")
    if p.dtype != torch.uint8 or s.dtype != torch.float32:
        raise TypeError(f"q4_matmul: expected uint8 codes and float32 scales, got {p.dtype}, {s.dtype}")
    if x.dim() != 2 or p.dim() != 2:
        raise ValueError(f"q4_matmul: expected x (B, K) and p (K/2, N), got {tuple(x.shape)}, "
                         f"{tuple(p.shape)}")
    b, k = x.shape
    kh, n = p.shape
    if k != 2 * kh:
        raise ValueError(f"q4_matmul: x has K = {k}, the packed weight {2 * kh}")
    if not 1 <= b <= MAX_ROWS:
        raise ValueError(f"q4_matmul: the kernel takes 1 to {MAX_ROWS} rows, got {b}")
    ng = s.shape[0] if s.dim() == 3 else 0
    if s.dim() != 3 or s.shape[1:] != (1, n) or ng < 2 or ng % 2 or kh % (ng // 2):
        raise ValueError(f"q4_matmul: scales {tuple(s.shape)} do not fit p {tuple(p.shape)}")
    if (kh // (ng // 2)) % 16 or n % KERNEL_COLS:
        raise ValueError(f"q4_matmul: the kernel takes groups of a multiple of 16 rows and N a "
                         f"multiple of {KERNEL_COLS}; got G = {kh // (ng // 2)}, N = {n}")
    for t in (x, p, s):
        if t.device != x.device:
            raise ValueError("q4_matmul: x, p and s must share a device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q4_matmul: the kernel takes contiguous, 16-byte aligned tensors")


def q4_matmul_cuda(x: torch.Tensor, p: torch.Tensor, s: torch.Tensor, *,
                   group: Optional[bool] = None) -> torch.Tensor:
    """The kernel on x (B, K), B <= 32 -> (B, N) in x's dtype."""
    if group is None:
        group = use_group_kernel()
    _check_cuda(x, p, s)
    xb = x.to(torch.bfloat16).contiguous()
    b, n = x.shape[0], p.shape[1]
    out = torch.empty(b, n, dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.q4_matmul(xb.data_ptr(), p.data_ptr(), s.data_ptr(), out.data_ptr(), b,
                            p.shape[0], n, s.shape[0] // 2, int(x.dtype == torch.bfloat16),
                            int(not group), stream)
    _build.check_launch(err, "q4_matmul")
    name = "q4_matmul_group" if group else "q4_matmul_shift"
    LAUNCHES[name] += 1
    LAUNCHES_BY_ROWS[f"{name}@{b}"] = LAUNCHES_BY_ROWS.get(f"{name}@{b}", 0) + 1
    return out


def q4_matmul(x: torch.Tensor, p: torch.Tensor, s: torch.Tensor) -> Optional[torch.Tensor]:
    """x (..., K) times a half-split packed int4 weight's (p, s) -> (..., N),
    or None where the JAX function returns None: p not 2-D, K mismatch, more
    than 32 flattened rows, or N without a strip."""
    if p.dim() != 2:
        return None
    kh, n = p.shape
    k = 2 * kh
    if x.shape[-1] != k:
        return None
    lead = x.shape[:-1]
    b = math.prod(lead)
    if b > MAX_ROWS or pick_strip(kh, n) is None:
        return None
    xb = x.reshape(b, k)
    if x.device.type == "cpu":
        out = q4_matmul_reference(xb, p, s)
    else:
        out = q4_matmul_cuda(xb, p, s)
    return out.reshape(*lead, n)
