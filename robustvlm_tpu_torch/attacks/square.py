"""Square Attack (black-box random search), l-inf, l2 and l1.

Counterpart of `robustvlm_tpu/attacks/square.py`: vertical-stripe (l-inf)
or tiled-square (l2, l1) init, the piecewise p-schedule of the square size
(rescaled to n_queries), per-channel squares, margin-loss acceptance, each
example searched on its own. Forward only: no gradient is taken.

The JAX version advances every example in lockstep inside compiled chunks
and checks for global success between chunks. Here the loop goes query by
query, forwards only the examples still being attacked (margin >= 0), and
stops once every example is fooled: the same result, since a fooled
example never accepts another update. Draws come from a `torch.Generator`
seeded with the integer `rng`; each query draws for the active examples
only.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from robustvlm_tpu_torch.attacks._validate import check_image_range
from robustvlm_tpu_torch.attacks.apgd import generator
from robustvlm_tpu_torch.ops.projections import l1_ball_projection


class SquareResult(NamedTuple):
    x_adv: torch.Tensor
    margin: torch.Tensor     # (B,) final margin; < 0 means misclassified
    n_queries: torch.Tensor  # (B,) queries consumed per example


def _p_schedule(it: int, n_queries: int, p_init: float, rescale: bool) -> float:
    """Square-fraction schedule; with `rescale` the brackets are on a
    10k-query scale mapped onto n_queries."""
    if rescale:
        it = int(it / n_queries * 10000)
    brackets = [
        (10, 1), (50, 2), (200, 4), (500, 8), (1000, 16),
        (2000, 32), (4000, 64), (6000, 128), (8000, 256), (10000, 512),
    ]
    div = 512
    for edge, d in brackets:
        if it <= edge:
            div = d
            break
    return p_init / div


def margin_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """z_y - max_{k != y} z_k (negative == misclassified)."""
    zy = logits.gather(1, y[:, None])[:, 0]
    one_hot = torch.nn.functional.one_hot(y, logits.shape[-1]).bool()
    return zy - logits.masked_fill(one_hot, -math.inf).amax(dim=-1)


def _rademacher(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    return (2 * torch.randint(0, 2, shape, generator=gen, device=device) - 1).to(dtype)


def _randint(gen: torch.Generator, high: int, n: int, device) -> torch.Tensor:
    return torch.randint(0, max(high, 1), (n,), generator=gen, device=device)


def _window_mask(vh: torch.Tensor, vw: torch.Tensor, s: int, h: int, w: int, dtype) -> torch.Tensor:
    """(n, 1, h, w): 1 inside the s x s window at (vh, vw)."""
    rows = torch.arange(h, device=vh.device)[None, :, None]
    cols = torch.arange(w, device=vh.device)[None, None, :]
    in_rows = (rows >= vh[:, None, None]) & (rows < vh[:, None, None] + s)
    in_cols = (cols >= vw[:, None, None]) & (cols < vw[:, None, None] + s)
    return (in_rows & in_cols)[:, None].to(dtype)


def _search(logits_fn, x, y, x_adv, n_steps: int, propose) -> SquareResult:
    """The shared query loop: `propose(it, idx)` returns candidates for the
    examples `idx` still being attacked; a candidate is kept when it lowers
    the margin."""
    with torch.no_grad():
        margin = margin_loss(logits_fn(x_adv), y)
        queries = torch.ones((x.shape[0],), dtype=torch.int32, device=x.device)
        for it in range(n_steps):
            idx = torch.nonzero(margin >= 0.0)[:, 0]
            if idx.numel() == 0:
                break
            x_cand = propose(it, idx)
            cand = margin_loss(logits_fn(x_cand), y[idx])
            keep = cand < margin[idx]
            x_adv[idx[keep]] = x_cand[keep]
            margin[idx[keep]] = cand[keep]
            queries[idx] += 1
    return SquareResult(x_adv=x_adv, margin=margin, n_queries=queries)


def square_attack_linf(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    eps: float,
    n_queries: int = 5000,
    p_init: float = 0.8,
    rng: Optional[int] = None,
    rescale_schedule: bool = True,
) -> SquareResult:
    """l-inf Square Attack; returns the best points found."""
    check_image_range(x)
    gen = generator(0 if rng is None else rng, x.device)
    b, c, h, w = x.shape
    n_fts = c * h * w

    # init: full-height random-sign stripes of width 1
    stripes = _rademacher(gen, (b, c, 1, w), x.dtype, x.device)
    x_adv = torch.clamp(x + eps * stripes, 0.0, 1.0)

    def propose(it, idx):
        p = _p_schedule(it, n_queries, p_init, rescale_schedule)
        s = max(int(round(math.sqrt(p * n_fts / c))), 1)
        s = min(s, h - 1 if h > 1 else 1)
        n = idx.numel()
        vh = _randint(gen, h - s + 1, n, x.device)
        vw = _randint(gen, w - s + 1, n, x.device)
        sign = _rademacher(gen, (n, c, 1, 1), x.dtype, x.device)
        sq = _window_mask(vh, vw, s, h, w, x.dtype).bool()
        xa = x[idx]
        delta = torch.where(sq, sign * eps, x_adv[idx] - xa)
        return torch.clamp(xa + torch.clamp(delta, -eps, eps), 0.0, 1.0)

    return _search(logits_fn, x, y, x_adv, n_queries - 1, propose)


# ---------------------------------------------------------------------- L2
def _eta_rectangles(x: int, y: int) -> np.ndarray:
    """Concentric-ring pattern of the l2 squares."""
    delta = np.zeros((x, y), np.float32)
    x_c, y_c = x // 2 + 1, y // 2 + 1
    c2 = [x_c - 1, y_c - 1]
    for counter in range(0, max(x_c, y_c)):
        delta[
            max(c2[0], 0): min(c2[0] + 2 * counter + 1, x),
            max(0, c2[1]): min(c2[1] + 2 * counter + 1, y),
        ] += 1.0 / (counter + 1) ** 2
        c2[0] -= 1
        c2[1] -= 1
    return delta / np.sqrt((delta ** 2).sum())


def _eta(s: int) -> np.ndarray:
    """Bipolar pseudo-gaussian square (the random transpose is applied at
    the call site)."""
    delta = np.zeros((s, s), np.float32)
    delta[: s // 2] = _eta_rectangles(s // 2, s)
    delta[s // 2:] = -_eta_rectangles(s - s // 2, s)
    return delta / np.sqrt((delta ** 2).sum())


def _tiled_init_delta(gen, b, c, h, w, s0, sp, e0, dtype, device) -> torch.Tensor:
    """Initial delta: the eta tile repeated over an (h, w) grid with an
    independent random sign per (example, channel, tile)."""
    canvas = np.zeros((h, w), np.float32)
    tile_i = np.full((h, w), -1, np.int64)
    tile_j = np.full((h, w), -1, np.int64)
    vh = max(sp, 0)
    n_ti = max(h // s0, 1)
    n_tj = max(w // s0, 1)
    for i in range(n_ti):
        vw = max(sp, 0)
        for j in range(n_tj):
            if vh + s0 <= h and vw + s0 <= w:
                canvas[vh: vh + s0, vw: vw + s0] += e0
                tile_i[vh: vh + s0, vw: vw + s0] = i
                tile_j[vh: vh + s0, vw: vw + s0] = j
            vw += s0
        vh += s0
    signs = _rademacher(gen, (b, c, n_ti, n_tj), dtype, device)
    ti = torch.from_numpy(np.maximum(tile_i, 0)).to(device)
    tj = torch.from_numpy(np.maximum(tile_j, 0)).to(device)
    return torch.from_numpy(canvas).to(device=device, dtype=dtype)[None, None] * signs[:, :, ti, tj]


def _l2_sides(n_queries: int, n_fts: int, c: int, h: int, w: int,
              p_init: float, rescale: bool):
    """Per-iteration square sides for the l2 and l1 schedules (odd, >= 3)."""
    sides = []
    for it in range(n_queries - 1):
        p = _p_schedule(it, n_queries, p_init, rescale)
        s = max(int(round(math.sqrt(p * n_fts / c))), 3)
        if s % 2 == 0:
            s += 1
        sides.append(min(s, min(h, w)))
    return sides


def _placed(eta_c: torch.Tensor, vh: torch.Tensor, vw: torch.Tensor) -> torch.Tensor:
    """(n, 1, h, w): the canvas (pattern at its top-left) rolled to (vh, vw)
    per example."""
    h, w = eta_c.shape
    rows = (torch.arange(h, device=vh.device)[None, :] - vh[:, None]) % h
    cols = (torch.arange(w, device=vh.device)[None, :] - vw[:, None]) % w
    return eta_c[rows[:, :, None], cols[:, None, :]][:, None]


def _square_pair(gen, x, x_adv, idx, s, eta_np, c, reduce, budget):
    """The shared l2/l1 proposal: a fresh signed pattern in window 1, the
    norm of windows 1 and 2 (plus the unused budget) moved into window 1,
    window 2 cleared. `reduce(t, dims)` is the norm's per-window reduction;
    `budget(norms_image, norms_windows)` the mass window 1 may take."""
    n = idx.numel()
    _, _, h, w = x.shape
    dev, dt = x.device, x.dtype
    vh, vw = _randint(gen, h - s + 1, n, dev), _randint(gen, w - s + 1, n, dev)
    vh2, vw2 = _randint(gen, h - s + 1, n, dev), _randint(gen, w - s + 1, n, dev)
    sign = _rademacher(gen, (n, c, 1, 1), dt, dev)
    transpose = bool(torch.rand((), generator=gen, device=dev) < 0.5)
    eta_canvas = torch.zeros((h, w), dtype=dt, device=dev)
    eta_canvas[:s, :s] = torch.from_numpy(eta_np).to(device=dev, dtype=dt)
    eta_c = eta_canvas.T if transpose else eta_canvas

    xa = x[idx]
    m1 = _window_mask(vh, vw, s, h, w, dt)
    m2 = _window_mask(vh2, vw2, s, h, w, dt)
    delta_curr = x_adv[idx] - xa
    norms_w1 = reduce(delta_curr * m1, (2, 3))
    norms_image = reduce(delta_curr, (1, 2, 3))
    norms_windows = reduce(delta_curr * torch.maximum(m1, m2), (2, 3))
    new_d = _placed(eta_c, vh, vw) * sign + delta_curr * m1 / (norms_w1 + 1e-12)
    new_d = new_d * m1
    new_d = new_d / (reduce(new_d * m1, (2, 3)) + 1e-12) * budget(norms_image, norms_windows)
    delta_new = delta_curr * (1 - m2)
    return xa, delta_new * (1 - m1) + new_d * m1


def _l2n(t, dims):
    return torch.sqrt((t * t).sum(dim=dims, keepdim=True))


def _l1n(t, dims):
    return t.abs().sum(dim=dims, keepdim=True)


def square_attack_l2(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    eps: float,
    n_queries: int = 5000,
    p_init: float = 0.8,
    rng: Optional[int] = None,
    rescale_schedule: bool = True,
) -> SquareResult:
    """l2 Square Attack: bipolar eta squares with the norm budget moved
    between two windows, the whole delta renormalized to the eps sphere."""
    check_image_range(x)
    gen = generator(0 if rng is None else rng, x.device)
    b, c, h, w = x.shape
    n_fts = c * h * w

    def normalize_full(t):
        return t / (_l2n(t, (1, 2, 3)) + 1e-12)

    s0 = max(h // 5, 1)
    sp = (h - s0 * 5) // 2 if h >= 5 * s0 else 0
    delta = _tiled_init_delta(gen, b, c, h, w, s0, sp, _eta(s0), x.dtype, x.device)
    x_adv = torch.clamp(x + normalize_full(delta) * eps, 0.0, 1.0)
    sides = _l2_sides(n_queries, n_fts, c, h, w, p_init, rescale_schedule)

    def budget(norms_image, norms_windows):
        return torch.sqrt(torch.clamp(eps ** 2 - norms_image ** 2, min=0.0) / c + norms_windows ** 2)

    def propose(it, idx):
        s = sides[it]
        xa, delta_new = _square_pair(gen, x, x_adv, idx, s, _eta(s), c, _l2n, budget)
        return torch.clamp(xa + normalize_full(delta_new) * eps, 0.0, 1.0)

    return _search(logits_fn, x, y, x_adv, len(sides), propose)


def _eta_l1_rectangles(x: int, y: int) -> np.ndarray:
    """l1 ring pattern: 1/(counter+1)^4 rings, l1-normalized."""
    delta = np.zeros((x, y), np.float32)
    x_c, y_c = x // 2 + 1, y // 2 + 1
    c2 = [x_c - 1, y_c - 1]
    for counter in range(0, max(x_c, y_c)):
        delta[
            max(c2[0], 0): min(c2[0] + 2 * counter + 1, x),
            max(0, c2[1]): min(c2[1] + 2 * counter + 1, y),
        ] += 1.0 / (counter + 1) ** 4
        c2[0] -= 1
        c2[1] -= 1
    return delta / np.abs(delta).sum()


def _eta_l1(s: int) -> np.ndarray:
    delta = np.zeros((s, s), np.float32)
    delta[: s // 2] = _eta_l1_rectangles(s // 2, s)
    delta[s // 2:] = -_eta_l1_rectangles(s - s // 2, s)
    return delta / np.abs(delta).sum()


def square_attack_l1(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    eps: float,
    n_queries: int = 5000,
    p_init: float = 0.8,
    rng: Optional[int] = None,
    rescale_schedule: bool = True,
) -> SquareResult:
    """l1 Square Attack: bipolar l1 eta squares with the mass budget moved
    between two windows and the sorted-cumsum l1-ball projection."""
    check_image_range(x)
    gen = generator(0 if rng is None else rng, x.device)
    b, c, h, w = x.shape
    n_fts = c * h * w
    eps_eff = eps * (1.0 - 1e-6)

    s0 = max(h // 5, 1)
    sp = (h - s0 * 5) // 2 if h >= 5 * s0 else 0
    delta = _tiled_init_delta(gen, b, c, h, w, s0, sp, _eta_l1(s0), x.dtype, x.device)
    x_adv = x + delta + l1_ball_projection(x, delta, eps_eff)
    sides = _l2_sides(n_queries, n_fts, c, h, w, p_init, rescale_schedule)

    def budget(norms_image, norms_windows):
        return (torch.clamp(eps - norms_image, min=0.0) / c + norms_windows) * c

    def propose(it, idx):
        s = sides[it]
        xa, delta_new = _square_pair(gen, x, x_adv, idx, s, _eta_l1(s), c, _l1n, budget)
        return xa + delta_new + l1_ball_projection(xa, delta_new, eps_eff)

    return _search(logits_fn, x, y, x_adv, len(sides), propose)
