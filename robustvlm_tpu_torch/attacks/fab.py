"""FAB: Fast Adaptive Boundary attack (minimal norm), l-inf, l2 and l1.

Counterpart of `robustvlm_tpu/attacks/fab.py`. Per step: linearize the
decision boundary f_y - f_t at the iterate, project the iterate and the
clean point onto the linearized boundary intersected with the [0,1] box in
the attack norm, take the extrapolated convex combination (alpha_max 0.1,
eta 1.05), and after each adversarial hit step back toward x (beta 0.9),
keeping the smallest adversarial perturbation found. The projections are
the JAX version's monotone 40-step bisections, in the inputs' dtype
(float32 for an image). FAB-T attacks the top-k
alternative classes; untargeted FAB re-selects the closest boundary every
iteration.

Untargeted FAB needs the input gradient of f_y - f_k for every candidate
class k. JAX takes one `jax.jacrev`; the port repeats the batch once per
class in a chunk, runs one forward and takes one `autograd.grad` of the
summed differences (the rows of a batch are independent), over chunks of
at most `GRAD_ROWS` rows so memory stays bounded (no `torch.func`: the
attention kernels are `autograd.Function`s without vmap rules). Chunking
does not change the result.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from robustvlm_tpu_torch.attacks._validate import check_image_range
from robustvlm_tpu_torch.attacks.apgd import fold_in, generator
from robustvlm_tpu_torch.ops.kernels.attack_step import jnp_sign


class FABResult(NamedTuple):
    x_adv: torch.Tensor      # minimal-norm adversarial found (x where none)
    adv_found: torch.Tensor  # (B,) bool
    norms: torch.Tensor      # (B,) norm of the best perturbation (inf if none)


_BISECT_ITERS = 40
# rows (candidate classes x examples) of one untargeted-gradient chunk: 32
# ViT-L/14 images at 224 px keep a bf16 forward and backward within a few GiB
GRAD_ROWS = 32


def _flat(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape[0], -1)


def _norms(v: torch.Tensor, p: str) -> torch.Tensor:
    f = _flat(v)
    if p == "linf":
        return f.abs().amax(dim=1)
    if p == "l2":
        return torch.sqrt((f * f).sum(dim=1))
    return f.abs().sum(dim=1)


def _bisect(wz, b, lo, hi, feasible_hi: bool = True):
    """40 halvings of [lo, hi]. With `feasible_hi`, w.z(t) falls in t and
    hi keeps the side where w.z <= b; otherwise w.z rises in t and lo does."""
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        high = wz(mid) > b
        if feasible_hi:
            lo, hi = torch.where(high, mid, lo), torch.where(high, hi, mid)
        else:
            lo, hi = torch.where(high, lo, mid), torch.where(high, mid, hi)
    return lo, hi


def projection_hyperplane_box(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor, norm: str) -> torch.Tensor:
    """min ||z - u||_norm s.t. w.z <= b, 0 <= z <= 1, batched flat (B, D).
    Rows with w.u <= b come back as u."""
    def dot(a):
        return a.sum(dim=1)

    wu = dot(w * u)
    need = wu > b

    if norm == "linf":
        # z_i(t) = clip(u_i - t sign(w_i), 0, 1): w.z(t) falls in t; t <= 1 suffices
        sw = jnp_sign(w)

        def wz(t):
            return dot(w * torch.clamp(u - t[:, None] * sw, 0.0, 1.0))

        _, t = _bisect(wz, b, torch.zeros_like(b), torch.ones_like(b))
        z = torch.clamp(u - t[:, None] * sw, 0.0, 1.0)
    elif norm == "l2":
        # KKT: z(lam) = clip(u - lam w, 0, 1); every coordinate saturates by hi
        def wz(lam):
            return dot(w * torch.clamp(u - lam[:, None] * w, 0.0, 1.0))

        dist = torch.where(w > 0, u, 1.0 - u)
        aw = w.abs()
        lam_sat = torch.where(aw > 1e-12, dist / torch.clamp(aw, min=1e-12), torch.zeros_like(aw))
        _, lam = _bisect(wz, b, torch.zeros_like(b), lam_sat.amax(dim=1) + 1.0)
        z = torch.clamp(u - lam[:, None] * w, 0.0, 1.0)
    else:
        # l1: coordinates with |w_i| >= theta move fully to their
        # constraint-reducing box edge; w.z(theta) rises in theta
        d = torch.where(w > 0, u - 0.0, 1.0 - u)
        aw = w.abs()
        red = aw * d

        def wz(theta):
            return wu - dot(red * (aw >= theta[:, None]).to(u.dtype))

        theta, _ = _bisect(wz, b, torch.zeros_like(b), aw.amax(dim=1) + 1e-6, feasible_hi=False)
        move = (aw >= theta[:, None]).to(u.dtype)
        z_full = torch.where(w > 0, torch.zeros_like(u), torch.ones_like(u))
        z = u + move * (z_full - u)
        # theta is the feasible side: move the threshold coordinates back
        # toward u until w.z == b (frac clips to 0 when even the full move
        # cannot reach b)
        slack = dot(w * z) - b
        at_thr = ((aw - theta[:, None]).abs() < 1e-6).to(u.dtype)
        red_thr = dot(aw * d * at_thr) + 1e-12
        frac = torch.clamp(-slack / red_thr, 0.0, 1.0).to(u.dtype)
        z = z + frac[:, None] * at_thr * jnp_sign(w) * d
    return torch.where(need[:, None], z, u)


def fab_attack(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    norm: str = "linf",
    n_iter: int = 100,
    n_restarts: int = 1,
    eps: Optional[float] = None,
    alpha_max: float = 0.1,
    eta: float = 1.05,
    beta: float = 0.9,
    targeted: bool = False,
    n_target_classes: int = 9,
    n_boundary_classes: Optional[int] = None,
    rng: Optional[int] = None,
) -> FABResult:
    """Minimal-norm FAB. With `eps`, restarts after the first start from
    random points around x (radius eps/2, seeds `fold_in(rng, ti * 1000 +
    r)`) and `adv_found` means ||delta|| <= eps (the AutoAttack use);
    without, a pure minimal-norm search from x. With n_restarts=1 nothing
    is drawn. Untargeted mode picks the boundary class with the smallest
    |f| / ||w||_dual every iteration among the `n_boundary_classes` classes
    with the highest clean logits (default: all but y); its per-class
    gradients run `GRAD_ROWS` rows (classes x examples) at a time."""
    check_image_range(x)
    rng = 0 if rng is None else rng
    b = x.shape[0]
    tail = (-1,) + (1,) * (x.dim() - 1)

    with torch.no_grad():
        logits0 = logits_fn(x)
    n_cls = logits0.shape[-1]
    order = torch.argsort(logits0, dim=-1, stable=True)

    def dual_norm(wf):
        if norm == "linf":
            return wf.abs().sum(dim=-1)
        if norm == "l2":
            return torch.sqrt((wf * wf).sum(dim=-1))
        return wf.abs().amax(dim=-1)

    # candidate boundary classes: every class but y, by clean logit, descending
    m = min(n_boundary_classes or (n_cls - 1), n_cls - 1)
    desc = order.flip(1)
    key = torch.where(desc != y[:, None], torch.arange(n_cls, device=x.device)[None, :], n_cls)
    cand = desc.gather(1, torch.argsort(key, dim=1, stable=True))[:, :m]

    def select_boundary(u):
        """(f_y - f_k*, its gradient) at the closest linearized boundary."""
        per = max(1, GRAD_ROWS // b)  # classes a chunk
        diffs, grads = [], []
        for k0 in range(0, m, per):
            kc = cand[:, k0:k0 + per]                      # (B, mc)
            mc = kc.shape[1]
            ur = u.detach().repeat(mc, *([1] * (u.dim() - 1))).requires_grad_(True)
            with torch.enable_grad():
                lg = logits_fn(ur)                         # (mc*B, C), class-major
                fy = lg.gather(1, y.repeat(mc)[:, None])[:, 0]
                fk = lg.gather(1, kc.T.reshape(-1)[:, None])[:, 0]
                diff = fy - fk
                (g,) = torch.autograd.grad(diff.sum(), ur)
            diffs.append(diff.detach().reshape(mc, b).T)
            grads.append(g.reshape(mc, b, -1).transpose(0, 1))
        diff_all = torch.cat(diffs, dim=1)                 # (B, m)
        w_all = torch.cat(grads, dim=1)                    # (B, m, D)
        dist = diff_all.abs() / (1e-12 + dual_norm(w_all))
        k_star = torch.argmin(dist, dim=1)
        diff = diff_all.gather(1, k_star[:, None])[:, 0]
        w = w_all[torch.arange(b, device=x.device), k_star]
        return diff, w.reshape(x.shape)

    def boundary_fn(t_idx):
        """f_y - f_t for a fixed class per example, and its gradient."""
        def value_and_grad(u):
            ug = u.detach().requires_grad_(True)
            with torch.enable_grad():
                lg = logits_fn(ug)
                diff = lg.gather(1, y[:, None])[:, 0] - lg.gather(1, t_idx[:, None])[:, 0]
                (g,) = torch.autograd.grad(diff.sum(), ug)
            return diff.detach(), g
        return value_and_grad

    xf = _flat(x)

    def single_run(t_idx, x0):
        vg = boundary_fn(t_idx) if t_idx is not None else select_boundary
        u = x0
        best = torch.zeros_like(x)
        best_norm = torch.full((b,), float("inf"), dtype=torch.float32, device=x.device)
        found = torch.zeros((b,), dtype=torch.bool, device=x.device)
        for _ in range(n_iter):
            diff, grad = vg(u)
            with torch.no_grad():
                w = _flat(grad)
                uf = _flat(u)
                bb = (w * uf).sum(dim=1) - diff            # hyperplane offset
                du = projection_hyperplane_box(uf, w, bb, norm) - uf
                dx = projection_hyperplane_box(xf, w, bb, norm) - xf
                nu = _norms(du, norm)
                nx = _norms(dx, norm)
                alpha = torch.clamp(nu / (nu + nx + 1e-12), 0.0, alpha_max)[:, None]
                u_new = torch.clamp((1 - alpha) * (uf + eta * du) + alpha * (xf + eta * dx),
                                    0.0, 1.0).reshape(x.shape)
                is_adv = logits_fn(u_new).argmax(dim=-1) != y
                pert_norm = _norms(u_new - x, norm)
                improved = is_adv & (pert_norm < best_norm)
                best = torch.where(improved.reshape(tail), u_new, best)
                best_norm = torch.where(improved, pert_norm, best_norm)
                found = found | is_adv
                u = torch.where(is_adv.reshape(tail),
                                torch.clamp(beta * u_new + (1 - beta) * x, 0.0, 1.0), u_new)
        return best, best_norm, found

    targets = ([order[:, -(k + 2)] for k in range(n_target_classes)] if targeted else [None])
    best = torch.zeros_like(x)
    best_norm = torch.full((b,), float("inf"), dtype=torch.float32, device=x.device)
    found = torch.zeros((b,), dtype=torch.bool, device=x.device)
    for ti, t_idx in enumerate(targets):
        for r in range(n_restarts):
            if r == 0:
                x0 = x
            else:
                noise = 2.0 * torch.rand(x.shape, generator=generator(fold_in(rng, ti * 1000 + r), x.device),
                                         device=x.device, dtype=x.dtype) - 1.0
                rad = eps if eps is not None else 0.1
                if norm == "linf":
                    x0 = torch.clamp(x + 0.5 * rad * noise, 0.0, 1.0)
                else:
                    nn_ = _norms(noise, norm).reshape(tail)
                    x0 = torch.clamp(x + 0.5 * rad * noise / (nn_ + 1e-12), 0.0, 1.0)
            bi, ni, fi = single_run(t_idx, x0)
            improved = fi & (ni < best_norm)
            best = torch.where(improved.reshape(tail), bi, best)
            best_norm = torch.where(improved, ni, best_norm)
            found = found | fi

    if eps is not None:
        within = found & (best_norm <= eps + 1e-6)
        return FABResult(x_adv=torch.where(within.reshape(tail), best, x), adv_found=within, norms=best_norm)
    return FABResult(x_adv=torch.where(found.reshape(tail), best, x), adv_found=found, norms=best_norm)
