"""The ConvNeXt CLIP vision tower (open_clip `convnext_base_w` family) as
PyTorch modules.

Counterpart of `robustvlm_tpu/models/clip/convnext.py`: stem (4x4 stride 4
conv and LayerNorm), four stages (LayerNorm and a 2x2 stride 2 conv before
stages 1-3; blocks of 7x7 depthwise conv, LayerNorm, fc1, exact-erf GELU,
fc2, layer scale, residual), global average pool, head LayerNorm and
linear projection. LayerNorm keeps float32 statistics (eps 1e-6) whatever
the activation dtype; weights are cast to it at use.

Parameters keep the JAX package's names and layouts, so a JAX tree
carries across by name (`convert.params_from_jax`): convolutions HWIO
(depthwise (k, k, 1, C)), linear weights (in, out). The activations are
channels-last (N, H, W, C) as in JAX; each convolution reads them as an
NCHW view in channels-last memory (`F.conv2d`, cuDNN on the card). The
tower reaches no kernel of the port: it has no attention.

A block split over the mesh's `model` axis (`parallel/mesh.shard_params`
sets its `tp`) holds this rank's columns of fc1 (and of its bias) and rows
of fc2; fc2's bias is added once, after the sum over `model`, and the layer
scale after that (`parallel/tensor_parallel.py`). The convolutions, the
LayerNorms and the layer scale stay whole.

`import_convnext_state_dict` / `export_convnext_state_dict` read and write
the open_clip TimmModel layout:
  trunk.stem.0 (conv) + trunk.stem.1 (LayerNorm2d)
  trunk.stages.{s}.downsample.{0: LayerNorm2d, 1: conv}   (s >= 1)
  trunk.stages.{s}.blocks.{i}.{conv_dw, norm, mlp.fc1, mlp.fc2, gamma}
  trunk.head.norm (after the pool)     head.proj (Linear -> embed_dim)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from robustvlm_tpu_torch.parallel.tensor_parallel import column_parallel, local, row_parallel


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    depths: Tuple[int, ...] = (3, 3, 27, 3)
    dims: Tuple[int, ...] = (128, 256, 512, 1024)
    patch_size: int = 4          # stem conv kernel == stride
    kernel_size: int = 7         # depthwise conv
    mlp_ratio: int = 4
    ln_eps: float = 1e-6


def _layer_norm(x, g, b, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


def _conv(x, w, b, stride: int, groups: int = 1, padding: int = 0):
    """(N, H, W, C) x HWIO weight -> (N, H', W', O)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1), b.to(x.dtype),
                 stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape))


class Stem(nn.Module):
    def __init__(self, cfg: ConvNeXtConfig):
        super().__init__()
        p, d0 = cfg.patch_size, cfg.dims[0]
        self.w, self.b = _param(p, p, 3, d0), _param(d0)
        self.norm_g, self.norm_b = _param(d0), _param(d0)


class ConvNeXtBlock(nn.Module):
    tp = None  # parallel.tensor_parallel.TensorParallel when split over `model`

    def __init__(self, dim: int, cfg: ConvNeXtConfig):
        super().__init__()
        k, hid = cfg.kernel_size, cfg.mlp_ratio * dim
        self.dw_w, self.dw_b = _param(k, k, 1, dim), _param(dim)
        self.norm_g, self.norm_b = _param(dim), _param(dim)
        self.fc1_w, self.fc1_b = _param(dim, hid), _param(hid)
        self.fc2_w, self.fc2_b = _param(hid, dim), _param(dim)
        self.gamma = _param(dim)
        self.k, self.eps = k, cfg.ln_eps

    def tp_layout(self, m: int):
        """fc1's columns (with its bias) and fc2's rows over a `model` axis
        of m, or None when m does not divide the hidden width."""
        return None if self.fc1_w.shape[1] % m else {"fc1_w": (1, 1), "fc1_b": (0, 1), "fc2_w": (0, 1)}

    def forward(self, x):
        cd, tp = x.dtype, self.tp
        h = _conv(x, self.dw_w, self.dw_b, 1, groups=x.shape[-1], padding=self.k // 2)
        h = _layer_norm(h, self.norm_g, self.norm_b, self.eps)
        if tp:
            h = F.gelu(column_parallel(h, local(self.fc1_w).to(cd), tp) + local(self.fc1_b).to(cd))
            h = row_parallel(h, local(self.fc2_w).to(cd), tp) + self.fc2_b.to(cd)
        else:
            h = F.gelu(h @ self.fc1_w.to(cd) + self.fc1_b.to(cd))  # exact (erf) GELU
            h = h @ self.fc2_w.to(cd) + self.fc2_b.to(cd)
        return x + self.gamma.to(cd) * h


class Stage(nn.Module):
    def __init__(self, s: int, cfg: ConvNeXtConfig):
        super().__init__()
        dim = cfg.dims[s]
        if s > 0:
            prev = cfg.dims[s - 1]
            self.ds_norm_g, self.ds_norm_b = _param(prev), _param(prev)
            self.ds_w, self.ds_b = _param(2, 2, prev, dim), _param(dim)
        self.blocks = nn.ModuleList(ConvNeXtBlock(dim, cfg) for _ in range(cfg.depths[s]))


class Head(nn.Module):
    def __init__(self, dim: int, embed_dim: int):
        super().__init__()
        self.norm_g, self.norm_b = _param(dim), _param(dim)
        self.proj_w, self.proj_b = _param(dim, embed_dim), _param(embed_dim)


class ConvNeXtTower(nn.Module):
    """(B, 3, H, W) normalized pixels -> (B, embed_dim) float32 embedding."""

    def __init__(self, cfg: ConvNeXtConfig, embed_dim: int):
        super().__init__()
        self.cfg = cfg
        self.stem = Stem(cfg)
        self.stages = nn.ModuleList(Stage(s, cfg) for s in range(len(cfg.depths)))
        self.head = Head(cfg.dims[-1], embed_dim)

    def forward(self, x, *, compute_dtype=torch.float32, tokens=False, n_skip_last=0, remat=False):
        if tokens or n_skip_last:
            raise ValueError("tokens/n_skip_last are ViT-tower features")
        cfg, eps = self.cfg, self.cfg.ln_eps
        x = x.to(compute_dtype).permute(0, 2, 3, 1)  # NCHW -> NHWC
        st = self.stem
        x = _layer_norm(_conv(x, st.w, st.b, cfg.patch_size), st.norm_g, st.norm_b, eps)
        for s, stage in enumerate(self.stages):
            if s > 0:
                x = _conv(_layer_norm(x, stage.ds_norm_g, stage.ds_norm_b, eps), stage.ds_w, stage.ds_b, 2)
            for blk in stage.blocks:
                if remat and torch.is_grad_enabled():
                    x = torch.utils.checkpoint.checkpoint(blk, x, use_reentrant=False)
                else:
                    x = blk(x)
        x = x.mean(dim=(1, 2))  # global average pool -> (B, C)
        hd = self.head
        x = _layer_norm(x, hd.norm_g, hd.norm_b, eps)
        return (x @ hd.proj_w.to(x.dtype) + hd.proj_b.to(x.dtype)).float()

    @torch.no_grad()
    def init_random_(self, gen: torch.Generator) -> "ConvNeXtTower":
        """The JAX `init_convnext_params` scheme (not its numbers): weights
        normal / sqrt(fan in), biases 0, LayerNorm gains 1, layer scale 1e-6."""
        for name, prm in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("norm_g", "ds_norm_g"):
                prm.fill_(1.0)
            elif leaf == "gamma":
                prm.fill_(1e-6)
            elif prm.dim() == 1:
                prm.zero_()
            else:
                fan_in = int(np.prod(prm.shape[:-1]))
                prm.copy_(torch.randn(prm.shape, generator=gen, device=prm.device) * fan_in ** -0.5)
        return self


# ------------------------------------------------------------ torch interop
def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.asarray(v, dtype=np.float32)


def _conv_in(a: np.ndarray) -> np.ndarray:
    return np.transpose(a, (2, 3, 1, 0))  # torch (O, I, H, W) -> HWIO


def _conv_out(a: np.ndarray) -> np.ndarray:
    return np.transpose(a, (3, 2, 0, 1))  # HWIO -> torch (O, I, H, W)


def import_convnext_state_dict(sd: Mapping[str, Any], cfg: ConvNeXtConfig, prefix: str = "",
                               out_prefix: str = "visual.") -> Dict[str, torch.Tensor]:
    """An open_clip TimmModel visual state dict -> the port's `visual.*`
    entries (convolutions to HWIO, linear weights to (in, out))."""
    from robustvlm_tpu_torch.models.clip.convert import _t

    g = lambda k: _np(sd[prefix + k])  # noqa: E731
    o = out_prefix
    out = {
        o + "stem.w": _t(_conv_in(g("trunk.stem.0.weight"))),
        o + "stem.b": _t(g("trunk.stem.0.bias")),
        o + "stem.norm_g": _t(g("trunk.stem.1.weight")),
        o + "stem.norm_b": _t(g("trunk.stem.1.bias")),
    }
    for s, depth in enumerate(cfg.depths):
        st, os_ = f"trunk.stages.{s}.", f"{o}stages.{s}."
        if s > 0:
            out[os_ + "ds_norm_g"] = _t(g(st + "downsample.0.weight"))
            out[os_ + "ds_norm_b"] = _t(g(st + "downsample.0.bias"))
            out[os_ + "ds_w"] = _t(_conv_in(g(st + "downsample.1.weight")))
            out[os_ + "ds_b"] = _t(g(st + "downsample.1.bias"))
        for i in range(depth):
            b, ob = f"{st}blocks.{i}.", f"{os_}blocks.{i}."
            out[ob + "dw_w"] = _t(_conv_in(g(b + "conv_dw.weight")))
            out[ob + "dw_b"] = _t(g(b + "conv_dw.bias"))
            out[ob + "norm_g"] = _t(g(b + "norm.weight"))
            out[ob + "norm_b"] = _t(g(b + "norm.bias"))
            out[ob + "fc1_w"] = _t(g(b + "mlp.fc1.weight"), True)
            out[ob + "fc1_b"] = _t(g(b + "mlp.fc1.bias"))
            out[ob + "fc2_w"] = _t(g(b + "mlp.fc2.weight"), True)
            out[ob + "fc2_b"] = _t(g(b + "mlp.fc2.bias"))
            out[ob + "gamma"] = _t(g(b + "gamma"))
    out.update({
        o + "head.norm_g": _t(g("trunk.head.norm.weight")),
        o + "head.norm_b": _t(g("trunk.head.norm.bias")),
        o + "head.proj_w": _t(g("head.proj.weight"), True),
        o + "head.proj_b": _t(g("head.proj.bias")),
    })
    return out


def export_convnext_state_dict(sd: Mapping[str, torch.Tensor], cfg: ConvNeXtConfig,
                               prefix: str = "visual.") -> Dict[str, np.ndarray]:
    """The port's `visual.*` entries -> an open_clip TimmModel visual state
    dict (float32 numpy), the inverse of `import_convnext_state_dict`."""
    g = lambda k: _np(sd[prefix + k])  # noqa: E731
    out = {
        "trunk.stem.0.weight": _conv_out(g("stem.w")),
        "trunk.stem.0.bias": g("stem.b"),
        "trunk.stem.1.weight": g("stem.norm_g"),
        "trunk.stem.1.bias": g("stem.norm_b"),
    }
    for s, depth in enumerate(cfg.depths):
        st, ps = f"trunk.stages.{s}.", f"stages.{s}."
        if s > 0:
            out[st + "downsample.0.weight"] = g(ps + "ds_norm_g")
            out[st + "downsample.0.bias"] = g(ps + "ds_norm_b")
            out[st + "downsample.1.weight"] = _conv_out(g(ps + "ds_w"))
            out[st + "downsample.1.bias"] = g(ps + "ds_b")
        for i in range(depth):
            b, pb = f"{st}blocks.{i}.", f"{ps}blocks.{i}."
            out[b + "conv_dw.weight"] = _conv_out(g(pb + "dw_w"))
            out[b + "conv_dw.bias"] = g(pb + "dw_b")
            out[b + "norm.weight"] = g(pb + "norm_g")
            out[b + "norm.bias"] = g(pb + "norm_b")
            out[b + "mlp.fc1.weight"] = g(pb + "fc1_w").T
            out[b + "mlp.fc1.bias"] = g(pb + "fc1_b")
            out[b + "mlp.fc2.weight"] = g(pb + "fc2_w").T
            out[b + "mlp.fc2.bias"] = g(pb + "fc2_b")
            out[b + "gamma"] = g(pb + "gamma")
    out.update({
        "trunk.head.norm.weight": g("head.norm_g"),
        "trunk.head.norm.bias": g("head.norm_b"),
        "head.proj.weight": g("head.proj_w").T,
        "head.proj.bias": g("head.proj_b"),
    })
    return {k: np.ascontiguousarray(v) for k, v in out.items()}
