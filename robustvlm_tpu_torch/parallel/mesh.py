"""Device mesh and parameter sharding over `torch.distributed`.

Counterpart of `robustvlm_tpu/parallel/mesh.py`, with its names:

- mesh axes ("data", "fsdp", "model") over the initialized process group,
  `model` innermost (rank = (d * fsdp + f) * model + m, JAX's row-major
  device order);
  * data  - each rank holds its own rows of the batch;
  * fsdp  - parameters sharded at rest and gathered on use (FSDP2's
    `fully_shard`); fsdp doubles as a second batch axis;
  * model - Megatron tensor parallelism (`tensor_parallel.py`) in every
    family: the CLIP ViT and ConvNeXt towers and the CLIP text tower; LLaVA
    with a LLaMA or an MPT LM (tower, projector, blocks, LLaMA's LM head);
    OpenFlamingo (tower, Perceiver, gated cross-attention, MPT); BLIP-2
    (EVA tower, Q-Former, language projection, OPT and its LM head); the
    BERT/XLM-R text towers and their MLP projection. A split module holds
    and computes on this rank's heads and ffn columns; ranks that differ
    only in `model` hold the same rows of the batch. A module that m does
    not divide stays whole (below).
- `_RULES` are JAX's decisions written on the port's parameter names (the
  blocks are `nn.ModuleList` entries, `visual.blocks.3.attn.qkv_w`, so the
  per-layer case of `_spec_for`, where a rule's leading layer axis drops,
  is the port's case). `param_sharding_rules` is a pure function of the
  parameters' names and shapes and the mesh's shape.
- `shard_params` on a mesh with `model` > 1: each module that can split
  (`tp_layout(m)` names its parameters' split dims when m divides its
  heads, kv heads and ffn width) gets this rank's share of those parameters
  as DTensors on the `model` sub-mesh (`Shard(dim)`; the fused [q|k|v]
  columns `_StridedShard(1, split_factor=3)` and [k|v] columns
  `_StridedShard(1, split_factor=2)`, so that each rank holds the columns
  of its own heads and the global view is the unsplit layout) and `tp`
  set. Then FSDP2 (`fully_shard` on the
  `fsdp` sub-mesh, or on ("data", "fsdp") for HSDP) on every block and the
  root shards the dim JAX's spec gives `fsdp`; a parameter whose spec names
  no `fsdp` dim (JAX's replicated LayerNorms and biases, and the
  column-parallel biases) is left out of FSDP (`ignored_params`) and stays
  whole on the `fsdp` axis. So every rank holds JAX's bytes for every
  parameter at the same mesh shape. FSDP2 takes a non-zero shard dim beside
  a TP shard (the out and down projections: TP on the rows, FSDP on the
  columns, JAX's own dims). A block that m does not divide (heads, kv heads
  or ffn width; a quantized block) stays whole on every rank and takes the
  flattened placement below, with JAX's replicated parameters left whole;
  so does any other module with a forward of its own whose `tp_layout` is
  None (a Perceiver or Q-Former attention of too few heads), as an FSDP
  unit of its own. `state_dict()` of a split model is the unsplit layout,
  in plain tensors (every DTensor gathered, fused [q|k|v] and [k|v] columns
  in their order): a checkpoint or an export of it loads into an unsplit
  model. A split model loads no state.
- `shard_params` on a mesh with `model` = 1 (or a root without
  `tensor_parallel_ok`) applies `fully_shard` to every block (a module of
  an `nn.ModuleList` with its own `forward`) and then to the root, on the
  2-D mesh (data, fsdp x model): replicated over `data`, each parameter sharded over the flattened
  pair on the dim JAX gives `fsdp` (else `model`) when the pair divides it,
  else on FSDP2's default dim 0. Scalars, which FSDP2 cannot shard and JAX
  replicates, stay replicated tensors.
- FSDP2 gathers a module's parameters only around its own `forward`. The
  root's parameters (embeddings, LM heads, towers' stems and projections)
  are read by free functions, so a sharded model's computations run through
  `sharded_call(model, fn, ...)`: `fn` runs inside the root's forward
  hooks, which gather the root's parameters for the call and its backward.
  The eval adapters and the trainer do so; on an unsharded model it is a
  plain call.

Without a process group the mesh is one device and every function is the
identity; nothing here starts a process group.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.utils._pytree import tree_flatten, tree_map

from robustvlm_tpu_torch.device import resolve_device
from robustvlm_tpu_torch.parallel.tensor_parallel import TensorParallel, full_value, head_columns

AXES = ("data", "fsdp", "model")

# gradient all-reduces issued (the smoke's parallel phase checks one a
# training step)
COLLECTIVES: Dict[str, int] = {"grad_all_reduce": 0}

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ("data", "fsdp", "model") mesh. `shape` maps axis -> size, as JAX's
    `Mesh.shape`; `coords` is this rank's index on each axis. Without a
    process group `device_mesh` is None and the mesh is one device."""

    shape: Dict[str, int]
    coords: Tuple[int, int, int]
    device: torch.device
    device_mesh: Any = None   # the 3-D DeviceMesh
    shard_mesh: Any = None    # (data, fsdp x model) DeviceMesh for fully_shard
    batch_group: Any = None   # ranks of this rank's `model` index: its batch peers

    @property
    def fsdp_mesh(self):
        """The sub-mesh FSDP2 shards a split model over: ("data", "fsdp")
        (HSDP) when data > 1, else "fsdp"."""
        dm = self.device_mesh
        return dm["data", "fsdp"] if self.shape["data"] > 1 else dm["fsdp"]

    @property
    def tp(self) -> Optional[TensorParallel]:
        """This rank's `model` group, None when `model` = 1 or without a
        process group."""
        if not self.distributed or self.shape["model"] == 1:
            return None
        return TensorParallel(self.device_mesh["model"].get_group(), self.shape["model"], self.coords[2])

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    @property
    def batch_shards(self) -> int:
        """How many ways the batch splits: data x fsdp."""
        return self.shape["data"] * self.shape["fsdp"]

    @property
    def batch_index(self) -> int:
        """This rank's shard of the batch, data-major then fsdp."""
        return self.coords[0] * self.shape["fsdp"] + self.coords[1]


def make_mesh(data: int = -1, fsdp: int = 1, model: int = 1, device=None) -> Mesh:
    """A ("data", "fsdp", "model") mesh over the initialized process group;
    data=-1 takes the rest of the world. Raises ValueError when the axes do
    not multiply to the world size. Without a process group: one device.
    `device` is the port's device (`cuda` by default, `cpu` when asked)."""
    dev = resolve_device(device)
    grouped = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if grouped else 1
    if data == -1:
        data = n // (fsdp * model)
    if data * fsdp * model != n or min(data, fsdp, model) < 1:
        raise ValueError(f"mesh {data}x{fsdp}x{model} != {n} devices")
    shape = {"data": data, "fsdp": fsdp, "model": model}
    if not grouped:
        return Mesh(shape, (0, 0, 0), dev)
    from torch.distributed.device_mesh import init_device_mesh

    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    coords = (rank // (fsdp * model), (rank // model) % fsdp, rank % model)
    mesh3 = init_device_mesh(dev.type, (data, fsdp, model), mesh_dim_names=AXES)
    if data > 1:
        shard = init_device_mesh(dev.type, (data, fsdp * model), mesh_dim_names=("data", "shard"))
    else:
        shard = init_device_mesh(dev.type, (fsdp * model,), mesh_dim_names=("shard",))
    # every rank creates every batch group, in one order (new_group is collective)
    batch_group = None
    for m in range(model):
        ranks = [(d * fsdp + f) * model + m for d in range(data) for f in range(fsdp)]
        g = dist.new_group(ranks) if model > 1 else dist.group.WORLD
        if m == coords[2]:
            batch_group = g
    return Mesh(shape, coords, dev, mesh3, shard, batch_group)


# ------------------------------------------------------------------ batch
def batch_slice(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous rows of an n-row global batch over ("data",
    "fsdp"); ranks that differ only in `model` get the same rows."""
    k = mesh.batch_shards
    if n % k:
        raise ValueError(f"batch of {n} rows does not split over {k} (data x fsdp) shards")
    r = n // k
    return slice(mesh.batch_index * r, (mesh.batch_index + 1) * r)


def batch_sharding(mesh: Mesh, x: torch.Tensor, chunks: int = 1) -> torch.Tensor:
    """This rank's rows of the global batch `x` (the leading axis sharded
    over ("data", "fsdp"), data-major). With `chunks` > 1 the batch is
    `chunks` equal chunks (gradient accumulation) and the rank takes its
    rows of each, chunk after chunk: its i-th local chunk is its share of
    the global i-th chunk, as a sharded batch reshaped into chunks is."""
    n = x.shape[0]
    if n % chunks:
        raise ValueError(f"batch of {n} rows is not {chunks} equal chunks")
    if chunks == 1:
        return x[batch_slice(mesh, n)]
    c = n // chunks
    s = batch_slice(mesh, c)
    return x.reshape(chunks, c, *x.shape[1:])[:, s].reshape(-1, *x.shape[1:])


def gather_batch(tree, mesh: Mesh):
    """Every rank's rows of each tensor of `tree` (a tensor or a pytree;
    tensors of one or more dims carry the batch on axis 0), all-gathered
    over the batch peers in batch order: every rank holds the whole
    result. The identity without a process group."""
    if not mesh.distributed:
        return tree

    def gather(t):
        if not torch.is_tensor(t) or t.dim() == 0:
            return t
        parts = [torch.empty_like(t) for _ in range(mesh.batch_shards)]
        dist.all_gather(parts, t.contiguous(), group=mesh.batch_group)
        return torch.cat(parts, dim=0)

    return tree_map(gather, tree)


def all_reduce_grads_(params: Iterable[nn.Parameter], mesh: Mesh) -> None:
    """One mean all-reduce of the parameters' gradients over the batch
    peers: every gradient (zeros where a parameter has none) in one flat
    float32 buffer, the sum divided by the peer count, written back in each
    gradient's dtype. What replicated parameters with a sharded batch
    compute. FSDP-sharded parameters (DTensors on a mesh with an `fsdp`
    axis) are left to FSDP's own reduce-scatter; a split parameter outside
    FSDP (a DTensor on the `model` sub-mesh alone) is reduced here, its
    local shard with the peers' same shard. Skipped without a process
    group."""
    if not mesh.distributed:
        return
    from torch.distributed.tensor import DTensor

    plain = [p for p in params if not isinstance(p, DTensor) or p.device_mesh.mesh_dim_names == ("model",)]
    if not plain:
        return
    for p in plain:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad._local_tensor if isinstance(p.grad, DTensor) else p.grad for p in plain]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=mesh.batch_group)
    COLLECTIVES["grad_all_reduce"] += 1
    flat /= mesh.batch_shards
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n


def batch_mean(values: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Scalar metrics, each the mean over this rank's rows, as means over
    the global batch (equal rows a rank): one all-reduce of the stacked
    values. The identity without a process group."""
    if not mesh.distributed or not values:
        return dict(values)
    keys = list(values)
    stacked = torch.stack([torch.as_tensor(values[k], dtype=torch.float32, device=mesh.device).reshape(())
                           for k in keys])
    dist.all_reduce(stacked, group=mesh.batch_group)
    stacked /= mesh.batch_shards
    return {k: stacked[i] for i, k in enumerate(keys)}


# ------------------------------------------------------------------ rules
# JAX's table (robustvlm_tpu/parallel/mesh.py `_RULES`) on the port's names:
# the same specs, `/` written as `.`, the per-layer index of an
# `nn.ModuleList` between a stack's name and its leaf, and BLIP-2's grouped
# Q-Former (`groups/self|cross|ffn`) unrolled into `qformer.layers.<i>.
# self_attn|cross|ffn`. Specs anchor to the trailing dims (`_spec_for`).
_RULES: Tuple[Tuple[str, Spec], ...] = (
    # --- CLIP ViT / text tower ---
    (r".*blocks.*attn.*qkv_w$", (None, "fsdp", "model")),
    (r".*blocks.*attn.*qkv_b$", (None, "model")),
    (r".*blocks.*attn.*out_w$", (None, "model", "fsdp")),
    (r".*blocks.*attn.*out_b$", (None,)),
    (r".*blocks.*mlp.*fc_w$", (None, "fsdp", "model")),
    (r".*blocks.*mlp.*fc_b$", (None, "model")),
    (r".*blocks.*mlp.*proj_w$", (None, "model", "fsdp")),
    (r".*blocks.*mlp.*proj_b$", (None,)),
    # --- LLaMA ---
    (r".*blocks.*attn.*w[qkv]$", (None, "fsdp", "model")),
    (r".*blocks.*attn.*wo$", (None, "model", "fsdp")),
    (r".*blocks.*mlp.*w_(gate|up)$", (None, "fsdp", "model")),
    (r".*blocks.*mlp.*w_down$", (None, "model", "fsdp")),
    # --- MPT (out_w matched above) ---
    (r".*blocks.*attn.*wqkv$", (None, "fsdp", "model")),
    (r".*blocks.*mlp.*up_w$", (None, "fsdp", "model")),
    (r".*blocks.*mlp.*down_w$", (None, "model", "fsdp")),
    # --- Flamingo perceiver resampler + gated cross-attention ---
    (r".*to_(q|kv)$", (None, "fsdp", "model")),
    (r".*to_out$", (None, "model", "fsdp")),
    (r".*ff\.w1$", (None, "fsdp", "model")),
    (r".*ff\.w2$", (None, "model", "fsdp")),
    # --- LLaVA mm-projector ---
    (r".*projector\.w1$", ("fsdp", "model")),
    (r".*projector\.w2$", ("model", "fsdp")),
    # --- OPT decoder ---
    (r".*blocks.*mlp.*fc1$", (None, "fsdp", "model")),
    (r".*blocks.*mlp.*b1$", (None, "model")),
    (r".*blocks.*mlp.*fc2$", (None, "model", "fsdp")),
    # --- BLIP-2 Q-Former (JAX's groups, unrolled) ---
    (r".*qformer\.layers\.\d+\.(self_attn|cross)\.[qkv]_w$", ("fsdp", "model")),
    (r".*qformer\.layers\.\d+\.(self_attn|cross)\.out_w$", ("model", "fsdp")),
    (r".*qformer\.layers\.\d+\.ffn\.fc_w$", ("fsdp", "model")),
    (r".*qformer\.layers\.\d+\.ffn\.proj_w$", ("model", "fsdp")),
    (r".*language_projection\.w$", ("fsdp", "model")),
    # --- ConvNeXt tower: the 4x channel MLP ---
    (r".*stages.*blocks.*fc1_w$", (None, "fsdp", "model")),
    (r".*stages.*blocks.*fc1_b$", (None, "model")),
    (r".*stages.*blocks.*fc2_w$", (None, "model", "fsdp")),
    # --- BERT/XLM-R text towers (ja_clip, mclip) ---
    (r".*blocks\.\d+\.[qkv]_w$", (None, "fsdp", "model")),
    (r".*blocks\.\d+\.[qkv]_b$", (None, "model")),
    (r".*blocks\.\d+\.o_w$", (None, "model", "fsdp")),
    (r".*blocks\.\d+\.ff1_w$", (None, "fsdp", "model")),
    (r".*blocks\.\d+\.ff1_b$", (None, "model")),
    (r".*blocks\.\d+\.ff2_w$", (None, "model", "fsdp")),
    (r".*word_emb$", ("fsdp", None)),
    (r".*text_projection\.fc_w$", ("fsdp", "model")),
    (r".*text_projection\.out_w$", ("model", "fsdp")),
    # --- embeddings / heads ---
    (r".*patch_embed$", ("fsdp", None)),
    (r".*tok(en)?_embedding$", ("fsdp", None)),
    (r".*lm_head$", ("fsdp", "model")),
    (r".*positional_embedding$", (None,)),
    (r".*(proj|text_projection)$", ("fsdp", None)),
)


def _spec_for(name: str, ndim: int) -> Spec:
    """The rule's spec anchored to the parameter's trailing dims: extra
    leading dims stay unsharded, and a per-layer parameter drops the rule's
    leading entries (which must be None). No rule: replicated."""
    for pat, spec in _RULES:
        if re.match(pat, name):
            if ndim > len(spec):
                return (None,) * (ndim - len(spec)) + spec
            dropped = spec[: len(spec) - ndim]
            if any(d is not None for d in dropped):
                raise ValueError(f"sharding rule {spec} for {name!r} names axes beyond "
                                 f"the parameter's {ndim} dims")
            return spec[len(spec) - ndim:]
    return (None,) * ndim


def _mesh_shape(mesh: Union[Mesh, Mapping[str, int]]) -> Mapping[str, int]:
    return mesh.shape if isinstance(mesh, Mesh) else mesh


def _fit_spec(spec: Spec, shape: Sequence[int], mesh_shape: Mapping[str, int]) -> Spec:
    """Drop the axes that do not divide their dim (JAX's `_fit_spec`):
    ViT-L/14's (588, 1024) patch embedding on an 8-way fsdp axis replicates
    that dim instead of failing the placement."""
    return tuple(a if a is None or shape[i] % mesh_shape[a] == 0 else None for i, a in enumerate(spec))


def param_spec(name: str, shape: Sequence[int], mesh: Union[Mesh, Mapping[str, int]]) -> Spec:
    """JAX's PartitionSpec for one parameter, one entry a dim (None:
    unsharded on that dim). A pure function of the name, the shape and the
    mesh's axis sizes."""
    return _fit_spec(_spec_for(name, len(shape)), tuple(shape), _mesh_shape(mesh))


def param_sharding_rules(model: Union[nn.Module, Iterable[Tuple[str, Any]]],
                         mesh: Union[Mesh, Mapping[str, int]]) -> Dict[str, Spec]:
    """{parameter name: its spec} for a module (or (name, tensor or shape)
    pairs), on a mesh or a mesh shape ({"data": d, "fsdp": f, "model": m});
    needs no process group (a model on the meta device will do)."""
    items = model.named_parameters() if isinstance(model, nn.Module) else model
    return {name: param_spec(name, tuple(getattr(t, "shape", t)), mesh) for name, t in items}


def shard_dim(name: str, shape: Sequence[int], mesh: Union[Mesh, Mapping[str, int]]) -> Optional[int]:
    """The dim that `shard_params` shards over the flattened fsdp x model
    axis: the one JAX's spec gives `fsdp`, else `model` (an axis of size 1
    shards nothing in JAX and is passed over), if fsdp x model divides it;
    None for FSDP2's default (dim 0)."""
    ms = _mesh_shape(mesh)
    n = ms["fsdp"] * ms["model"]
    spec = param_spec(name, shape, ms)
    for axis in [a for a in ("fsdp", "model") if ms[a] > 1] or ["fsdp", "model"]:
        if axis in spec:
            d = spec.index(axis)
            if shape[d] % n == 0:
                return d
    return None


def _blocks(model: nn.Module) -> list:
    """Every module of an `nn.ModuleList` that has its own forward (the
    blocks of every tower), deepest first."""
    found = []
    for name, mod in model.named_modules():
        if isinstance(mod, nn.ModuleList):
            for i, child in enumerate(mod):
                if type(child).forward is not nn.Module.forward:
                    found.append((f"{name}.{i}" if name else str(i), child))
    found.sort(key=lambda nc: -nc[0].count("."))
    return [c for _, c in found]


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Shard `model`'s parameters at rest over the mesh by the rules, in
    place: split over `model` when it is > 1, then `fully_shard` on every
    block and on the root (see the module docstring). Returns the model; the
    identity without a process group. Run its computations through
    `sharded_call`."""
    if not mesh.distributed:
        return model
    if mesh.tp is not None and getattr(model, "tensor_parallel_ok", False):
        return _shard_split(model, mesh)
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    names = {id(p): n for n, p in model.named_parameters()}
    shape = mesh.shape

    def placement(p):
        d = shard_dim(names[id(p)], tuple(p.shape), shape)
        return None if d is None else Shard(d)

    def scalars(mod):
        return {p for p in mod.parameters() if p.dim() == 0}

    for blk in _blocks(model):
        fully_shard(blk, mesh=mesh.shard_mesh, shard_placement_fn=placement,
                    ignored_params=scalars(blk) or None)
    fully_shard(model, mesh=mesh.shard_mesh, shard_placement_fn=placement,
                ignored_params=scalars(model) or None)
    return model


def _split_param(p: nn.Parameter, dim: int, parts: int, tp: TensorParallel, model_mesh) -> nn.Parameter:
    """This rank's share of `p` as a DTensor on the `model` sub-mesh: its
    1/m of dim `dim`, or with `parts` > 1 its 1/m of each of the `parts`
    equal blocks of that dim (the fused [q|k|v] columns)."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    with torch.no_grad():
        if parts > 1:
            idx = head_columns(p.shape[dim] // parts, tp.size, tp.rank, parts).to(p.device)
            loc = p.index_select(dim, idx)
            pl = _StridedShard(dim, split_factor=parts)
        else:
            n = p.shape[dim] // tp.size
            loc = p.narrow(dim, tp.rank * n, n).clone()
            pl = Shard(dim)
        dt = DTensor.from_local(loc.contiguous(), model_mesh, [pl], run_check=False, shape=p.shape,
                                stride=p.stride())
    return nn.Parameter(dt, requires_grad=p.requires_grad)


def _shard_split(model: nn.Module, mesh: Mesh) -> nn.Module:
    """`shard_params` on `model` > 1: TP DTensors where `tp_layout` allows,
    FSDP2 over the `fsdp` sub-mesh on the dim JAX's spec gives `fsdp`
    (blocks, and other modules with a forward, that stay whole: the
    flattened placement), JAX's replicated parameters left out of FSDP."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    m, tp, model_mesh = mesh.shape["model"], mesh.tp, mesh.device_mesh["model"]
    split_mods = set()
    for mod in model.modules():
        layout = mod.tp_layout(m) if hasattr(mod, "tp_layout") else None
        if layout is None:
            continue
        for pname, (dim, parts) in layout.items():
            owner, leaf = mod.get_submodule(pname.rpartition(".")[0]), pname.rpartition(".")[2]
            owner._parameters[leaf] = _split_param(owner._parameters[leaf], dim, parts, tp, model_mesh)
        mod.tp = tp
        split_mods.add(mod)

    names = {id(p): n for n, p in model.named_parameters()}
    shape = mesh.shape

    def spec(p):
        return param_spec(names[id(p)], tuple(p.shape), shape)

    def split_placement(p):
        s = spec(p)
        return Shard(s.index("fsdp"))

    def flat_placement(p):
        d = shard_dim(names[id(p)], tuple(p.shape), shape)
        return None if d is None else Shard(d)

    def whole(mod, split: bool):
        """Parameters FSDP leaves alone: JAX's replicated ones (and scalars);
        in a split module (and the root) also those whose spec names no
        `fsdp` dim (the column-parallel biases)."""
        return {p for p in mod.parameters()
                if p.dim() == 0 or all(a is None for a in spec(p)) or (split and "fsdp" not in spec(p))}

    blocks = _blocks(model)
    in_blocks = {id(p) for blk in blocks for p in blk.parameters()}
    # whole modules outside the blocks that JAX shards over `model` too: units
    # of their own on the flattened axis, gathered around their forward
    whole_mods = [mod for mod in model.modules()
                  if mod is not model and mod not in split_mods and hasattr(mod, "tp_layout")
                  and type(mod).forward is not nn.Module.forward
                  and not any(id(p) in in_blocks for p in mod.parameters())]
    for unit in blocks + whole_mods:
        if unit in split_mods:
            fully_shard(unit, mesh=mesh.fsdp_mesh, shard_placement_fn=split_placement,
                        ignored_params=whole(unit, True) or None)
        else:
            fully_shard(unit, mesh=mesh.shard_mesh, shard_placement_fn=flat_placement,
                        ignored_params=whole(unit, False) or None)
    # fully_shard put new parameters in the blocks
    names.update({id(p): n for n, p in model.named_parameters()})
    fully_shard(model, mesh=mesh.fsdp_mesh, shard_placement_fn=split_placement,
                ignored_params=whole(model, True) or None)
    model.register_state_dict_post_hook(_unsplit_state)
    return model


def _unsplit_state(module, state_dict, prefix, local_metadata) -> None:
    """A split model's state_dict in the unsplit layout: every DTensor
    gathered into a plain tensor (collective: every rank calls it)."""
    for k, v in state_dict.items():
        state_dict[k] = full_value(v)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: the parameter's or buffer's global value} as plain tensors, in
    the unsplit layout, whatever the model's sharding (collective on a
    sharded model)."""
    return {k: full_value(v) for k, v in model.state_dict().items()}


def is_sharded(model) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def sharded_call(model: nn.Module, fn: Callable, *args, **kwargs):
    """`fn(*args, **kwargs)` with a sharded `model`'s root parameters
    gathered: the call runs inside the root's forward hooks, so FSDP2
    gathers them for the call and, when the result carries an autograd
    graph, keeps them for its backward, after which it reshards. A result
    with no graph reshards at once. A plain call on an unsharded model."""
    if not is_sharded(model):
        return fn(*args, **kwargs)
    # one positional argument, no tensor: FSDP2's root hook moves the call's
    # arguments to the device and (torch 2.11) indexes the first of them
    model.forward = lambda _: fn(*args, **kwargs)
    try:
        out = model(None)
    finally:
        del model.forward
    leaves, _ = tree_flatten(out)
    if not any(torch.is_tensor(t) and t.requires_grad for t in leaves):
        model.reshard()
    return out


def replicate(tree, mesh: Mesh):
    """The same values on every rank: a module's parameters and buffers, or
    the tensors of a pytree, broadcast from rank 0 in place. The identity
    without a process group."""
    if not mesh.distributed:
        return tree
    tensors = (list(tree.parameters()) + list(tree.buffers()) if isinstance(tree, nn.Module)
               else [t for t in tree_flatten(tree)[0] if torch.is_tensor(t)])
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
    return tree


def shard_attack(attack_fn: Callable, mesh: Mesh, *, params=None) -> Callable:
    """Data-parallel attack wrapper: each rank attacks its rows of (x, y)
    and the results are all-gathered, so every rank holds the whole result
    (as a JAX global array is addressable everywhere). Per-example attack
    state lives with its example.

    attack_fn(params, x, y) when `params` is given (a module or a pytree of
    tensors, replicated from rank 0), else attack_fn(x, y). Returns
    wrapped(x, y=None)."""
    if params is not None:
        params = replicate(params, mesh)

    def wrapped(x, y=None):
        lead = (params,) if params is not None else ()
        xs = batch_sharding(mesh, x)
        if y is not None:
            out = attack_fn(*lead, xs, batch_sharding(mesh, y))
        else:
            out = attack_fn(*lead, xs)
        return gather_batch(out, mesh)

    return wrapped
