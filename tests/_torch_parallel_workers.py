"""Process worlds for the port's parallel tests (tests/test_torch_parallel*.py).

`run_world` spawns `world` processes on the CPU, each in a gloo process
group over a `FileStore` in the test's tmp_path (no TCP port, so xdist
workers do not collide) with a 60 s collective timeout; each runs one of
the functions below and writes its result, which `run_world` returns in
rank order. The parent waits at most `timeout` seconds, kills every child
on expiry or at the first failure, and raises: a deadlocked collective
fails its test instead of hanging the suite.

This module is not collected (no `test_` prefix) and imports only torch,
numpy and the port: the spawned children never import jax. The JAX side of
each comparison runs in the test process.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


# ------------------------------------------------------------------ harness
def _child(fn_name: str, rank: int, world: int, store: str, out: str, kwargs: dict) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=COLLECTIVE_TIMEOUT)
    try:
        result = globals()[fn_name](rank, world, **kwargs)
        record = {"ok": True, "result": result, "jax_imported": "jax" in sys.modules}
        code = 0
    except Exception:  # noqa: BLE001 - reported to the parent with its traceback
        record = {"ok": False, "error": traceback.format_exc()}
        code = 1
    torch.save(record, Path(out) / f"rank{rank}.pt")
    if code == 0:
        dist.destroy_process_group()
    os._exit(code)


def run_world(tmp_path, world: int, fn_name: str, timeout: float = 240.0, **kwargs) -> list:
    """Run `fn_name(rank, world, **kwargs)` in `world` spawned processes; the
    per-rank results in rank order."""
    root = Path(tmp_path) / f"world-{fn_name}-{time.monotonic_ns()}"
    root.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(fn_name, r, world, str(root / "store"), str(root), kwargs))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.is_alive() for p in procs):
            failed = next((r for r, p in enumerate(procs) if p.exitcode not in (None, 0)), None)
            if failed is not None or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        failed = next((r for r, p in enumerate(procs) if p.exitcode not in (None, 0)), failed)
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    records = {}
    for r in range(world):
        f = root / f"rank{r}.pt"
        if f.exists():
            records[r] = torch.load(f, weights_only=False)
    errors = [records[r]["error"] for r in records if not records[r]["ok"]]
    if errors:
        raise AssertionError(f"{fn_name}: a rank failed:\n{errors[0]}")
    if failed is not None or hung or len(records) != world:
        why = f"rank {failed} exited without a result" if failed is not None else f"timed out after {timeout} s"
        raise AssertionError(f"{fn_name}: {why}; ranks {hung} were killed; exit codes "
                             f"{[p.exitcode for p in procs]}")
    assert not any(records[r]["jax_imported"] for r in records), "a spawned rank imported jax"
    return [records[r]["result"] for r in range(world)]


# ------------------------------------------------------------------ helpers
def _state(model) -> dict:
    """name -> full numpy value (DTensors gathered, split ones in the
    unsplit layout)."""
    from robustvlm_tpu_torch.parallel.tensor_parallel import full_value

    return {n: full_value(p).detach().cpu().numpy().copy() for n, p in model.named_parameters()}


def _placements(model) -> dict:
    """name -> (the shard dim of each mesh dim, None where replicated; the
    local shape) of each DTensor parameter."""
    from torch.distributed.tensor import DTensor

    return {n: (tuple(getattr(pl, "dim", None) for pl in p.placements), tuple(p.to_local().shape))
            for n, p in model.named_parameters() if isinstance(p, DTensor)}


def _clip(tree):
    from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, params_from_jax

    model = CLIP(CLIP_CONFIGS["test-tiny"])
    model.load_state_dict(params_from_jax(tree))
    return model


def _patch_pgd_starts(starts: dict):
    """The trainer's PGD starts from `starts` (seed -> the global chunk's
    start): the JAX step's draws, so both sides attack from one start."""
    from robustvlm_tpu_torch.train import trainer

    def draw(shape, eps, seed, device, dtype):
        s = torch.tensor(starts[seed])
        assert tuple(s.shape) == tuple(shape), (s.shape, shape)
        return s.to(device=device, dtype=dtype)

    trainer.pgd_random_start = draw


# ------------------------------------------------------------------ worlds
def train_world(rank, world, tree, tree_orig, x, y, temb, cfg_kw, starts, accums, seed):
    """Mesh shapes; the data-parallel step (data = world) at each grad_accum
    in `accums`; the same step on (2, 1, 2) with sharded parameters (HSDP);
    a TP+FSDP step on (1, 2, 2)."""
    from robustvlm_tpu_torch.parallel.mesh import batch_sharding, make_mesh, shard_params
    from robustvlm_tpu_torch.train.trainer import TrainConfig, TrainStep

    out = {}
    m = make_mesh(device="cpu")
    out["mesh_default"] = m.shape
    out["mesh_122"] = make_mesh(data=1, fsdp=2, model=2, device="cpu").shape
    try:
        make_mesh(data=3, fsdp=2, model=2, device="cpu")
        out["mesh_bad_raises"] = False
    except ValueError:
        out["mesh_bad_raises"] = True

    _patch_pgd_starts(starts)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for k in accums:
        cfg = TrainConfig(**cfg_kw, grad_accum=k)
        model, orig = _clip(tree), _clip(tree_orig)
        step = TrainStep(cfg, model, orig, torch.from_numpy(temb), mesh=m)
        metrics = step(batch_sharding(m, xt, k), batch_sharding(m, yt, k), seed)
        out[f"dp{k}"] = {"metrics": {n: float(v) for n, v in metrics.items()}, "params": _state(model)}

    # HSDP: replicated over data = 2, sharded over model = 2; the DP step's PGD
    cfg = TrainConfig(**cfg_kw)
    hsdp = make_mesh(data=2, fsdp=1, model=2, device="cpu")
    model = shard_params(_clip(tree), hsdp)
    step = TrainStep(cfg, model, _clip(tree_orig), torch.from_numpy(temb), mesh=hsdp)
    metrics = step(batch_sharding(hsdp, xt), batch_sharding(hsdp, yt), seed)
    out["hsdp"] = {"metrics": {n: float(v) for n, v in metrics.items()}, "params": _state(model),
                   "placements": _placements(model)}

    # TP + FSDP: parameters sharded over fsdp x model, APGD inner attack
    mesh = make_mesh(data=1, fsdp=2, model=2, device="cpu")
    cfg = TrainConfig(**{**cfg_kw, "attack": "apgd"})
    model = shard_params(_clip(tree), mesh)
    before = _placements(model)
    step = TrainStep(cfg, model, _clip(tree_orig), torch.from_numpy(temb), mesh=mesh)
    metrics = step(batch_sharding(mesh, xt), batch_sharding(mesh, yt), seed)
    after = _placements(model)
    out["tp_fsdp"] = {"loss": float(metrics["loss"]), "before": before, "after": after,
                      "finite": all(bool(np.isfinite(v).all()) for v in _state(model).values())}
    return out


def driver_world(rank, world, argv_by_rank):
    """`train.driver.main` inside the group (each rank's own argv): the
    final parameters and the metrics."""
    from robustvlm_tpu_torch.train import driver

    run = driver.main(argv_by_rank[rank])
    return {"params": _state(run.model), "metrics": run.metrics, "steps": run.steps}


def models_world(rank, world, llava_tree, blip2_tree, mclip_tree, apgd):
    """shard_attack APGD on a data = world mesh, both forms; sharded pixel
    gradients of tiny LLaVA and BLIP-2 and a sharded mclip text encode on
    (1, 4, 1), sharded and gathered on use (on a mesh with `model` > 1 they
    split over `model`, which `tp_world` and `tp_family_world` hold), each
    with the same model unsharded."""
    from robustvlm_tpu_torch.attacks.apgd import apgd_attack
    from robustvlm_tpu_torch.models.blip2 import model as PB
    from robustvlm_tpu_torch.models.blip2.convert import params_from_jax as blip2_from_jax
    from robustvlm_tpu_torch.models.clip import params_from_jax
    from robustvlm_tpu_torch.models.llava.convert import params_from_jax as llava_from_jax
    from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS, Llava, llava_per_sample_loss
    from robustvlm_tpu_torch.models.mclip import MCLIP_CONFIGS, JaCLIP
    from robustvlm_tpu_torch.ops.losses import ce_loss
    from robustvlm_tpu_torch.parallel.mesh import (
        batch_sharding,
        gather_batch,
        make_mesh,
        shard_attack,
        shard_params,
        sharded_call,
    )

    out = {}
    dp = make_mesh(device="cpu")
    w = torch.from_numpy(apgd["w"])
    x, y = torch.from_numpy(apgd["x"]), torch.from_numpy(apgd["y"])

    def attack(xx, yy):
        return apgd_attack(lambda t: t.reshape(t.shape[0], -1) @ w, xx, yy,
                           criterion=lambda o, t: ce_loss(o, t, reduction="none"),
                           eps=8 / 255, n_iter=8, norm="linf").x_best_adv

    def attack_p(ww, xx, yy):
        return apgd_attack(lambda t: t.reshape(t.shape[0], -1) @ ww, xx, yy,
                           criterion=lambda o, t: ce_loss(o, t, reduction="none"),
                           eps=8 / 255, n_iter=8, norm="linf").x_best_adv

    out["apgd"] = shard_attack(attack, dp)(x, y).numpy()
    out["apgd_params"] = shard_attack(attack_p, dp, params=w.clone())(x, y).numpy()

    mesh = make_mesh(data=1, fsdp=4, model=1, device="cpu")

    def pixel_grad(model, loss_fn, xx, *args):
        xa = xx.clone().requires_grad_(True)
        loss = sharded_call(model, loss_fn, model, xa, *args)
        (g,) = torch.autograd.grad(loss.sum(), xa)
        return loss.detach(), g

    def held(build, loss_fn, xx, *args, mesh=mesh):
        """(unsharded loss, grad) on the full batch; (sharded loss, grad)
        from each rank's rows, gathered."""
        ref = pixel_grad(build(), loss_fn, xx, *args)
        model = shard_params(build(), mesh)
        rows = [batch_sharding(mesh, a) for a in (xx, *args)]
        got = gather_batch(pixel_grad(model, loss_fn, *rows), mesh)
        return {"ref": [t.numpy() for t in ref], "got": [t.numpy() for t in got],
                "sharded": sorted(_placements(model))}

    lcfg = LLAVA_CONFIGS["test-tiny"]
    lx, ltok, lmask = (torch.from_numpy(a) for a in (llava_tree["x"], llava_tree["tokens"], llava_tree["mask"]))
    out["llava"] = held(lambda: Llava.from_state(lcfg, llava_from_jax(llava_tree["params"])),
                        lambda m, xx, t, mk: llava_per_sample_loss(m, xx, t, t, t, mk, compute_dtype=torch.float32),
                        lx, ltok, lmask)
    bcfg = PB.BLIP2_CONFIGS["test-tiny"]
    bx, btok, bmask = (torch.from_numpy(a) for a in (blip2_tree["x"], blip2_tree["tokens"], blip2_tree["mask"]))
    out["blip2"] = held(lambda: PB.Blip2.from_state(bcfg, blip2_from_jax(blip2_tree["params"])),
                        lambda m, xx, t, mk: PB.blip2_per_sample_loss(m, xx, t, t, mk,
                                                                      compute_dtype=torch.float32),
                        bx, btok, bmask)

    def mclip():
        model = JaCLIP(MCLIP_CONFIGS["test-tiny-mclip"])
        model.load_state_dict(params_from_jax(mclip_tree["params"]))
        return model

    ids, mask = torch.from_numpy(mclip_tree["ids"]), torch.from_numpy(mclip_tree["mask"])
    with torch.no_grad():
        ref = mclip().encode_text(ids, mask, normalize=True)
        model = shard_params(mclip(), mesh)
        got = gather_batch(sharded_call(model, model.encode_text, batch_sharding(mesh, ids),
                                        batch_sharding(mesh, mask), normalize=True), mesh)
    out["mclip"] = {"ref": ref.numpy(), "got": got.numpy(), "sharded": sorted(_placements(model))}
    return out


def engine_world(rank, world, tree, imgs, max_new):
    """The continuous engine (2 lanes, width 8) and the solo stream on tiny
    LLaVA sharded over (1, 2, 2), float32."""
    from robustvlm_tpu_torch.models.llava.convert import params_from_jax
    from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS, Llava
    from robustvlm_tpu_torch.parallel.mesh import make_mesh, shard_params
    from robustvlm_tpu_torch.serve.continuous import ContinuousEngine
    from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel, WordTokenizer

    cfg = LLAVA_CONFIGS["test-tiny"]
    mesh = make_mesh(data=1, fsdp=2, model=2, device="cpu")
    model = shard_params(Llava.from_state(cfg, params_from_jax(tree)), mesh)
    m = LlavaEvalModel(model, WordTokenizer(cfg.llama.vocab_size), compute_dtype=torch.float32,
                       max_post_len=16)
    prompt = m.get_caption_prompt()
    solo = []
    for img in imgs:
        ids = []
        for t in m.stream_tokens(torch.from_numpy(img)[None], [prompt], max_new):
            if int(t[0]) in (m.tok.eos_token_id, m.tok.pad_token_id):
                break
            ids.append(int(t[0]))
        solo.append(ids)
    eng = ContinuousEngine(m, n_slots=2, width=8, max_new=max_new)
    try:
        rs = [eng.submit(img, prompt, max_new) for img in imgs]
        engine = [r.wait_ids() for r in rs]
    finally:
        eng.shutdown()
    return {"solo": solo, "engine": engine, "sharded": sorted(_placements(model))}


def gather_world(rank, world, sizes):
    """all_gather_results of payloads of different lengths, and this rank's
    dataset slice."""
    from robustvlm_tpu_torch.parallel.multihost import (
        all_gather_results,
        merge_metric_means,
        process_shard_bounds,
        process_shard_indices,
    )

    n = sum(sizes)
    start, stop = process_shard_bounds(n)
    local = {"rank": rank, "ids": np.arange(start, stop), "text": "x" * sizes[rank],
             "acc": float(rank) / 2}
    merged = all_gather_results(local)
    means = merge_metric_means([{"acc": r["acc"]} for r in merged], [len(r["ids"]) for r in merged])
    return {"merged": merged, "indices": process_shard_indices(n).tolist(), "means": means}


# ------------------------------------------------------------------ tensor parallel
def _q_shape(q, a) -> tuple:
    """q's (B, H, N, D) shape: q itself, or the q of a packed call's fused
    (B, N, 3W) projection over a[0] heads."""
    if not a or not isinstance(a[0], int):
        return tuple(q.shape)
    b, n, w3 = q.shape
    return (b, a[0], n, w3 // 3 // a[0])


def _record_attention(module, names=("vit_attention", "flash_attention")) -> list:
    """Wrap the attention entry points a model module calls, each name with
    its packed form (`<name>_qkv`); returns the list of (name, q shape) each
    call appends."""
    seen = []
    for n in names:
        for entry in (n, n + "_qkv"):
            if hasattr(module, entry):
                fn = getattr(module, entry)

                def wrapped(q, *a, _fn=fn, _n=n, **k):
                    seen.append((_n, _q_shape(q, a)))
                    return _fn(q, *a, **k)

                setattr(module, entry, wrapped)
    return seen


def _local_bytes(model) -> dict:
    """name -> bytes this rank holds of the parameter."""
    from torch.distributed.tensor import DTensor

    return {n: (p.to_local() if isinstance(p, DTensor) else p).detach().nbytes
            for n, p in model.named_parameters()}


def _full(model) -> dict:
    from robustvlm_tpu_torch.parallel.mesh import full_state_dict

    return {k: v.detach().cpu().numpy().copy() for k, v in full_state_dict(model).items()}


def tp_world(rank, world, mesh_shape, clip, llava, train, lm="test-tiny"):
    """One mesh (data, fsdp, model) with `model` > 1, float32 on the CPU, each
    computation on the split model (this rank's rows, gathered) beside the
    same model unsplit on the whole batch:
      clip   - image and text embeddings, 5 APGD-CE iterations' robust
               flags (zero-shot logits), per-parameter local bytes, the
               attention shapes, block 0's local qkv columns, the unsplit
               state_dict;
      llava  - the per-sample loss and pixel gradient (LM config `lm`), local
               bytes, attention shapes, which LM blocks split, state_dict;
      train  - a TeCoA and a FARE step (SGD, PGD from the given starts):
               the parameters after the step, in the unsplit layout."""
    from robustvlm_tpu_torch.attacks.apgd import apgd_attack
    from robustvlm_tpu_torch.models.clip import model as PC
    from robustvlm_tpu_torch.models.llama import model as PL
    from robustvlm_tpu_torch.models.llava import model as PV
    from robustvlm_tpu_torch.models.llava.convert import params_from_jax as llava_from_jax
    from robustvlm_tpu_torch.ops.image import normalize_clip
    from robustvlm_tpu_torch.ops.losses import ce_loss
    from robustvlm_tpu_torch.parallel.mesh import (
        batch_sharding,
        gather_batch,
        make_mesh,
        shard_params,
        sharded_call,
    )
    from robustvlm_tpu_torch.parallel.tensor_parallel import head_columns
    from robustvlm_tpu_torch.train.trainer import TrainConfig, TrainStep

    mesh = make_mesh(*mesh_shape, device="cpu")
    out = {"coords": mesh.coords}
    rows = lambda a: batch_sharding(mesh, torch.from_numpy(a))  # noqa: E731

    # --- CLIP
    x, tok, temb, y = (torch.from_numpy(clip[k]) for k in ("x", "tokens", "temb", "y"))

    def encode(model):
        img = sharded_call(model, model.encode_image, normalize_clip(batch_sharding(mesh, x)), normalize=True)
        txt = sharded_call(model, model.encode_text, batch_sharding(mesh, tok), normalize=True)
        return gather_batch((img, txt), mesh)

    def flags(model):
        def logits(xa):
            return sharded_call(model, model.encode_image, normalize_clip(xa), normalize=True) @ (100.0 * temb)

        res = apgd_attack(logits, batch_sharding(mesh, x), batch_sharding(mesh, y),
                          criterion=lambda o, t: ce_loss(o, t, reduction="none"), eps=8 / 255,
                          n_iter=5, norm="linf")
        return gather_batch(res.acc, mesh)

    ref = _clip(clip["tree"])
    with torch.no_grad():
        ref_img, ref_txt = encode(ref)
    ref_flags = flags(ref)
    model = shard_params(_clip(clip["tree"]), mesh)
    seen = _record_attention(PC)
    with torch.no_grad():
        img, txt = encode(model)
    got_flags = flags(model)
    qkv = model.visual.blocks[0].attn.qkv_w
    want = torch.from_numpy(_full(ref)["visual.blocks.0.attn.qkv_w"])
    f, fi = mesh.shape["fsdp"], mesh.coords[1]
    want = want.chunk(f, 0)[fi][:, head_columns(want.shape[0], mesh.shape["model"], mesh.coords[2])]
    out["clip"] = {"img": img.numpy(), "txt": txt.numpy(), "ref_img": ref_img.numpy(), "ref_txt": ref_txt.numpy(),
                   "flags": got_flags.numpy(), "ref_flags": ref_flags.numpy(), "bytes": _local_bytes(model),
                   "attention": sorted(set(seen)), "qkv_local_equal": bool(torch.equal(qkv.to_local(), want)),
                   "split_blocks": [b.tp is not None for b in list(model.visual.blocks) + list(model.text.blocks)],
                   "state": _full(model)}

    # --- LLaVA
    cfg = PV.LLAVA_CONFIGS["test-tiny"]
    if lm != cfg.llama.name:
        import dataclasses

        cfg = dataclasses.replace(cfg, name=f"test-tiny-{lm}", llama=PL.LLAMA_CONFIGS[lm])
    lx, ltok, lmask = rows(llava["x"]), rows(llava["tokens"]), rows(llava["mask"])

    def loss_grad(model, xx, t, mk):
        xa = xx.clone().requires_grad_(True)
        loss = sharded_call(model, PV.llava_per_sample_loss, model, xa, t, t, t, mk,
                            compute_dtype=torch.float32)
        (g,) = torch.autograd.grad(loss.sum(), xa)
        return loss.detach(), g

    full_in = [torch.from_numpy(llava[k]) for k in ("x", "tokens", "mask")]
    ref_loss, ref_grad = loss_grad(PV.Llava.from_state(cfg, llava_from_jax(llava["tree"])), *full_in)
    model = shard_params(PV.Llava.from_state(cfg, llava_from_jax(llava["tree"])), mesh)
    seen_v, seen_l = _record_attention(PC), _record_attention(PL)
    loss, grad = gather_batch(loss_grad(model, lx, ltok, lmask), mesh)
    out["llava"] = {"loss": loss.numpy(), "grad": grad.numpy(), "ref_loss": ref_loss.numpy(),
                    "ref_grad": ref_grad.numpy(), "bytes": _local_bytes(model),
                    "attention": sorted(set(seen_v) | set(seen_l)),
                    "lm_blocks_split": [b.tp is not None for b in model.llama.blocks],
                    "head_split": model.llama.tp is not None, "projector_split": model.projector.tp is not None,
                    "state": _full(model)}

    # --- TeCoA and FARE steps
    if train is not None:
        _patch_pgd_starts(train["starts"])
        xt, yt = torch.from_numpy(train["x"]), torch.from_numpy(train["y"])
        out["train"] = {}
        for name, kw in train["configs"].items():
            model = shard_params(_clip(train["tree"]), mesh)
            step = TrainStep(TrainConfig(**kw), model, _clip(train["tree_orig"]), torch.from_numpy(train["temb"]),
                             mesh=mesh)
            metrics = step(batch_sharding(mesh, xt), batch_sharding(mesh, yt), train["seed"])
            out["train"][name] = {"loss": float(metrics["loss"]), "params": _full(model)}
    return out


def tp_serve_world(rank, world, mesh_shape, tree, imgs, max_new, k):
    """Tiny LLaVA, float32, sharded over `mesh_shape` (split when `model` >
    1): each image's plain stream and k-draft speculative stream, and the
    continuous engine (2 lanes, width 8) on all of them; every rank runs
    the same requests in the same order (SPMD)."""
    from robustvlm_tpu_torch.models.llava.convert import params_from_jax
    from robustvlm_tpu_torch.models.llava.model import LLAVA_CONFIGS, Llava
    from robustvlm_tpu_torch.parallel.mesh import make_mesh, shard_params
    from robustvlm_tpu_torch.serve.continuous import ContinuousEngine
    from robustvlm_tpu_torch.serve.speculative import spec_stream_tokens
    from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel, WordTokenizer

    cfg = LLAVA_CONFIGS["test-tiny"]
    model = shard_params(Llava.from_state(cfg, params_from_jax(tree)), make_mesh(*mesh_shape, device="cpu"))
    m = LlavaEvalModel(model, WordTokenizer(cfg.llama.vocab_size), compute_dtype=torch.float32, max_post_len=16)
    prompt = m.get_caption_prompt()

    def ids(gen):
        out = []
        for t in gen:
            if int(t[0]) in (m.tok.eos_token_id, m.tok.pad_token_id):
                break
            out.append(int(t[0]))
        return out

    x = [torch.from_numpy(img)[None] for img in imgs]
    solo = [ids(m.stream_tokens(xi, [prompt], max_new)) for xi in x]
    stats = {}
    spec = [ids(spec_stream_tokens(m, xi, [prompt], max_new, k=k, stats=stats)) for xi in x]
    eng = ContinuousEngine(m, n_slots=2, width=8, max_new=max_new)
    try:
        rs = [eng.submit(img, prompt, max_new) for img in imgs]
        engine = [r.wait_ids() for r in rs]
    finally:
        eng.shutdown()
    return {"solo": solo, "spec": spec, "engine": engine, "verify_steps": stats["verify_steps"],
            "sharded": sorted(_placements(model)),
            "split": [b.tp is not None for b in model.llama.blocks] + [model.llama.tp is not None]}


# ------------------------------------------------------------------ tensor parallel: the other families
GEN_NEW = 6  # generated tokens


def _loss_grad(model, loss_fn, x, *args):
    """(loss, pixel gradient) of `loss_fn(model, x, *args)` through sharded_call."""
    from robustvlm_tpu_torch.parallel.mesh import sharded_call

    xa = x.clone().requires_grad_(True)
    loss = sharded_call(model, loss_fn, model, xa, *args)
    (g,) = torch.autograd.grad(loss.sum(), xa)
    return loss.detach(), g


def _held_split(mesh, build, loss_fn, arrays, spy=None):
    """The loss and pixel gradient of the unsplit model on the whole batch
    and of the split one (`shard_params`) on this rank's rows, gathered;
    `spy` (a module whose `flash_attention`, or its packed form
    `flash_attention_qkv`, to record) is wrapped around the split run only.
    -> (split model, record)."""
    from robustvlm_tpu_torch.parallel.mesh import batch_sharding, gather_batch, shard_params

    full = [torch.from_numpy(a) for a in arrays]
    ref_loss, ref_grad = _loss_grad(build(), loss_fn, *full)
    model = shard_params(build(), mesh)
    entry = next((e for e in ("flash_attention", "flash_attention_qkv") if hasattr(spy, e)), None)
    seen, fn = [], getattr(spy, entry) if entry else None
    if entry:
        def wrapped(q, *a, **k):
            s = k.get("alibi_slopes")
            seen.append((_q_shape(q, a), None if s is None else s.tolist()))
            return fn(q, *a, **k)

        setattr(spy, entry, wrapped)
    try:
        loss, grad = gather_batch(_loss_grad(model, loss_fn, *[batch_sharding(mesh, a) for a in full]), mesh)
    finally:
        if entry:
            setattr(spy, entry, fn)
    rec = {"loss": loss.numpy(), "grad": grad.numpy(), "ref_loss": ref_loss.numpy(), "ref_grad": ref_grad.numpy(),
           "bytes": _local_bytes(model), "spy": seen}
    return model, rec


def _tokens(model, make_fns, x, seqs, beams, **kw):
    """Greedy (beams = 1) or beam tokens of `seqs` (left-padded) on `x`,
    through the eval adapters' `_decode_fns_of` (every call under
    sharded_call)."""
    from robustvlm_tpu_torch.models.generation import beam_generate, greedy_generate, left_pad
    from robustvlm_tpu_torch.vlm_eval.eval_models import _decode_fns_of

    toks, n_pad = left_pad(seqs, pad_id=0)
    pf, df = _decode_fns_of(model, make_fns, torch.from_numpy(x), *kw.pop("args", ()),
                            max_total_len=toks.shape[1] + GEN_NEW, compute_dtype=torch.float32, **kw)
    gkw = dict(max_new_tokens=GEN_NEW, eos_id=2, pad_id=0)
    pt, pn = torch.from_numpy(toks).long(), torch.from_numpy(n_pad).long()
    with torch.no_grad():
        if beams == 1:
            return greedy_generate(pf, df, pt, pn, **gkw).tokens.numpy()
        return beam_generate(pf, df, pt, pn, num_beams=beams, length_penalty=1.0, **gkw).tokens.numpy()


def _local_columns(mesh, ref_state, name, param, parts):
    """Whether a split parameter's local block is exactly this rank's
    columns of each of its `parts` fused blocks, of its fsdp rows."""
    from robustvlm_tpu_torch.parallel.tensor_parallel import head_columns

    want = torch.from_numpy(ref_state[name])
    want = want.chunk(mesh.shape["fsdp"], 0)[mesh.coords[1]]
    want = want[:, head_columns(want.shape[1] // parts, mesh.shape["model"], mesh.coords[2], parts)]
    return bool(torch.equal(param.to_local(), want))


def _tp_llava_mpt(mesh, d):
    from robustvlm_tpu_torch.models.llava import model as PV
    from robustvlm_tpu_torch.models.llava.convert import params_from_jax
    from robustvlm_tpu_torch.models.mpt import model as PM

    cfg = PV.LLAVA_CONFIGS["test-tiny-mpt"]

    def build():
        return PV.Llava.from_state(cfg, params_from_jax(d["tree"]))

    def loss_fn(m, x, pre, post, mask):
        return PV.llava_per_sample_loss(m, x, pre, post, post, mask, compute_dtype=torch.float32)

    ref = build()
    model, rec = _held_split(mesh, build, loss_fn, (d["x"], d["pre"], d["post"], d["mask"]),
                             spy=PM)
    args = (torch.from_numpy(d["gen_pre"]),)
    rec["tokens"] = _tokens(model, PV.make_llava_decode_fns, d["gen_x"], d["seqs"], 1, args=args)
    rec["ref_tokens"] = _tokens(ref, PV.make_llava_decode_fns, d["gen_x"], d["seqs"], 1, args=args)
    rec["split"] = {"vision": [b.tp is not None for b in model.vision.blocks],
                    "lm": [b.tp is not None for b in model.mpt.blocks], "projector": model.projector.tp is not None}
    rec["wqkv_local_equal"] = _local_columns(mesh, _full(ref), "mpt.blocks.0.attn.wqkv",
                                             model.mpt.blocks[0].attn.wqkv, 3)
    rec["state"] = _full(model)
    return rec


def _tp_flamingo(mesh, d):
    import dataclasses

    from robustvlm_tpu_torch.attacks.apgd import apgd_attack
    from robustvlm_tpu_torch.models.flamingo import convert as PC
    from robustvlm_tpu_torch.models.flamingo import model as PF
    from robustvlm_tpu_torch.models.mpt import model as PM
    from robustvlm_tpu_torch.ops.losses import ce_loss
    from robustvlm_tpu_torch.parallel.mesh import batch_sharding, gather_batch, sharded_call

    cfg = dataclasses.replace(PF.FLAMINGO_CONFIGS["test-tiny"], media_token_id=d["media"])

    def build():
        return PF.Flamingo.from_state(cfg, PC.params_from_jax(d["tree"]))

    def loss_fn(m, vx, lang, mask):
        return PF.flamingo_per_sample_loss(m, vx, lang, lang, mask, compute_dtype=torch.float32)

    ref = build()
    model, rec = _held_split(mesh, build, loss_fn, (d["vx"], d["lang"], d["mask"]), spy=PM)
    for beams in (1, 3):
        rec[f"tokens{beams}"] = _tokens(model, PF.make_flamingo_decode_fns, d["gen_vx"], d["seqs"], beams)
        rec[f"ref_tokens{beams}"] = _tokens(ref, PF.make_flamingo_decode_fns, d["gen_vx"], d["seqs"], beams)

    a = d["apgd"]
    pairs = [(torch.from_numpy(a[f"lang_{c}"]), torch.from_numpy(a[f"mask_{c}"])) for c in "ab"]

    def logits_of(m, rows):
        """The two-caption logits -loss(caption) on this rank's rows."""
        def logits(xa):
            lp = [sharded_call(m, loss_fn, m, xa[:, None, None], rows(la), rows(ma)) for la, ma in pairs]
            return -torch.stack(lp, dim=-1)
        return logits

    x = torch.from_numpy(a["x"])
    with torch.no_grad():
        y = logits_of(ref, lambda t: t)(x).argmax(dim=-1)  # the clean predictions

    def flags(m, rows):
        """5 APGD-CE iterations' robust flags."""
        res = apgd_attack(logits_of(m, rows), rows(x), rows(y), criterion=lambda o, t: ce_loss(o, t, reduction="none"),
                          eps=a["eps"], n_iter=5, norm="linf")
        return res.acc

    rec["y"] = y.numpy()
    rec["flags"] = gather_batch(flags(model, lambda t: batch_sharding(mesh, t)), mesh).numpy()
    rec["ref_flags"] = flags(ref, lambda t: t).numpy()
    rec["split"] = {"vision": [b.tp is not None for b in model.vision.blocks],
                    "perceiver_attn": [lyr.attn.tp is not None for lyr in model.perceiver.layers],
                    "perceiver_ff": [lyr.ff.tp is not None for lyr in model.perceiver.layers],
                    "xattn_attn": [x.attn.tp is not None for x in model.xattn],
                    "xattn_ff": [x.ff.tp is not None for x in model.xattn],
                    "lm": [b.tp is not None for b in model.mpt.blocks]}
    full = _full(ref)
    rec["to_kv_local_equal"] = [_local_columns(mesh, full, f"{n}.to_kv", mod.to_kv, 2)
                                for n, mod in (("perceiver.layers.0.attn", model.perceiver.layers[0].attn),
                                               ("xattn.0.attn", model.xattn[0].attn)) if mod.tp is not None]
    rec["state"] = _full(model)
    return rec


def _tp_blip2(mesh, d):
    from robustvlm_tpu_torch.models.blip2 import model as PB
    from robustvlm_tpu_torch.models.blip2.convert import params_from_jax

    cfg = PB.BLIP2_CONFIGS["test-tiny"]

    def build():
        return PB.Blip2.from_state(cfg, params_from_jax(d["tree"]))

    def loss_fn(m, x, t, mask):
        return PB.blip2_per_sample_loss(m, x, t, t, mask, compute_dtype=torch.float32)

    ref = build()
    model, rec = _held_split(mesh, build, loss_fn, (d["x"], d["tokens"], d["mask"]))
    rec["tokens"] = _tokens(model, PB.make_blip2_decode_fns, d["gen_x"], d["seqs"], 1)
    rec["ref_tokens"] = _tokens(ref, PB.make_blip2_decode_fns, d["gen_x"], d["seqs"], 1)
    q = model.qformer.layers
    rec["split"] = {"vision": [b.tp is not None for b in model.visual.blocks],
                    "qformer_attn": [lyr.self_attn.tp is not None for lyr in q]
                    + [lyr.cross.tp is not None for lyr in q if lyr.cross is not None],
                    "qformer_ffn": [lyr.ffn.tp is not None for lyr in q],
                    "projection": model.language_projection.tp is not None,
                    "lm": [b.tp is not None for b in model.opt.blocks], "lm_head": model.opt.tp is not None}
    rec["state"] = _full(model)
    return rec


def _tp_tower(mesh, d, build):
    """Image and text embeddings (normalized) of a split tower pair against
    the same model unsplit; `text(model, rows)` encodes the text rows."""
    from robustvlm_tpu_torch.ops.image import normalize_clip
    from robustvlm_tpu_torch.parallel.mesh import batch_sharding, gather_batch, shard_params, sharded_call

    def encode(model, rows):
        x = normalize_clip(rows(torch.from_numpy(d["x"])))
        img = sharded_call(model, model.encode_image, x, normalize=True)
        toks = [rows(torch.from_numpy(t)) for t in d["text"]]
        return img, sharded_call(model, model.encode_text, *toks, normalize=True)

    with torch.no_grad():
        ref_img, ref_txt = encode(build(), lambda t: t)
        model = shard_params(build(), mesh)
        img, txt = gather_batch(encode(model, lambda t: batch_sharding(mesh, t)), mesh)
    return model, {"img": img.numpy(), "txt": txt.numpy(), "ref_img": ref_img.numpy(), "ref_txt": ref_txt.numpy(),
                   "bytes": _local_bytes(model), "state": _full(model)}


def _tp_convnext(mesh, d):
    from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, params_from_jax

    def build():
        model = CLIP(CLIP_CONFIGS["test-tiny-convnext"])
        model.load_state_dict(params_from_jax(d["tree"]))
        return model

    model, rec = _tp_tower(mesh, d, build)
    rec["split"] = {"vision": [b.tp is not None for s in model.visual.stages for b in s.blocks],
                    "text": [b.tp is not None for b in model.text.blocks]}
    return rec


def _tp_bert(mesh, d):
    """ja_clip or mclip (the JaCLIP config `d["config"]`)."""
    from robustvlm_tpu_torch.models.clip import params_from_jax
    from robustvlm_tpu_torch.models.jaclip import JACLIP_CONFIGS, JaCLIP
    from robustvlm_tpu_torch.models.mclip import MCLIP_CONFIGS

    cfg = {**JACLIP_CONFIGS, **MCLIP_CONFIGS}[d["config"]]

    def build():
        model = JaCLIP(cfg)
        model.load_state_dict(params_from_jax(d["tree"]))
        return model

    model, rec = _tp_tower(mesh, d, build)
    rec["split"] = {"vision": [b.tp is not None for b in model.visual.blocks],
                    "text": [b.tp is not None for b in model.text.blocks],
                    "projection": getattr(model.text_projection, "tp", None) is not None}
    return rec


_TP_FAMILIES = {"llava_mpt": _tp_llava_mpt, "flamingo": _tp_flamingo, "blip2": _tp_blip2,
                "convnext": _tp_convnext, "ja_clip": _tp_bert, "mclip": _tp_bert}


def tp_family_world(rank, world, mesh_shape, families):
    """One mesh (data, fsdp, model) with `model` > 1, float32 on the CPU: for
    each family in `families` (name -> its weights and inputs) the split
    model's results (this rank's rows, gathered) beside the same model
    unsplit on the whole batch:
      llava_mpt, flamingo, blip2 - the per-sample loss and pixel gradient,
          greedy tokens (flamingo: and 3-beam tokens, and 5 APGD
          iterations' robust flags), which modules split; llava_mpt and
          flamingo the ALiBi slopes and q shape of each flash call, block
          0's local wqkv (llava_mpt) and the local to_kv columns (flamingo);
      convnext, ja_clip, mclip - image and text embeddings, which blocks
          split;
    and every family's per-parameter local bytes and its state_dict."""
    from robustvlm_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(*mesh_shape, device="cpu")
    return {"coords": mesh.coords, **{name: _TP_FAMILIES[name](mesh, d) for name, d in families.items()}}
