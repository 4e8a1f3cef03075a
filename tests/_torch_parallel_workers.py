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
    """name -> full numpy value (DTensors gathered)."""
    from torch.distributed.tensor import DTensor

    out = {}
    for n, p in model.named_parameters():
        t = p.full_tensor() if isinstance(p, DTensor) else p
        out[n] = t.detach().cpu().numpy().copy()
    return out


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
    (1, 2, 2), each with the same model unsharded."""
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

    mesh = make_mesh(data=1, fsdp=2, model=2, device="cpu")

    def pixel_grad(model, loss_fn, xx, *args):
        xa = xx.clone().requires_grad_(True)
        loss = sharded_call(model, loss_fn, model, xa, *args)
        (g,) = torch.autograd.grad(loss.sum(), xa)
        return loss.detach(), g

    def held(build, loss_fn, xx, *args):
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
