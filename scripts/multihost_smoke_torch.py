"""Multi-process smoke test of the port's `parallel/multihost.py` over a real
process group: the counterpart of scripts/multihost_smoke.py.

    torchrun --nproc_per_node 2 scripts/multihost_smoke_torch.py --device cpu   # gloo
    torchrun --nproc_per_node 2 scripts/multihost_smoke_torch.py                # NCCL, a card a rank

Without torchrun, `--store FILE` opens the group over a FileStore, with the
rank and world size from RANK and WORLD_SIZE. Each process prints PASS or
FAIL for:
  1. coverage: every example of the dataset owned by exactly one process
     (`process_shard_indices`);
  2. the merge: `all_gather_results` gives every process's result dict on
     every process, this process's own byte-exact after the JSON round trip;
  3. the count-weighted metric merge equals the global mean
     (`merge_metric_means`);
  4. a computation on the process's device feeding the gather.
and exits 0 only when all pass.
"""

import argparse
import datetime
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--store", default="", help="a FileStore path instead of torchrun's env://")
    p.add_argument("--timeout_s", type=float, default=120.0, help="a collective's time limit")
    args = p.parse_args(argv)

    from robustvlm_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=args.timeout_s)
    if args.store:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        dist.init_process_group(backend, store=dist.FileStore(args.store, world), rank=rank,
                                world_size=world, timeout=timeout)
    else:
        dist.init_process_group(backend, timeout=timeout)
    try:
        return check(dev)
    finally:
        dist.destroy_process_group()


def check(dev: torch.device) -> int:
    from robustvlm_tpu_torch.parallel.multihost import (
        all_gather_results,
        merge_metric_means,
        process_shard_indices,
    )

    p, i = dist.get_world_size(), dist.get_rank()
    n_items = 10 * p + 3  # deliberately not divisible by the process count
    idx = process_shard_indices(n_items)
    print(f"[smoke] process {i}/{p}: owns {idx.min()}..{idx.max()} ({idx.size} items) on {dev}", flush=True)

    # (4) a computation on this process's device
    local_sum = float(torch.sum(torch.as_tensor(idx, dtype=torch.float64, device=dev) ** 2))
    local = {"process": i, "indices": idx, "mean_sq": local_sum / idx.size, "count": int(idx.size)}
    gathered = all_gather_results(local)

    ok = True
    # (2) every process's dict, in rank order, this one's byte-exact
    if [d["process"] for d in gathered] != list(range(p)):
        ok = False
        print(f"FAIL: gathered processes {[d['process'] for d in gathered]} != 0..{p - 1}")
    mine = json.loads(json.dumps({**local, "indices": idx.tolist()}))
    if json.dumps(gathered[i], sort_keys=True) != json.dumps(mine, sort_keys=True):
        ok = False
        print("FAIL: this process's merged entry differs from its result")
    if any(d["indices"] != process_shard_indices(n_items, j, p).tolist() for j, d in enumerate(gathered)):
        ok = False
        print("FAIL: a merged entry's indices are not its process's slice")

    # (1) exact coverage, no overlap
    all_idx = np.concatenate([np.asarray(d["indices"]) for d in gathered])
    if sorted(all_idx.tolist()) != list(range(n_items)):
        ok = False
        print("FAIL: dataset slices do not cover each example exactly once")

    # (3) weighted mean == global mean
    merged = merge_metric_means([{"mean_sq": d["mean_sq"]} for d in gathered], [d["count"] for d in gathered])
    expect = float(np.mean(np.arange(n_items, dtype=np.float64) ** 2))
    if abs(merged["mean_sq"] - expect) > 1e-9 * max(expect, 1.0):
        ok = False
        print(f"FAIL: merged mean_sq {merged['mean_sq']} != {expect}")

    print(f"[smoke] process {i}: {'PASS' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
