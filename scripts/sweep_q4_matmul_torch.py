#!/usr/bin/env python3
"""Sweep the q4_matmul kernel's shape at the LLaVA-1.5-7B decode step's
weights on one GPU.

    python3 scripts/sweep_q4_matmul_torch.py [--diagnose]

`robustvlm_tpu_torch/csrc/q4_matmul.cu` takes its shape from five lines:
kCols output columns a block (32 a warp), kStageRows packed rows a stage of
the cp.async ring, kStages stages, kCtasPerSm blocks an SM that the split
count aims at, and kMaxSplits, the most splits of K (the cluster size) by
batch tiles NB = 1..4. This builds one edited copy of the source per entry
of VARIANTS (an entry names only the lines it changes), all nvcc processes
at once, under `build/sweep/`, holds every variant against the plain
PyTorch version at every 7B shape and batch 1, 4 and 32, both bodies (the
limits of `chip_smoke.py`; two calls bitwise equal) and prints one JSON
line per variant and body: the device time of each (batch, K, N) by
CUDA-graph replay, each launch reading its weight from device memory (as
`chip_smoke.py` times it), the batch-1 and batch-4 decode steps' 225
launches summed against the batch-1 byte bound, and the compiler's
register and spill report; every variant timed twice in turns. Then the
card's name and power limit. Exits 1 if the source as it stands (variant 0)
misses a case. Needs a GPU.

--diagnose times the source as it stands beside copies with one part
changed, which say where its time goes (DIAGNOSES; those that drop work
give wrong outputs and are not checked): the shared-memory carveout set to
its largest, the copies only (no decode or product), the products only (no
copies: they run on whatever the ring holds), no distributed-shared-memory
reads (each block adds its own partial), that and no cluster barrier, and
no cluster at all (launched without the cluster attribute, with no
reduction or barrier). It also prints, for
the batch-1 kernel, the blocks an SM and the clusters the card holds at
once (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
cudaOccupancyMaxActiveClusters), from a function appended to every copy.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KNOBS = {  # knob: (its line, the line with the value in place of {})
    "kCols": (r"constexpr int kCols = (\d+);", "constexpr int kCols = {};"),
    "kStageRows": (r"constexpr int kStageRows = (\d+);", "constexpr int kStageRows = {};"),
    "kStages": (r"constexpr int kStages = (\d+);", "constexpr int kStages = {};"),
    "kCtasPerSm": (r"constexpr int kCtasPerSm = (\d+);", "constexpr int kCtasPerSm = {};"),
    "kMaxSplits": (r"constexpr int kMaxSplits\[4\] = \{([\d, ]+)\};",
                   "constexpr int kMaxSplits[4] = {{{}}};"),
}
# {knob: value}; {} is the source as it stands; kMaxSplits as (NB = 1, 2, 3, 4)
VARIANTS = [
    {},
    {"kCols": 64},
    {"kCols": 64, "kStages": 3},
    {"kCols": 64, "kStageRows": 128, "kStages": 2},
    {"kCols": 64, "kMaxSplits": (4, 4, 4, 2)},
    {"kCols": 64, "kCtasPerSm": 2},
    {"kCols": 32},
    {"kCols": 32, "kCtasPerSm": 8},
    {"kStageRows": 128, "kStages": 2},
]
BATCHES = (1, 4, 32)

_REDUCE = ("v[src] = cluster.map_shared_rank(part, src)[e];", "v[src] = part[e];")
_SYNCS = [("cluster.sync();  // every block's partials are written", ""),
          ("cluster.sync();  // no block leaves while a peer may still read its partials", "")]
# name: [(text of the source, its replacement)]
DIAGNOSES = {
    "source": [],
    "carveout_max_shared": [(
        "  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);",
        "  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,\n"
        "                       cudaSharedmemCarveoutMaxShared);\n"
        "  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);")],
    "copies_only": [("for (int kk = 0; kk < SR / 16; ++kk) {", "for (int kk = 0; kk < 0; ++kk) {")],
    "products_only": [("cp_async16(dst + w_smem[i], src + w_glob[i]);", "{}"),
                      ("cp_async16(dst + x_smem[i], xsrc + x_glob[i]);", "{}")],
    "no_reduction": [_REDUCE],
    "no_cluster_sync": [_REDUCE, *_SYNCS],
    "no_cluster": [_REDUCE, *_SYNCS, ("cfg.numAttrs = 1;", "cfg.numAttrs = 0;")],
}
OCCUPANCY = '''
extern "C" int q4_occupancy(int splits, int tiles, int* out) {
  auto kernel = q4_matmul_kernel<1, kStageRows, false, true>;
  constexpr int kSmem = Ring<1, kStageRows>::kSmem;
  prepare(kernel, kSmem);
  int blocks = 0, clusters = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kQThreads, kSmem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, tiles, 1);
  cfg.blockDim = dim3(kQThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  out[0] = blocks;
  out[1] = clusters;
  return err;
}
'''


def diagnose() -> int:
    import ctypes

    import torch

    import chip_smoke as S
    from robustvlm_tpu_torch.ops.kernels import _build, q4_matmul

    src = (_build.CSRC / "q4_matmul.cu").read_text()
    sources = {}
    for name, edits in DIAGNOSES.items():
        v = src
        for a, b in edits:
            if a not in v:
                raise RuntimeError(f"{name}: {a!r} not in q4_matmul.cu")
            v = v.replace(a, b)
        sources[name] = v + OCCUPANCY
    libs = {k: q4_matmul.bind(lib) for k, (lib, _) in
            _build.build_variants(sources, ROOT / "build" / "sweep", "q4d").items()}
    occ = libs["source"].q4_occupancy
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for splits in (1, 2, 4, 8):
        out = (ctypes.c_int * 2)()
        err = occ(splits, 32, ctypes.addressof(out))
        print(json.dumps({"kernel": "q4_matmul_kernel<1, group, bf16 out>", "splits": splits,
                          "blocks_per_sm": out[0], "max_active_clusters": out[1], "err": err}))
    weights, xs = weights_and_inputs()
    print(json.dumps({"source_within_and_repeatable": check(libs["source"], weights, xs, True)}))
    runs = {}
    for _ in range(2):
        for name, lib in libs.items():
            runs.setdefault(name, []).append(time_shapes(lib, weights, xs, True, (1,)))
    for name, r in runs.items():
        print(json.dumps({"script": "scripts/sweep_q4_matmul_torch.py --diagnose", "copy": name,
                          "body": "group", "step_ms_b1": [step_ms(m, 1) for m in r],
                          "ms_per_shape": r}), flush=True)
    print(S.card_line())
    return 0


def edit(src: str, change: dict) -> str:
    for knob, value in change.items():
        pat, line = KNOBS[knob]
        text = ", ".join(map(str, value)) if isinstance(value, tuple) else str(value)
        src, n = re.subn(pat, line.format(text), src)
        if n != 1:
            raise RuntimeError(f"{knob} not found once in q4_matmul.cu")
    return src


def build(variants):
    from robustvlm_tpu_torch.ops.kernels import _build, q4_matmul

    src = (_build.CSRC / "q4_matmul.cu").read_text()
    in_source = {k: re.search(pat, src).group(1) for k, (pat, _) in KNOBS.items()}
    sources = {i: edit(src, change) for i, change in enumerate(variants)}
    libs = {}
    for i, (lib, log) in _build.build_variants(sources, ROOT / "build" / "sweep", "q4").items():
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers", log)})
        spills = sorted({int(m) for m in re.findall(r"(\d+) bytes spill stores", log)})
        libs[i] = (q4_matmul.bind(lib), {"registers": regs, "spill_store_bytes": spills})
    return libs, in_source


def call(lib, x, p, s, group):
    """One launch of a bound library's kernel on (x, p, s) -> out (x's dtype)."""
    import torch

    out = torch.empty(x.shape[0], p.shape[1], dtype=x.dtype, device=x.device)
    err = lib.q4_matmul(x.data_ptr(), p.data_ptr(), s.data_ptr(), out.data_ptr(), x.shape[0],
                        p.shape[0], p.shape[1], s.shape[0] // 2, int(x.dtype == torch.bfloat16),
                        int(not group), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"q4_matmul launch failed: cudaError {err}")
    return out


def weights_and_inputs():
    """{(K, N): rotated (p, s) copies} at chip_smoke.py's 7B shapes, and
    {(B, K): bf16 x}, from seed 4."""
    import torch

    import chip_smoke as S
    from robustvlm_tpu_torch.ops.quant import quantize_q4

    gen = torch.Generator(device="cuda").manual_seed(4)
    weights = {}
    for k, n, _ in S.Q4_SHAPES:
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        qw = quantize_q4(w, group_size=S.Q4_GROUP)
        weights[k, n] = S._rotating(lambda: (qw.p.clone(), qw.s.clone()), qw.p.numel() + qw.s.numel() * 4)
        del w, qw
    xs = {(b, k): (torch.randn(b, k, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
          for b in BATCHES for k in (4096, 11008)}
    return weights, xs


def check(lib, weights, xs, group) -> bool:
    """Within the limits of chip_smoke.py and bitwise repeatable at every
    shape and batch."""
    import chip_smoke as S
    from robustvlm_tpu_torch.ops.kernels import q4_matmul as Q

    ok = True
    for (k, n), copies in weights.items():
        p, s = copies[0]
        for b in BATCHES:
            x = xs[b, k]
            got = call(lib, x, p, s, group)
            ok &= bool((got == call(lib, x, p, s, group)).all())
            ok &= S._q4_within(got, Q.q4_matmul_reference(x, p, s, group=group), "bfloat16")[1]
    return ok


def time_shapes(lib, weights, xs, group, batches=BATCHES) -> dict:
    """{"BxKxN": ms} by CUDA-graph replay, each launch on the next rotated copy."""
    import chip_smoke as S

    ms = {}
    for (k, n), copies in weights.items():
        for b in batches:
            x = xs[b, k]
            it = iter(range(10**9))
            ms[f"{b}x{k}x{n}"] = S.time_graph_ms(
                lambda: call(lib, x, *copies[next(it) % len(copies)], group))
    return ms


def step_ms(ms: dict, b: int) -> float:
    """A decode step's 225 launches at batch b, summed."""
    import chip_smoke as S

    return sum(count * ms[f"{b}x{k}x{n}"] for k, n, count in S.Q4_SHAPES)


def step_bound_ms(weights, peaks) -> float:
    import chip_smoke as S

    total = 0.0
    for k, n, count in S.Q4_SHAPES:
        p, s = weights[k, n][0]
        total += count * S.bound_ms(2 * k + p.numel() + s.numel() * 4 + 2 * n, 2 * k * n, "bfloat16",
                                    peaks)[0]
    return total


def main(argv=None) -> int:
    import torch

    import chip_smoke as S

    ap = argparse.ArgumentParser()
    ap.add_argument("--diagnose", action="store_true", help="time copies with one part changed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if args.diagnose:
        return diagnose()
    peaks = S.peaks_for(torch.cuda.get_device_name(0))
    libs, in_source = build(VARIANTS)
    weights, xs = weights_and_inputs()
    bound = step_bound_ms(weights, peaks)
    ok = {(i, g): check(lib, weights, xs, g) for i, (lib, _) in libs.items() for g in (True, False)}
    runs = {}
    for _ in range(2):  # every variant twice, in turns
        for i, (lib, _) in libs.items():
            for group in (True, False):
                runs.setdefault((i, group), []).append(time_shapes(lib, weights, xs, group))
    for (i, group), r in runs.items():
        print(json.dumps({"script": "scripts/sweep_q4_matmul_torch.py", "variant": i,
                          "change": {k: v for k, v in VARIANTS[i].items()}, "source": in_source,
                          "body": "group" if group else "shift", "ok": ok[i, group],
                          "step_ms_b1": [step_ms(m, 1) for m in r],
                          "step_ms_b4": [step_ms(m, 4) for m in r],
                          "step_bound_ms_b1": bound, "ms_per_shape": r, **libs[i][1]}), flush=True)
    print(S.card_line())
    return 0 if ok[0, True] and ok[0, False] else 1


if __name__ == "__main__":
    sys.exit(main())
