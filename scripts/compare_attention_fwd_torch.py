#!/usr/bin/env python3
"""Time the bf16 flash forward and the float32 ViT forward of this checkout
against another checkout's (an older commit unpacked by `git archive`), on
one GPU, in one process.

    python3 scripts/compare_attention_fwd_torch.py OTHER_ROOT

Each checkout's `vit_attention.cu` and `flash_attention.cu` are compiled
with that checkout's own headers (copied beside the sources, which quoted
includes find first) under `build/compare/<side>/`. Both forwards are held
against this checkout's plain versions (the limits of `chip_smoke.py`) and
timed by CUDA-graph replay at the main paths' shapes, the float32 ViT
forward at ViT-L/14 (B*H = 128, N = 257, D = 64) and the bf16 flash forward
at the LLaVA-1.5-7B LM layer (32, 665, 128, causal), in turns: other, this,
this, other. One JSON line per side and kernel, then the card's name and
power limit. Exits 1 if either side disagrees. Needs a GPU.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCES = ("vit_attention", "flash_attention")


def build(side: str, root: Path) -> dict:
    """{source name: bound library} built from `root`'s csrc/."""
    from robustvlm_tpu_torch.ops.kernels import _build, flash_attention, vit_attention

    csrc = root / "robustvlm_tpu_torch" / "csrc"
    out = ROOT / "build" / "compare" / side
    out.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    built = _build.build_variants({name: (csrc / f"{name}.cu").read_text() for name in SOURCES}, out, "k")
    binders = {"vit_attention": vit_attention.bind, "flash_attention": flash_attention.bind}
    return {name: binders[name](lib) for name, (lib, _) in built.items()}


def main() -> int:
    import torch

    import chip_smoke as C
    from robustvlm_tpu_torch.device import use_full_fp32
    from robustvlm_tpu_torch.ops.kernels import flash_attention as F
    from robustvlm_tpu_torch.ops.kernels import vit_attention as A

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    use_full_fp32()
    libs = {"other": build("other", Path(sys.argv[1]).resolve()), "this": build("this", ROOT)}

    def stream():  # read at each launch: a graph capture runs on a stream of its own
        return torch.cuda.current_stream().cuda_stream

    q, k, v, _ = C._qkv(257, torch.float32, seed=1)
    bh, n, d = q.shape
    vit_ref = A.attention_fwd_plain(q, k, v)
    (fq, fk, fv, _), _ = C._flash_inputs(*C._flash_llava_shape(), torch.bfloat16, seed=1)
    flash_ref = F.flash_fwd_plain(fq, fk, fv, causal=True)

    def launchers(side):
        vit, flash = libs[side]["vit_attention"], libs[side]["flash_attention"]
        vo, vl = torch.empty_like(q), torch.empty(bh, n, device="cuda")
        fo, fl = torch.empty_like(fq), torch.empty(fq.shape[:2], device="cuda")
        dims = F._dims(fq, fk, True)
        return {
            "vit_attention_fwd[float32]": (
                lambda: vit.vit_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), vo.data_ptr(),
                                         vl.data_ptr(), bh, n, d, 0, 1.0 / d ** 0.5, stream()),
                (vo, vl), vit_ref, "float32"),
            "flash_attention_fwd[bfloat16]": (
                lambda: flash.flash_attn_fwd(fq.data_ptr(), fk.data_ptr(), fv.data_ptr(), fo.data_ptr(),
                                             fl.data_ptr(), None, *dims, stream()),
                (fo, fl), flash_ref, "bfloat16"),
        }

    runs = {side: launchers(side) for side in libs}
    rows, ok = {}, True
    for side, kernels in runs.items():
        for name, (fn, out, ref, dname) in kernels.items():
            if fn():
                raise RuntimeError(f"{side} {name}: launch failed")
            torch.cuda.synchronize()
            res = C._attn_check(dname, out, ref, False)
            within = all(w for _, w in res.values())
            ok &= within
            rows[(side, name)] = {"side": side, "kernel": name, "within": within, "ms": [],
                                  "max_abs_err": {o: e for o, (e, _) in res.items()}}
    for side in ("other", "this", "this", "other"):
        for name, (fn, _, _, _) in runs[side].items():
            rows[(side, name)]["ms"].append(C.time_graph_ms(fn))
    for row in rows.values():
        print(json.dumps(row), flush=True)
    print(C.card_line())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
