"""Robust CLIP model zoo: the published base-size checkpoints as a table.

Counterpart of `python -m robustvlm_tpu.eval.model_zoo`: given a directory
of checkpoints named `<row>.pt`, run the robustbench protocol
(`eval/robustbench.py`; `--full_benchmark` for AutoAttack's standard
cascade) on every row that has one, and print the zoo table with the
published zero-shot numbers beside the measured ones:

  python -m robustvlm_tpu_torch.eval.model_zoo --ckpt_dir /ckpts/zoo \\
      --dataset imagenet --imagenet_root /data/imagenet --n_ex 1000 --eps 2

A row without a checkpoint is skipped.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ZooEntry:
    name: str            # checkpoint stem: <ckpt_dir>/<name>.pt
    backbone: str        # CLIP config name
    pretrain: str        # 'openai' | 'laion2b'
    # published zero-shot accuracies (clean, eps=1, 2, 4 /255); None = unpublished
    published: Optional[Tuple[float, float, float, float]] = None


ZOO = [
    ZooEntry("tecoa1-vitb32-openai", "ViT-B-32", "openai", (53.1, 38.8, 26.6, 9.6)),
    ZooEntry("fare1-vitb32-openai", "ViT-B-32", "openai", (60.5, 38.0, 20.1, 2.9)),
    ZooEntry("tecoa4-vitb32-openai", "ViT-B-32", "openai", (44.0, 38.2, 33.1, 23.6)),
    ZooEntry("fare4-vitb32-openai", "ViT-B-32", "openai", (48.6, 40.6, 33.7, 21.9)),
    # LAION-2B pretrains use the GELU (-laion) configs, not OpenAI QuickGELU
    ZooEntry("tecoa4-vitb32-laion2b", "ViT-B-32-laion", "laion2b", (46.8, 40.6, 34.5, 23.3)),
    ZooEntry("fare4-vitb32-laion2b", "ViT-B-32-laion", "laion2b", (53.8, 44.4, 35.5, 21.2)),
    ZooEntry("tecoa4-vitb16-laion2b", "ViT-B-16-laion", "laion2b", (51.5, 45.0, 38.4, 26.4)),
    ZooEntry("fare4-vitb16-laion2b", "ViT-B-16-laion", "laion2b", (56.6, 47.7, 39.2, 23.5)),
    ZooEntry("tecoa4-convnextb-laion2b", "convnext_base_w", "laion2b", (56.2, 50.4, 44.1, 31.8)),
    ZooEntry("fare4-convnextb-laion2b", "convnext_base_w", "laion2b", (60.2, 52.3, 44.1, 28.4)),
]


def build_parser():
    p = argparse.ArgumentParser(description="robust CLIP model-zoo benchmark (PyTorch/CUDA)")
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--base_ckpt_dir", default="",
                   help="dir of full base ckpts <pretrain>_<backbone>.pt "
                        "providing text towers for visual-only zoo ckpts")
    p.add_argument("--models", default="", help="comma list of zoo names; default all with ckpts")
    p.add_argument("--dataset", default="imagenet", choices=["imagenet", "cifar10", "synthetic"])
    p.add_argument("--imagenet_root", default="data/imagenet")
    p.add_argument("--cifar10_root", default="data/cifar10")
    p.add_argument("--n_ex", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--eps", type=float, default=2.0, help="/255 units")
    p.add_argument("--n_iter", type=int, default=100)
    p.add_argument("--full_benchmark", action="store_true",
                   help="standard 4-attack cascade instead of apgd-ce+apgd-t")
    p.add_argument("--bpe_path", default="")
    p.add_argument("--host_loop", action="store_true", help="a JAX compile option; ignored")
    p.add_argument("--output_dir", default="out/model_zoo")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def run_zoo(args) -> Dict[str, Dict]:
    from robustvlm_tpu_torch.eval.robustbench import main as rb_main

    ckpt_dir = Path(args.ckpt_dir)
    wanted = set(args.models.split(",")) if args.models else None
    results: Dict[str, Dict] = {}
    for entry in ZOO:
        if wanted and entry.name not in wanted:
            continue
        ckpt = ckpt_dir / f"{entry.name}.pt"
        if not ckpt.exists():
            print(f"[zoo] skip {entry.name}: no checkpoint at {ckpt}")
            continue
        base_args = []
        if args.base_ckpt_dir:
            base = Path(args.base_ckpt_dir) / f"{entry.pretrain}_{entry.backbone}.pt"
            if base.exists():
                base_args = ["--base_pretrained", str(base)]
            else:
                print(f"[zoo] {entry.name}: no base checkpoint at {base} — "
                      "a visual-only zoo checkpoint will get a random text tower")
        argv = [
            "--clip_model_name", entry.backbone,
            "--pretrained", str(ckpt),
            "--dataset", args.dataset,
            "--imagenet_root", args.imagenet_root,
            "--cifar10_root", args.cifar10_root,
            "--n_ex", str(args.n_ex),
            "--batch_size", str(args.batch_size),
            "--eps", str(args.eps),
            "--n_iter", str(args.n_iter),
            "--bpe_path", args.bpe_path,
            "--output_dir", str(Path(args.output_dir) / entry.name),
            "--experiment_name", entry.name,
            "--device", args.device,
        ]
        argv.extend(base_args)
        if args.full_benchmark:
            argv.append("--full_benchmark")
        if args.host_loop:
            argv.append("--host_loop")
        results[entry.name] = rb_main(argv)
    return results


def format_table(results: Dict[str, Dict], eps: float) -> str:
    """The zoo table with the published numbers beside the measured ones."""
    pub_col = {1.0: 1, 2.0: 2, 4.0: 3}.get(eps)
    lines = [
        f"{'model':26s} {'backbone':10s} {'clean%':>8s} "
        f"{'racc%':>8s} {'pub-clean':>10s} {'pub-racc':>9s}"
    ]
    by_name = {e.name: e for e in ZOO}
    for name, res in results.items():
        e = by_name[name]
        pc = f"{e.published[0]:.1f}" if e.published else "-"
        pr = f"{e.published[pub_col]:.1f}" if e.published and pub_col is not None else "-"
        lines.append(
            f"{name:26s} {e.backbone:10s} {100 * res['clean_acc']:8.2f} "
            f"{100 * res['robust_acc']:8.2f} {pc:>10s} {pr:>9s}"
        )
    return "\n".join(lines)


def main(argv=None):
    args = build_parser().parse_args(argv)
    results = run_zoo(args)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "zoo_results.json").write_text(json.dumps(results, indent=2))
    table = format_table(results, args.eps)
    (out / "zoo_table.txt").write_text(table)
    print(table)
    return results


if __name__ == "__main__":
    main()
