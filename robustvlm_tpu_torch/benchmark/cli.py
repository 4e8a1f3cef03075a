"""Zero-shot benchmark CLI: models x datasets x languages, one task a run.

Counterpart of `python -m robustvlm_tpu.benchmark.cli`, with the same flags
and `--device` (`cuda` unless `--device cpu` is given; without a GPU it
raises):

  python -m robustvlm_tpu_torch.benchmark.cli eval \\
      --model ViT-B-32 --pretrained /ckpt/openai_b32.pt \\
      --dataset cifar10 --dataset_root /data/cifar10 \\
      --task zeroshot_classification --attack aa --eps 2 \\
      --output results/{model}_{dataset}_{task}.json

Tasks: zeroshot_classification (clean, or `--attack aa`: APGD-CE then
APGD-T), zeroshot_retrieval, image_caption_selection, linear_probe and
captioning (scores a predictions json). Model families: the CLIP configs
(ViT and ConvNeXt towers), `ja_clip-*` (rinna's Japanese CLIP) and the
`xlm-roberta-*` multilingual rows (`models/mclip.py`); `--pretrained
random` draws the weights on the device from seed 0. `--model` and
`--dataset` take comma lists or `@file` (one entry a line; a file row may
pair `model,pretrained`). eps is in /255. Under `--compute_dtype bfloat16`
the attacked tower holds its matrices in bf16 and its 1-D parameters in
float32 (`models/clip/model.cast_matrices_`).
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from robustvlm_tpu_torch.device import resolve_device, use_full_fp32


def _expand(arg: str) -> List[str]:
    if arg.startswith("@"):
        return [
            line.strip() for line in Path(arg[1:]).read_text().splitlines()
            if line.strip() and not line.startswith("#")
        ]
    return [a for a in arg.split(",") if a]


def build_parser():
    p = argparse.ArgumentParser(description="zero-shot benchmark suite (PyTorch/CUDA)")
    p.add_argument("command", choices=["eval"], nargs="?", default="eval")
    p.add_argument("--model", default="ViT-B-32", help="comma list or @file of model names")
    p.add_argument("--pretrained", default="",
                   help="comma list or @file of checkpoints (parallel to --model; "
                        "'random' = random init)")
    p.add_argument("--dataset", default="cifar10", help="comma list or @file")
    p.add_argument("--dataset_root", default=".")
    p.add_argument("--retrieval_annotations", default="",
                   help="captions json for the retrieval and caption-selection tasks")
    p.add_argument("--split", default="test")
    p.add_argument("--task", default="zeroshot_classification",
                   choices=["zeroshot_classification", "zeroshot_retrieval", "linear_probe",
                            "image_caption_selection", "captioning"])
    p.add_argument("--language", default="en", help="comma list of prompt/classname languages")
    p.add_argument("--predictions", default="",
                   help="captioning task: json [{image_id, caption}] to score")
    p.add_argument("--attack", default=None, choices=[None, "none", "aa"])
    p.add_argument("--eps", type=float, default=2.0, help="in /255 units")
    p.add_argument("--n_iter", type=int, default=100)
    p.add_argument("--n_samples", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--template", default="ensemble", choices=["std", "ensemble"])
    p.add_argument("--bpe_path", default="")
    p.add_argument("--compute_dtype", default="float32")
    p.add_argument("--output", default="{model}_{dataset}_{task}.json")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def _bare_dataset_name(dataset: str) -> str:
    """Strip the wds/tfds/vtab namespaces: the classname and template tables
    are keyed on the bare dataset name."""
    bare = dataset.split("/", 1)[1] if dataset.startswith(("wds/", "tfds/", "vtab/")) else dataset
    return bare.split("/")[-1] if bare.startswith("vtab/") else bare


def _clip_tokenizer(args, cfg):
    from robustvlm_tpu_torch.models.clip.tokenizer import get_tokenizer

    tok = get_tokenizer(args.bpe_path or None, cfg.context_length, cfg.vocab_size)
    return lambda texts: torch.from_numpy(tok(texts)).long()


def build_model(args, model_name: str, pretrained: str, device):
    """(model, CLIP config of its vision side, tokenize, build_classifier)
    for one model row: a CLIP config, a `ja_clip-*` or an mclip row."""
    from robustvlm_tpu_torch.benchmark import zeroshot
    from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, load_clip_checkpoint
    from robustvlm_tpu_torch.models.jaclip import JACLIP_CONFIGS, JaCLIP
    from robustvlm_tpu_torch.models.mclip import MCLIP_CONFIGS

    weights = pretrained and pretrained != "random"
    if model_name in MCLIP_CONFIGS or model_name.startswith("ja_clip"):
        if args.task != "zeroshot_classification":
            raise NotImplementedError(
                f"{model_name}: the BERT-family text towers support zeroshot_classification "
                "(the reference benchmarks them there only)")
        if model_name in MCLIP_CONFIGS:
            from robustvlm_tpu_torch.models.mclip import (
                build_mclip_text_classifier as build_text,
                get_mclip_tokenizer as get_tok,
                import_open_clip_mclip as importer,
            )

            jcfg = MCLIP_CONFIGS[model_name]
        else:
            from robustvlm_tpu_torch.models.jaclip import build_ja_text_classifier as build_text
            from robustvlm_tpu_torch.models.jaclip import get_ja_tokenizer as get_tok
            from robustvlm_tpu_torch.models.jaclip.import_torch import import_rinna_jaclip as importer

            stripped = model_name.removeprefix("ja_clip-")
            key = model_name if model_name in JACLIP_CONFIGS else stripped
            if key not in JACLIP_CONFIGS:
                raise KeyError(f"unknown ja_clip model {model_name!r}; known: {sorted(JACLIP_CONFIGS)}")
            jcfg = JACLIP_CONFIGS[key]
        model = JaCLIP(jcfg, device=device)
        if weights:
            model.load_state_dict(importer(pretrained, jcfg))
        else:
            model.init_random_(0)
        # --bpe_path doubles as the local HF tokenizer directory
        tokenize = get_tok(args.bpe_path or None, jcfg)
        return model, jcfg.vision, tokenize, lambda names, tpls: build_text(model, tokenize, names, tpls)
    cfg = CLIP_CONFIGS[model_name]
    model = CLIP(cfg, device=device).init_random_(0)
    if weights:
        model.load_state_dict(load_clip_checkpoint(pretrained, cfg, base=model.state_dict()))
    tokenize = _clip_tokenizer(args, cfg)
    return model, cfg, tokenize, lambda names, tpls: zeroshot.zero_shot_classifier(model, tokenize, names, tpls)


def _captioning(args) -> dict:
    """Score-only: generated captions (json [{image_id, caption}]) against
    the reference annotations."""
    from robustvlm_tpu_torch.benchmark.captioning import score_captions
    from robustvlm_tpu_torch.vlm_eval.datasets import load_caption_annotations

    preds = {p["image_id"]: p["caption"] for p in json.loads(Path(args.predictions).read_text())}
    refs_by_id = load_caption_annotations(args.retrieval_annotations)
    ids = [i for i in preds if i in refs_by_id]
    return score_captions([preds[i] for i in ids], [refs_by_id[i] for i in ids])


def _classification_data(args, dataset: str, size: int):
    """(batched data, dataset-provided classnames, templates): wds roots
    and tfds/vtab datasets carry their own metadata, which wins over the
    shipped tables."""
    from robustvlm_tpu_torch.benchmark import builder

    if dataset.startswith("wds/"):
        if builder._is_url(args.dataset_root) or Path(args.dataset_root, args.split, "nshards.txt").exists():
            wds = builder.WdsDataset(args.dataset_root, split=args.split, size=size)
            return wds.batched(args.batch_size), wds.classes, wds.templates
    elif dataset.startswith(("tfds/", "vtab/")):
        from robustvlm_tpu_torch.benchmark.tfds_adapter import build_tfds_dataset, build_vtab_dataset

        build = build_tfds_dataset if dataset.startswith("tfds/") else build_vtab_dataset
        ds = build(dataset.split("/", 1)[1], args.dataset_root or None, split=args.split, size=size,
                   n_samples=args.n_samples)
        return ds.batched(args.batch_size), ds.classes, None
    data = builder.build_dataset(dataset, args.dataset_root, split=args.split, size=size,
                                 batch_size=args.batch_size, n_samples=args.n_samples)
    return data, None, None


def run_one(args, model_name: str, pretrained: str, dataset: str, language: str = "en",
            device=None) -> dict:
    from robustvlm_tpu_torch.benchmark import builder, templates, zeroshot
    from robustvlm_tpu_torch.eval.classifier import make_embedding_fn, make_zero_shot_classifier
    from robustvlm_tpu_torch.models.clip.model import cast_matrices_

    head = {"model": model_name, "pretrained": pretrained, "dataset": dataset, "task": args.task,
            "language": language}
    if args.task == "captioning":
        return {**head, "metrics": _captioning(args)}

    device = resolve_device(device or args.device)
    # --dataset_root may be a template over the dataset name, e.g.
    # "hf://clip-benchmark/wds_{dataset_cleaned}" for the 13-dataset suite
    ds_name = dataset.removeprefix("wds/")
    args = argparse.Namespace(**{**vars(args), "dataset_root": args.dataset_root.format(
        dataset=ds_name, dataset_cleaned=ds_name.replace("/", "-"))})
    model, cfg, tokenize, build_classifier = build_model(args, model_name, pretrained, device)
    size = 32 if dataset == "cifar10" else cfg.image_size
    bare = _bare_dataset_name(dataset)
    table_name = bare if dataset != "synthetic" else "cifar10"

    t0 = time.time()
    if args.task == "zeroshot_classification":
        data, ds_classes, ds_templates = _classification_data(args, dataset, size)
        classnames = ds_classes or templates.get_classnames(table_name, language=language)
        tpls = ((ds_templates or templates.get_templates(bare, language=language))
                if args.template == "ensemble" else [templates.STD_TEMPLATE])
        classifier = build_classifier(classnames, tpls)
        compute_dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
        # the attacked tower's matrices in the compute dtype once; its 1-D
        # parameters stay float32, as the JAX package applies them
        cast_matrices_(model.visual, compute_dtype)
        # CIFAR-10 is attacked at its native 32 px, resized inside the model
        logits_fn = make_zero_shot_classifier(
            model, classifier, resize_to=cfg.image_size if size != cfg.image_size else None,
            compute_dtype=compute_dtype)
        attack = args.attack if args.attack not in (None, "none") else None
        metrics = zeroshot.run_classification(
            logits_fn, data, attack=attack, eps=args.eps / 255.0, n_iter=args.n_iter,
            n_samples=args.n_samples, batch_size=args.batch_size, verbose=args.verbose, device=device)
    elif args.task in ("zeroshot_retrieval", "image_caption_selection"):
        from robustvlm_tpu_torch.benchmark.retrieval import (
            encode_corpus,
            evaluate_image_caption_selection,
            evaluate_retrieval,
        )
        from robustvlm_tpu_torch.vlm_eval.datasets import CaptionDataset

        # --dataset_root is the image dir, --retrieval_annotations a
        # COCO/karpathy-style captions json
        ds = CaptionDataset(args.dataset_root, args.retrieval_annotations, size=size,
                            n_samples=args.n_samples)
        image_fn = make_embedding_fn(model, output_normalize=True)

        def text_fn(toks):
            return model.encode_text(toks, normalize=True)

        def batches():
            for i in range(0, len(ds), args.batch_size):
                items = [ds[j] for j in range(i, min(i + args.batch_size, len(ds)))]
                yield np.stack([it["image"] for it in items]), [it["all_captions"] for it in items]

        if args.task == "zeroshot_retrieval":
            im, tx, t2i = encode_corpus(image_fn, text_fn, batches(), tokenize,
                                        batch_size=args.batch_size, device=device)
            metrics = evaluate_retrieval(im, tx, t2i)
        else:
            metrics = evaluate_image_caption_selection(image_fn, text_fn, batches(), tokenize,
                                                       device=device)
    elif args.task == "linear_probe":
        from robustvlm_tpu_torch.benchmark.linear_probe import evaluate_linear_probe

        def split_data(split):
            return builder.build_dataset(dataset, args.dataset_root, split=split, size=size,
                                         batch_size=args.batch_size, n_samples=args.n_samples)

        n_classes = len(templates.get_classnames(table_name))
        metrics = evaluate_linear_probe(make_embedding_fn(model, output_normalize=True),
                                        split_data("train"), split_data(args.split), n_classes=n_classes,
                                        device=device)
    else:
        raise ValueError(f"unknown task {args.task}")
    return {**head, "metrics": metrics, "eps": args.eps, "attack": args.attack,
            "wall_s": round(time.time() - t0, 2)}


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    use_full_fp32()
    models = _expand(args.model)
    if any("," in m for m in models):
        # @file rows may pair "model,pretrained" on one line
        if args.pretrained:
            raise ValueError("model,pretrained @file rows and --pretrained are mutually exclusive: "
                             "put the checkpoint in the file row")
        rows = [m.split(",", 1) for m in models]
        models = [r[0].strip() for r in rows]
        pretrained = [r[1].strip() if len(r) > 1 else "" for r in rows]
    else:
        pretrained = _expand(args.pretrained) if args.pretrained else [""] * len(models)
        if len(pretrained) == 1 and len(models) > 1:
            pretrained = pretrained * len(models)  # one checkpoint, many architectures
        if len(pretrained) != len(models):
            raise ValueError(f"--model has {len(models)} entries but --pretrained has {len(pretrained)}; "
                             "they pair positionally (a single --pretrained broadcasts)")
    datasets = _expand(args.dataset)
    languages = _expand(args.language) or ["en"]

    def out_path(m, pt, ds, lang):
        stem = args.output.format(model=m, dataset=ds.replace("/", "_"), task=args.task, language=lang,
                                  pretrained=Path(pt).stem if pt else "random")
        if len(languages) > 1 and "{language}" not in args.output:
            p = Path(stem)  # the language tag goes on the file name, not the directory
            return p.with_name(f"{lang}_{p.name}")
        return Path(stem)

    runs = list(itertools.product(zip(models, pretrained), datasets, languages))
    paths = [out_path(m, pt, ds, lang) for (m, pt), ds, lang in runs]
    if len(set(map(str, paths))) != len(paths):
        raise ValueError("--output template maps multiple runs to the same file "
                         "(same model, different checkpoints?); add {pretrained} to it")
    results = []
    for ((m, pt), ds, lang), out in zip(runs, paths):
        res = run_one(args, m, pt, ds, language=lang, device=device)
        results.append(res)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=2))
        print(json.dumps(res))
    return results


if __name__ == "__main__":
    main()
