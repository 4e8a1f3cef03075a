#!/usr/bin/env python3
"""Real-checkpoint parity gate for the port (it skips when no checkpoint is
given).

Records or checks a CLIP checkpoint's fingerprint: the embeddings of a
fixed synthetic image batch through the port's import and forward
(float32, TF32 off). The fingerprint's JSON format is the JAX package's
(`scripts/real_ckpt_parity.py`), so a record made by either package checks
in the other.

Record (once, against a trusted import):
  CLIP_CKPT=/ckpts/openai_vitl14.pt python3 scripts/real_ckpt_parity_torch.py \\
      --model ViT-L-14 --record expected_vitl14.json

Check (exit 1 on a mismatch; exit 0 and SKIP when $CLIP_CKPT is unset):
  CLIP_CKPT=/ckpts/openai_vitl14.pt python3 scripts/real_ckpt_parity_torch.py \\
      --model ViT-L-14 --expected expected_vitl14.json

Optional, end to end against the published tables: `--imagenet_dir
/data/imagenet/val --n_samples 1000 --eps 2 --bpe_path
bpe_simple_vocab_16e6.txt.gz` prints clean and APGD-CE/APGD-T robust
accuracy; `--llava_ckpt DIR --tokenizer_path DIR` runs the serving
quantization gate (fp against int8 and int4 greedy captions on the same
images: token agreement, exact-match rate, CIDEr with the fp captions as
references). Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def fingerprint(model, cfg, n_images: int = 4, n_dims: int = 16) -> dict:
    """Unit-norm embeddings (their first n_dims) of a fixed synthetic batch,
    and the norms before normalization."""
    import torch

    from robustvlm_tpu_torch.ops.image import normalize_clip

    dev = model.logit_scale.device
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(n_images, 3, cfg.image_size, cfg.image_size).astype(np.float32)).to(dev)
    with torch.no_grad():
        emb_raw = model.encode_image(normalize_clip(x), normalize=False, compute_dtype=torch.float32)
    norms = torch.linalg.norm(emb_raw, dim=-1)
    emb = emb_raw / norms[:, None]
    return {
        "model": cfg.name,
        "embed_head": emb[:, :n_dims].cpu().numpy().tolist(),
        "embed_norms": norms.cpu().numpy().tolist(),
    }


def compare(got: dict, expected: dict, atol: float = 1e-4) -> list:
    errs = []
    if got["model"] != expected["model"]:
        errs.append(f"model mismatch: {got['model']} != {expected['model']}")
    for key, tol in (("embed_head", atol), ("embed_norms", 1e-3)):
        g = np.asarray(got[key])
        e = np.asarray(expected[key])
        if g.shape != e.shape:
            errs.append(f"{key}: shape {g.shape} != {e.shape}")
            continue
        d = float(np.abs(g - e).max())
        if d > tol:
            errs.append(f"{key}: max abs diff {d:.2e} > {tol}")
    return errs


def load_real_checkpoint(args, device):
    """The port's CLIP with the checkpoint's weights: a full CLIP state dict
    alone, a visual-only overlay on --base_ckpt's text tower, or (with
    --visual_only and no base) on a random one."""
    from robustvlm_tpu_torch.models.clip import CLIP, CLIP_CONFIGS, load_clip_checkpoint

    cfg = CLIP_CONFIGS[args.model]
    base = None
    if args.base_ckpt:
        base = load_clip_checkpoint(args.base_ckpt, cfg)
    elif args.visual_only:
        # a visual-only overlay needs some text tower; a random one serves
        # the visual fingerprint (not zero-shot accuracy)
        base = CLIP(cfg).init_random_(0).state_dict()
    model = CLIP(cfg)
    model.load_state_dict(load_clip_checkpoint(args.ckpt, cfg, base=base))
    return model.to(device), cfg


def run_imagenet_eval(args, model, cfg, device) -> dict:
    """Clean and AutoAttack (APGD-CE, APGD-T) accuracy on an ImageNet val
    tree (the reference's clip_robustbench protocol: eps in /255)."""
    import torch

    from robustvlm_tpu_torch.benchmark import templates
    from robustvlm_tpu_torch.benchmark.zeroshot import zero_shot_classifier
    from robustvlm_tpu_torch.data.loaders import DataLoader, ImageFolderDataset
    from robustvlm_tpu_torch.eval.autoattack import AutoAttack
    from robustvlm_tpu_torch.eval.classifier import make_zero_shot_classifier
    from robustvlm_tpu_torch.models.clip.tokenizer import get_tokenizer

    tok = get_tokenizer(args.bpe_path or None, cfg.context_length, cfg.vocab_size)
    with torch.no_grad():
        classifier = zero_shot_classifier(model, lambda t: torch.as_tensor(np.asarray(tok(t))),
                                          templates.imagenet_classnames(), templates.get_templates("imagenet1k"))
    logits_fn = make_zero_shot_classifier(model, classifier)
    loader = DataLoader(ImageFolderDataset(args.imagenet_dir, size=cfg.image_size), args.batch_size,
                        shuffle=False, drop_last=False)
    xs, ys = [], []
    for xb, yb in loader:
        xs.append(xb)
        ys.append(yb)
        if sum(len(v) for v in ys) >= args.n_samples:
            break
    x = np.concatenate(xs)[: args.n_samples]
    y = np.concatenate(ys)[: args.n_samples]
    aa = AutoAttack(logits_fn, norm="linf", eps=args.eps / 255.0, attacks_to_run=["apgd-ce", "apgd-t"],
                    n_iter=args.n_iter, verbose=True, device=device)
    aa.run_standard_evaluation(x, y, bs=args.attack_batch, bs_forward=args.batch_size, run_checks=False)
    return aa.robust_accuracy_dict


def _load_quality_images(image_dir: str, image_size: int, n: int):
    """(n, 3, S, S) [0,1] images: the first n of a flat directory (sorted)
    when given, else a fixed synthetic batch (fp against quantized on the
    same inputs means something either way; CIDEr only with real images
    and weights)."""
    if image_dir:
        from PIL import Image

        from robustvlm_tpu_torch.data.loaders import default_image_transform

        tf = default_image_transform(image_size)
        paths = sorted(p for p in Path(image_dir).iterdir()
                       if p.suffix.lower() in (".jpg", ".jpeg", ".png", ".bmp"))[:n]
        if not paths:
            raise ValueError(f"no images found in {image_dir}")
        arrs = []
        for p in paths:
            with Image.open(p) as img:
                arrs.append(tf(img.convert("RGB")))
        return np.stack(arrs)
    return np.random.RandomState(0).rand(n, 3, image_size, image_size).astype(np.float32)


def quant_quality(model_factory, images, *, widths=(8, 4), max_new: int = 32) -> dict:
    """Greedy captions of the same images by the fp model and by each
    weight-only width (`quantize_for_serving`, the serving path), each
    width scored against fp: token agreement over fp's generated span,
    exact-match rate, CIDEr with fp's captions as references.
    `model_factory()` must return a fresh `LlavaEvalModel` (quantizing
    drops the fp weights)."""
    import gc

    import torch

    from robustvlm_tpu_torch.models.generation import greedy_generate, strip_after_eos
    from robustvlm_tpu_torch.vlm_eval.eval_models import truncate_at_stops
    from robustvlm_tpu_torch.vlm_eval.metrics.cider import compute_cider

    def generate(width):
        model = model_factory()  # fresh: quantizing drops the fp weights
        if width:
            model.quantize_for_serving(width)
        x = torch.from_numpy(np.asarray(images, np.float32)).to(model.device)
        tok = model.tok
        with torch.no_grad():
            pf, df, toks, n_pad = model._decode_fns(x, [model.get_caption_prompt()] * x.shape[0], max_new)
            tokens = greedy_generate(pf, df, toks, n_pad, max_new_tokens=max_new, eos_id=tok.eos_token_id,
                                     pad_id=tok.pad_token_id).tokens.cpu().numpy()
        caps = [truncate_at_stops(tok.decode(ids), model.DEFAULT_STOPS)
                for ids in strip_after_eos(tokens, tok.eos_token_id, tok.pad_token_id)]
        eos, pad = tok.eos_token_id, tok.pad_token_id
        del model, pf, df
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return tokens, caps, (eos, pad)

    fp_tokens, fp_caps, (eos, pad) = generate(0)
    out = {}
    for width in widths:
        q_tokens, q_caps, _ = generate(width)
        agree, exact = [], 0
        for fp_row, q_row in zip(fp_tokens, q_tokens):
            stop = np.where((fp_row == eos) | (fp_row == pad))[0]
            valid = max(int(stop[0]) if len(stop) else len(fp_row), 1)
            a = float(np.mean(fp_row[:valid] == q_row[:valid]))
            agree.append(a)
            exact += int(a == 1.0)
        ids = list(range(len(fp_caps)))
        out[f"int{width}"] = {
            "token_agreement": float(np.mean(agree)),
            "exact_match_rate": exact / len(agree),
            "cider_vs_fp": compute_cider(dict(zip(ids, q_caps)), {i: [fp_caps[i]] for i in ids}),
            "n_images": len(agree),
            "max_new_tokens": max_new,
        }
    return out


def run_llava_quant_quality(args, device) -> dict:
    """The quantization gate on a real LLaVA checkpoint, reloaded for each
    width; prints one JSON line."""
    import torch

    from robustvlm_tpu_torch.models.llava import LLAVA_CONFIGS
    from robustvlm_tpu_torch.models.llava.import_torch import checkpoint_config, load_llava_checkpoint
    from robustvlm_tpu_torch.models.llava.model import Llava, half_state
    from robustvlm_tpu_torch.vlm_eval.eval_models import LlavaEvalModel

    if not args.tokenizer_path:
        raise ValueError("--tokenizer_path is required with --llava_ckpt (the HF LLaMA tokenizer directory)")
    cfg = LLAVA_CONFIGS[args.llava_model]

    def factory():
        from robustvlm_tpu_torch.models.mpt.import_torch import load_state
        from robustvlm_tpu_torch.vlm_eval.run_evaluation import _tokenizer

        sd = load_state(args.llava_ckpt)
        ccfg = checkpoint_config(sd, cfg)  # the checkpoint's projector type
        state = {k: v.to(device) for k, v in half_state(load_llava_checkpoint(sd, ccfg)).items()}
        tok = _tokenizer(argparse.Namespace(tokenizer_path=args.tokenizer_path, model="llava"))
        return LlavaEvalModel(Llava.from_state(ccfg, state), tok, compute_dtype=torch.bfloat16)

    images = _load_quality_images(args.image_dir, cfg.vision.image_size, args.n_quality_images)
    res = quant_quality(factory, images, max_new=args.quality_max_new)
    print(json.dumps({"metric": "llava_quant_quality_vs_fp", **res}))
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", default=os.environ.get("CLIP_CKPT", ""))
    p.add_argument("--model", default="ViT-L-14")
    p.add_argument("--base_ckpt", default="",
                   help="a full openai checkpoint giving the text tower when --ckpt is a visual-only "
                        "FARE/TeCoA overlay")
    p.add_argument("--visual_only", action="store_true")
    p.add_argument("--record", default="", help="write the fingerprint here")
    p.add_argument("--expected", default="", help="compare against this json")
    p.add_argument("--imagenet_dir", default="")
    p.add_argument("--n_samples", type=int, default=1000)
    p.add_argument("--n_iter", type=int, default=100)
    p.add_argument("--eps", type=float, default=2.0, help="/255 units")
    p.add_argument("--batch_size", type=int, default=50)
    p.add_argument("--attack_batch", type=int, default=8)
    p.add_argument("--bpe_path", default=os.environ.get("CLIP_BPE_PATH", ""))
    p.add_argument("--host_loop", action="store_true", help="accepted for the JAX flags; the port's "
                                                            "attack loop is eager either way")
    p.add_argument("--llava_ckpt", default=os.environ.get("LLAVA_CKPT", ""))
    p.add_argument("--llava_model", default="llava-1.5-7b")
    p.add_argument("--tokenizer_path", default=os.environ.get("LLAVA_TOKENIZER", ""))
    p.add_argument("--image_dir", default="",
                   help="flat directory of images for the quality gate (default: a fixed synthetic batch)")
    p.add_argument("--n_quality_images", type=int, default=8)
    p.add_argument("--quality_max_new", type=int, default=32)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if not args.ckpt and not args.llava_ckpt:
        print("SKIP: no checkpoint ($CLIP_CKPT unset, --ckpt empty; $LLAVA_CKPT unset for the "
              "quantized-serving quality gate)")
        return 0

    from robustvlm_tpu_torch.device import resolve_device, use_full_fp32

    device = resolve_device(args.device)
    use_full_fp32()  # the fingerprint is float32 at full precision
    if args.llava_ckpt:
        run_llava_quant_quality(args, device)
        if not args.ckpt:
            return 0

    model, cfg = load_real_checkpoint(args, device)
    fp = fingerprint(model, cfg)
    rc = 0
    if args.record:
        with open(args.record, "w") as f:
            json.dump(fp, f, indent=2)
        print(f"recorded fingerprint -> {args.record}")
    if args.expected:
        with open(args.expected) as f:
            expected = json.load(f)
        errs = compare(fp, expected)
        if errs:
            print("PARITY FAIL:\n  " + "\n  ".join(errs))
            rc = 1
        else:
            print("PARITY OK: fingerprint matches recorded values")
    if args.imagenet_dir:
        print(json.dumps({"robust_accuracy": run_imagenet_eval(args, model, cfg, device)}))
        print("compare against BASELINE.md ViT-L/14 rows (0.5%-point tolerance north star)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
