"""Small configurations and traffic for the CPU tests: the cells' own
files with every size cut, so a run takes seconds."""

import copy

from harness import registry

CLIP = {"embed_dim": 32, "quick_gelu": True,
        "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 8, "head_width": 16},
        "text_cfg": {"context_length": 16, "vocab_size": 512, "width": 32, "heads": 2, "layers": 1},
        "assumed": {"zero_shot_classes": 10, "logit_scale": 100.0}}
FLAMINGO = {"vision": CLIP,
            "lang": {"d_model": 64, "n_heads": 4, "n_layers": 2, "expansion_ratio": 4, "vocab_size": 512,
                     "max_seq_len": 128, "alibi": True, "alibi_bias_max": 8, "no_bias": True, "norm_eps": 1e-5},
            "cross_attn_every_n_layers": 1,
            "perceiver": {"depth": 2, "num_latents": 4, "heads": 2, "dim_head": 16, "ff_mult": 4}}
CONFIGS = {"clip-vit-l-14": CLIP, "openflamingo-9b": FLAMINGO}


def traffic(cell: str) -> dict:
    tr = copy.deepcopy(registry.traffic(registry.workload(cell)["traffic"]))
    tr["images"] = dict(tr["images"], batch=4, size=32)
    if "attack" in tr:
        tr["attack"] = dict(tr["attack"], n_iter=8, eps_255=16.0)
    if "generate" in tr:
        tr["generate"] = dict(tr["generate"], max_new_tokens=5)
        tr["check"] = dict(tr["check"], sample_items=3)
    if "train" in tr:
        tr["train"] = dict(tr["train"], iterations_adv=3)
    tr["trace"] = {"first_call": 1, "calls": 2, "steps": 1}
    return tr


def config(cell: str) -> dict:
    return CONFIGS[registry.workload(cell)["config"]]
