"""rinna Japanese CLIP (ja_clip): a BERT/RoBERTa text tower beside the CLIP
ViT vision tower, as PyTorch modules.

Counterpart of `robustvlm_tpu/models/jaclip/model.py`: the post-LayerNorm
BERT encoder (HF BertModel/RobertaModel semantics: embeddings LayerNorm,
blocks of attention + LayerNorm and exact-GELU MLP + LayerNorm), CLS or
masked-mean pooling, and a linear or MLP projection (open_clip's
`proj='mlp'`: two bias-free linears with exact GELU between, hidden
(width + embed) // 2). Position ids follow `position_convention`:
'roberta' counts real tokens from `position_offset` with pads at
pad_token_id (what HF RobertaModel does when none are passed), 'arange'
is rinna's protocol of explicit arange(seq_len) ids. The image tower is
the port's CLIP ViT (`models/clip`), so its attention runs through the
`vit_attention` kernels on the card; the text tower's products are plain
`torch.matmul` in float32, as the JAX tower reaches no Pallas kernel.

Split over the mesh's `model` axis (`parallel/mesh.shard_params`): the ViT
tower as `models/clip` says; a BERT block whose heads and ffn width m
divides holds this rank's q, k and v columns with their biases and ff1
columns with its bias, and sums the o and ff2 products over `model` before
their biases (added once) and the LayerNorms; the MLP projection holds fc's
columns and out's rows (`parallel/tensor_parallel.py`). The embeddings stay
whole on `model`.

Parameters keep the JAX package's names and layouts (linear weights (in,
out)), so a JAX tree carries across by name (`convert.params_from_jax`).
The tokenizers return (input_ids, attention_mask) int64 tensors: with a
local HF tokenizer directory (an optional `transformers` import) rinna's
protocol, CLS prepended by hand; without one a deterministic crc32 hash
tokenizer with the same layout.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from robustvlm_tpu_torch.benchmark.templates import format_prompts
from robustvlm_tpu_torch.models.clip.model import CLIP_CONFIGS, CLIPConfig, VisionTower
from robustvlm_tpu_torch.parallel.tensor_parallel import column_parallel, local, row_parallel

LOGIT_SCALE_INIT = 2.659260036932778  # ln(1 / 0.07), CLIP's


@dataclasses.dataclass(frozen=True)
class BertTextConfig:
    vocab_size: int = 32000
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 514
    type_vocab: int = 1
    layer_norm_eps: float = 1e-5
    # RoBERTa pads positions: pad_token_id = 1, real tokens start at 2
    pad_token_id: int = 1
    position_offset: int = 2
    position_convention: str = "roberta"  # or 'arange' (rinna's protocol)
    pool: str = "cls"  # 'cls' | 'mean'


@dataclasses.dataclass(frozen=True)
class JaCLIPConfig:
    name: str
    text: BertTextConfig
    vision: CLIPConfig  # a full CLIP config; its vision tower is used
    embed_dim: int = 512
    proj_arch: str = "linear"  # or 'mlp' (open_clip HFTextEncoder proj='mlp')

    @property
    def proj_hidden(self) -> int:
        return (self.text.hidden + self.embed_dim) // 2

    @property
    def image_size(self) -> int:
        return self.vision.image_size


JACLIP_CONFIGS: Dict[str, JaCLIPConfig] = {
    # rinna/japanese-clip-vit-b-16: ViT-B/16 and japanese-roberta-base,
    # arange positions per rinna's tokenize protocol
    "ja_clip-vit-b-16": JaCLIPConfig(
        "ja_clip-vit-b-16", BertTextConfig(position_convention="arange"), CLIP_CONFIGS["ViT-B-16"],
    ),
    "test-tiny": JaCLIPConfig(
        "test-tiny",
        BertTextConfig(vocab_size=128, hidden=32, layers=2, heads=2, intermediate=64, max_positions=64),
        CLIP_CONFIGS["test-tiny"], embed_dim=CLIP_CONFIGS["test-tiny"].embed_dim,
    ),
}


def default_position_ids(input_ids: torch.Tensor, attention_mask: torch.Tensor,
                         cfg: BertTextConfig) -> torch.Tensor:
    if cfg.position_convention == "arange":
        return torch.arange(input_ids.shape[-1], device=input_ids.device).expand_as(input_ids)
    pos = torch.cumsum(attention_mask.long(), dim=-1) - 1 + cfg.position_offset
    return torch.where(attention_mask > 0, pos, torch.full_like(pos, cfg.pad_token_id))


def _ln(x, w, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def _p(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape))


class BertBlock(nn.Module):
    tp = None  # parallel.tensor_parallel.TensorParallel when split over `model`

    def __init__(self, cfg: BertTextConfig):
        super().__init__()
        d, i = cfg.hidden, cfg.intermediate
        for n in ("q", "k", "v", "o"):
            setattr(self, f"{n}_w", _p(d, d))
            setattr(self, f"{n}_b", _p(d))
        self.ln1_w, self.ln1_b = _p(d), _p(d)
        self.ff1_w, self.ff1_b = _p(d, i), _p(i)
        self.ff2_w, self.ff2_b = _p(i, d), _p(d)
        self.ln2_w, self.ln2_b = _p(d), _p(d)
        self.heads, self.eps = cfg.heads, cfg.layer_norm_eps

    def tp_layout(self, m: int):
        """{parameter: (split dim, blocks)} over a `model` axis of m, or None
        (the block stays whole) when m does not divide the heads or the ffn
        width."""
        if self.heads % m or self.ff1_w.shape[1] % m:
            return None
        cols = ("q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "ff1_w", "ff1_b")
        return {**{n: (1 if n.endswith("_w") else 0, 1) for n in cols}, "o_w": (0, 1), "ff2_w": (0, 1)}

    def forward(self, h, bias):
        tp = self.tp
        b, t, d = h.shape
        hd = d // self.heads
        heads = self.heads // tp.size if tp else self.heads

        def col(x, w, bb):
            return (column_parallel(x, local(w), tp) if tp else x @ w) + local(bb)

        def row(x, w, bb):
            return (row_parallel(x, local(w), tp) if tp else x @ w) + bb

        def proj(w, bb):
            return col(h, w, bb).reshape(b, t, heads, hd).transpose(1, 2)

        q, k, v = proj(self.q_w, self.q_b), proj(self.k_w, self.k_b), proj(self.v_w, self.v_b)
        s = q @ k.transpose(-1, -2) / math.sqrt(hd) + bias  # the bias carries the padding mask
        o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(b, t, heads * hd)
        h = _ln(h + row(o, self.o_w, self.o_b), self.ln1_w, self.ln1_b, self.eps)
        f = row(F.gelu(col(h, self.ff1_w, self.ff1_b)), self.ff2_w, self.ff2_b)
        return _ln(h + f, self.ln2_w, self.ln2_b, self.eps)


class BertText(nn.Module):
    def __init__(self, cfg: BertTextConfig):
        super().__init__()
        d = cfg.hidden
        self.cfg = cfg
        self.word_emb = _p(cfg.vocab_size, d)
        self.pos_emb = _p(cfg.max_positions, d)
        self.type_emb = _p(cfg.type_vocab, d)
        self.emb_ln_w, self.emb_ln_b = _p(d), _p(d)
        self.blocks = nn.ModuleList(BertBlock(cfg) for _ in range(cfg.layers))

    def forward(self, input_ids, attention_mask, position_ids=None):
        """(B, T) ids -> (B, T, D) last hidden state."""
        cfg = self.cfg
        if position_ids is None:
            position_ids = default_position_ids(input_ids, attention_mask, cfg)
        emb = (self.word_emb[input_ids] + self.pos_emb[position_ids]
               + self.type_emb[torch.zeros_like(input_ids)])
        h = _ln(emb, self.emb_ln_w, self.emb_ln_b, cfg.layer_norm_eps)
        bias = (1.0 - attention_mask[:, None, None, :].to(h.dtype)) * -1e9
        for blk in self.blocks:
            h = blk(h, bias)
        return h


class MLPProjection(nn.Module):
    """open_clip's `proj='mlp'`: bias-free fc, exact GELU, bias-free out."""

    tp = None

    def __init__(self, d: int, hid: int, embed: int):
        super().__init__()
        self.fc_w, self.out_w = _p(d, hid), _p(hid, embed)

    def tp_layout(self, m: int):
        return None if self.fc_w.shape[1] % m else {"fc_w": (1, 1), "out_w": (0, 1)}

    def forward(self, x):
        tp = self.tp
        if tp is None:
            return F.gelu(x @ self.fc_w) @ self.out_w
        return row_parallel(F.gelu(column_parallel(x, local(self.fc_w), tp)), local(self.out_w), tp)


class JaCLIP(nn.Module):
    """The BERT text tower, its projection, the CLIP ViT vision tower and
    logit_scale; created frozen and zero (load a state dict or call
    `init_random_`). Its encode_image has the signature of `CLIP`'s, so the
    zero-shot wrappers of `eval/classifier.py` take it."""

    def __init__(self, cfg: JaCLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.text = BertText(cfg.text)
        if cfg.proj_arch == "mlp":
            self.text_projection = MLPProjection(cfg.text.hidden, cfg.proj_hidden, cfg.embed_dim)
        else:
            self.text_projection = _p(cfg.text.hidden, cfg.embed_dim)
        self.visual = VisionTower(cfg.vision)
        self.logit_scale = nn.Parameter(torch.tensor(LOGIT_SCALE_INIT))
        self.requires_grad_(False)
        if device is not None:
            self.to(device)

    def encode_text(self, input_ids, attention_mask, *, position_ids=None, normalize=False):
        """(B, T) -> (B, embed_dim): the pooled feature through the projection."""
        h = self.text(input_ids, attention_mask, position_ids)
        if self.cfg.text.pool == "cls":
            pooled = h[:, 0]
        else:  # masked mean
            m = attention_mask[..., None].to(h.dtype)
            pooled = (h * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        proj = self.text_projection
        e = proj(pooled) if self.cfg.proj_arch == "mlp" else pooled @ proj
        return e / torch.linalg.norm(e, dim=-1, keepdim=True) if normalize else e

    @property
    def tensor_parallel_ok(self) -> bool:
        """`parallel/mesh.shard_params` splits this model over `model`."""
        return True

    def encode_image(self, x, *, normalize=False, compute_dtype=torch.float32, tokens=False,
                     n_skip_last=0, remat=False):
        out = self.visual(x, compute_dtype=compute_dtype, tokens=tokens, n_skip_last=n_skip_last,
                          remat=remat)
        if normalize and not tokens:
            return out / (torch.linalg.norm(out, dim=-1, keepdim=True) + 1e-12)
        return out

    @torch.no_grad()
    def init_random_(self, seed: int = 0) -> "JaCLIP":
        """Scaled-normal random weights from a seed, drawn on the model's
        device: the scheme of the JAX `init_jaclip_params`, not its numbers."""
        dev = self.logit_scale.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        tc, d = self.cfg.text, self.cfg.text.hidden
        wv = self.cfg.vision.vision.width

        def normal_(t, std):
            t.copy_(torch.randn(t.shape, generator=gen, device=dev) * std)

        for name, prm in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name == "logit_scale":
                prm.fill_(LOGIT_SCALE_INIT)
            elif name.startswith("visual."):
                if leaf == "g":
                    prm.fill_(1.0)
                elif prm.dim() == 1 and leaf != "class_embedding":
                    prm.zero_()
                else:
                    normal_(prm, wv ** -0.5)
            elif leaf in ("word_emb", "pos_emb", "type_emb"):
                normal_(prm, 0.02)
            elif leaf.endswith("ln_w") or leaf in ("ln1_w", "ln2_w"):
                prm.fill_(1.0)
            elif prm.dim() == 1:
                prm.zero_()
            elif leaf == "ff2_w":
                normal_(prm, tc.intermediate ** -0.5)
            elif leaf == "out_w":
                normal_(prm, self.cfg.proj_hidden ** -0.5)
            else:
                normal_(prm, d ** -0.5)
        return self


def as_tokens(ids: np.ndarray, mask: np.ndarray):
    return torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask.astype(np.int64))


def wrap_hf_ja_tokenizer(tok, max_len: int = 77):
    """rinna's ja_clip tokenize protocol over an HF tokenizer object: encode
    without special tokens to max_len - 1, then prepend cls_token_id (or
    bos_token_id) by hand."""
    cls_id = getattr(tok, "cls_token_id", None)
    if cls_id is None:
        cls_id = getattr(tok, "bos_token_id", None)
    if cls_id is None:
        raise ValueError("ja_clip tokenizer needs a cls_token_id (or bos_token_id) to prepend: "
                         "rinna's protocol pools the prepended [CLS] slot")

    def tokenize(texts):
        out = tok(list(texts), padding="max_length", truncation=True, max_length=max_len - 1,
                  add_special_tokens=False, return_tensors="np")
        ids = np.asarray(out["input_ids"], np.int64)
        mask = np.asarray(out["attention_mask"], np.int64)
        ids = np.concatenate([np.full((ids.shape[0], 1), cls_id, np.int64), ids], axis=1)
        mask = np.concatenate([np.ones((mask.shape[0], 1), np.int64), mask], axis=1)
        return as_tokens(ids, mask)

    return tokenize


def hash_tokenizer(cfg: BertTextConfig, max_len: int, first: int, lo: int, last: Optional[int] = None):
    """A deterministic tokenizer for runs without tokenizer files: id
    `first` in slot 0, then 2 or more ids lo + crc32(word) % (vocab -
    lo - 1) (crc32, not hash(): the same ids in every process), then `last`
    if given; pads are pad_token_id."""
    v = cfg.vocab_size
    room = max_len - (2 if last is not None else 1)

    def tokenize(texts):
        ids = np.full((len(texts), max_len), cfg.pad_token_id, np.int64)
        mask = np.zeros((len(texts), max_len), np.int64)
        for i, t in enumerate(texts):
            toks = [first] + [lo + (zlib.crc32(w.encode()) % (v - lo - 1)) for w in str(t).split()][:room]
            if last is not None:
                toks.append(last)
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return as_tokens(ids, mask)

    return tokenize


def get_ja_tokenizer(path: Optional[str], cfg: JaCLIPConfig, max_len: int = 77):
    """tokenize(texts) -> (input_ids, attention_mask). With a local HF
    tokenizer dir (rinna/japanese-roberta-base layout), rinna's protocol;
    without one, the hash tokenizer: a CLS slot (id 0) then content ids."""
    if path:
        from transformers import AutoTokenizer

        return wrap_hf_ja_tokenizer(AutoTokenizer.from_pretrained(path), max_len)
    return hash_tokenizer(cfg.text, max_len, first=0, lo=2)


@torch.no_grad()
def build_ja_text_classifier(model: JaCLIP, tokenize, classnames: Sequence[str],
                             templates: Optional[Sequence[str]] = None) -> torch.Tensor:
    """(D, C) column-normalized template-ensemble classifier over the BERT
    tower: per class the mean of the normalized template embeddings,
    normalized again."""
    dev = model.logit_scale.device
    tpls = list(templates) if templates else ["{c}"]
    cols = []
    for name in classnames:
        ids, mask = tokenize(format_prompts(tpls, name))
        m = model.encode_text(ids.to(dev), mask.to(dev), normalize=True).mean(dim=0)
        cols.append(m / torch.linalg.norm(m))
    return torch.stack(cols, dim=1)
