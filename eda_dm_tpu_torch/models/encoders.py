"""Conditioning encoders (port of ``eda_dm_tpu/models/encoders.py``): the
class embedder of the ImageNet task, SD v1.4's CLIP text encoder and the
stand-in text encoder.

``ClassEmbedder``: a label → a (B, 1, embed_dim) float32 context, one
token for the cross-attention (``ClassEmbedder`` of the reference's
``encoders/modules.py``); cin256-v2 has 1001 rows, row 1000 the
unconditional token.  Never quantized.

``FrozenCLIPTextEncoder``: SD v1.4's conditioner (``FrozenCLIPEmbedder``
of the reference), CLIP ViT-L/14's text tower (``models/clip.py``) and
tokenizer (``models/clip_tokenizer.py``) from a local checkout: prompts
padded to 77 tokens → ``last_hidden_state`` (B, 77, 768) in float32.
The repository holds no such checkout, so without one it raises.  The
JAX package serves its text path without CLIP's weights through
``TinyTextEncoder``: crc32 hash tokens → a two-layer pre-LN transformer
(flax ``nn.SelfAttention``, 4 heads) → a final LayerNorm, giving (B, 77,
context_dim) rows in float32.  Neither is ever quantized.

``BERTEmbedder`` is the reference's BERT text encoder (an x_transformers
``TransformerWrapper``: token and absolute position embeddings, pre-norm
attention and feed-forward layers, a final LayerNorm), behind
``BERTTextEncoder``'s crc32 hash tokens; no task uses it by default.
``class_embedder_state_dict_to_params`` and ``bert_state_dict_to_params``
convert the reference's state dicts to the JAX package's trees.

The stand-in's and BERT's parameters keep the flax names and layouts
(``tok.embedding``, ``pos``, ``attn_0.query.kernel`` of shape (d, heads,
head_dim), ``out.kernel`` (heads, head_dim, d), ``fc1_0.kernel`` (d, 4d),
``attn_0_q.kernel`` (d, inner)), so ``models/bridge.py`` loads the JAX
tree as it is; CLIP's keep ``transformers``' PyTorch names
(``models/clip.py``).
"""

from __future__ import annotations

import zlib
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from ..device import model_device, resolve_device
from ..nn.layers import LayerNorm, gelu_tanh
from .convert import as_numpy


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding[ids]``."""

    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]


class ClassEmbedder(nn.Module):
    """Labels → (B, 1, ``embed_dim``) float32 contexts on ``device`` (the
    card unless the caller passes ``"cpu"``).  The table is drawn N(0, 1)
    from ``seed`` (``torch.nn.Embedding``'s init, as the reference's
    embedder has); the JAX embedder's table comes through
    ``models/bridge.py`` (``embedding.embedding``)."""

    def __init__(self, embed_dim: int = 512, n_classes: int = 1000, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.embed_dim, self.n_classes = embed_dim, n_classes
        with torch.device(device):
            self.embedding = Embed(n_classes, embed_dim)
        g = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            self.embedding.embedding.normal_(0.0, 1.0, generator=g)

    def forward(self, labels) -> torch.Tensor:
        ids = torch.as_tensor(labels, dtype=torch.long,
                              device=self.embedding.embedding.device)
        return self.embedding(ids)[:, None, :]


def class_embedder_state_dict_to_params(state_dict) -> dict:
    """The reference ``ClassEmbedder``'s state dict → its params tree."""
    return {"embedding": {"embedding": as_numpy(state_dict["embedding.weight"])}}


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral``: the last ``len(in_shape)`` axes of the
    input against a kernel of shape ``in_shape + out_shape`` (flax
    ``nn.Dense`` is the case of one axis each)."""

    def __init__(self, in_shape, out_shape, use_bias: bool = True):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.kernel = nn.Parameter(torch.empty(*self.in_shape, *self.out_shape))
        self.bias = nn.Parameter(torch.zeros(*self.out_shape)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k_in, k_out = int(np.prod(self.in_shape)), int(np.prod(self.out_shape))
        lead = x.shape[:x.dim() - len(self.in_shape)]
        y = (x.reshape(-1, k_in) @ self.kernel.reshape(k_in, k_out)).reshape(
            *lead, *self.out_shape)
        return y if self.bias is None else y + self.bias


class SelfAttention(nn.Module):
    """flax ``nn.SelfAttention(num_heads)``: DenseGeneral q/k/v to
    (heads, head_dim), the query divided by √head_dim, a float32 softmax,
    the ``out`` DenseGeneral back from (heads, head_dim)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        hd = dim // heads
        self.query = DenseGeneral((dim,), (heads, hd))
        self.key = DenseGeneral((dim,), (heads, hd))
        self.value = DenseGeneral((dim,), (heads, hd))
        self.out = DenseGeneral((heads, hd), (dim,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)   # (B, T, H, hd)
        q = q / torch.sqrt(torch.tensor(float(q.shape[-1])))
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class TinyTextEncoder(nn.Module):
    """CLIP-shaped stand-in text encoder: ``encode(prompts)`` → float32
    (B, max_length, context_dim) on ``device`` (the card unless the caller
    passes ``"cpu"``).  Random weights drawn from ``seed`` (N(0, 1/fan_in)
    kernels, N(0, 1) token table, N(0, 0.02²) positions); the JAX
    encoder's weights come through ``models/bridge.py``."""

    depth, heads = 2, 4

    def __init__(self, context_dim: int = 768, max_length: int = 77,
                 vocab: int = 4096, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.max_length, self.vocab = max_length, vocab
        d = context_dim
        with torch.device(device):
            self.tok = Embed(vocab, d)
            self.pos = nn.Parameter(torch.empty(1, max_length, d))
            for i in range(self.depth):
                setattr(self, f"ln1_{i}", LayerNorm(d))
                setattr(self, f"attn_{i}", SelfAttention(d, self.heads))
                setattr(self, f"ln2_{i}", LayerNorm(d))
                setattr(self, f"fc1_{i}", DenseGeneral((d,), (4 * d,)))
                setattr(self, f"fc2_{i}", DenseGeneral((4 * d,), (d,)))
            self.ln_f = LayerNorm(d)
        g = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            self.tok.embedding.normal_(0.0, 1.0, generator=g)
            self.pos.normal_(0.0, 0.02, generator=g)
            _init_dense(self, g)

    def tokenize(self, prompts: Sequence[str]) -> np.ndarray:
        """crc32 hash ids: [1, words..., 0 padding], ``max_length`` each."""
        out = np.zeros((len(prompts), self.max_length), np.int32)
        for r, p in enumerate(prompts):
            toks = [zlib.crc32(w.encode()) % (self.vocab - 2) + 2
                    for w in p.lower().split()][: self.max_length - 2]
            out[r] = [1] + toks + [0] * (self.max_length - 1 - len(toks))
        return out

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        h = self.tok(ids) + self.pos[:, :ids.shape[1]]
        for i in range(self.depth):
            h = h + getattr(self, f"attn_{i}")(getattr(self, f"ln1_{i}")(h))
            f = getattr(self, f"fc1_{i}")(getattr(self, f"ln2_{i}")(h))
            h = h + getattr(self, f"fc2_{i}")(gelu_tanh(f))
        return self.ln_f(h)

    @torch.no_grad()
    def encode(self, prompts: Sequence[str]) -> torch.Tensor:
        ids = torch.from_numpy(self.tokenize(prompts)).long()
        return self(ids.to(self.pos.device))


class FrozenCLIPTextEncoder:
    """SD v1's text conditioning (``FrozenCLIPEmbedder``): the tokenizer at
    ``max_length`` (77, padded to it) → CLIP's text tower →
    ``last_hidden_state``, float32 (B, 77, width) on ``device`` (the card
    unless the caller passes ``"cpu"``).  No attention mask enters the
    tower, as in the JAX class: the causal mask alone.

    ``model_path``: a local checkout of openai/clip-vit-large-patch14
    (``config.json``, ``model.safetensors`` or ``pytorch_model.bin``,
    ``vocab.json``, ``merges.txt``); without one the constructor raises
    ``RuntimeError``.  Unlike the JAX class, it also takes an injected
    ``model`` (a ``models.clip.CLIPModel`` with a text tower, on
    ``device``) and ``tokenizer``, as the tests build them."""

    def __init__(self, model_path: str = "openai/clip-vit-large-patch14",
                 max_length: int = 77, device=None, model=None, tokenizer=None):
        if model is None:
            from .clip import load_clip_checkout
            model, tokenizer = load_clip_checkout(model_path, device, towers=("text",),
                                                  who="FrozenCLIPTextEncoder")
        self.device = model_device(model, device)
        self.model, self.tokenizer, self.max_length = model, tokenizer, max_length

    def tokenize(self, prompts: Sequence[str]) -> np.ndarray:
        return self.tokenizer(list(prompts), truncation=True, max_length=self.max_length,
                              padding="max_length", return_tensors="np")["input_ids"]

    def encode(self, prompts: Sequence[str]) -> torch.Tensor:
        return self.model.text_hidden_states(self.tokenize(prompts))


def _init_dense(module: nn.Module, g: torch.Generator) -> None:
    """N(0, 1/fan_in) kernels of every ``DenseGeneral`` in ``module``."""
    for m in module.modules():
        if isinstance(m, DenseGeneral):
            m.kernel.normal_(0.0, float(np.prod(m.in_shape)) ** -0.5, generator=g)


class BERTEmbedder(nn.Module):
    """Token ids → (B, T, n_embed) float32 context (the reference's
    ``BERTEmbedder`` and the part of x_transformers it builds: token and
    absolute position embeddings, ``n_layer`` pre-norm layers of bias-free
    8-head q/k/v attention and a GELU feed-forward at 4×, plain residuals,
    a final LayerNorm; every LayerNorm at epsilon 1e-5).  Names follow the
    JAX module: ``norm_{2i}``, ``attn_{2i}_q`` ... ``attn_{2i}_out``,
    ``norm_{2i+1}``, ``ff_{2i+1}_1``, ``ff_{2i+1}_2``, ``norm``.  On
    ``device`` (the card unless the caller passes ``"cpu"``), random
    weights from ``seed``."""

    def __init__(self, n_embed: int, n_layer: int, vocab_size: int = 30522,
                 max_seq_len: int = 77, heads: int = 8, dim_head: int = 64,
                 device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.n_layer, self.heads, self.dim_head = n_layer, heads, dim_head
        d, inner = n_embed, heads * dim_head
        with torch.device(device):
            self.token_emb = Embed(vocab_size, d)
            self.pos_emb = Embed(max_seq_len, d)
            for i in range(n_layer):
                ja, jf = 2 * i, 2 * i + 1
                setattr(self, f"norm_{ja}", LayerNorm(d, eps=1e-5))
                for w in "qkv":
                    setattr(self, f"attn_{ja}_{w}",
                            DenseGeneral((d,), (inner,), use_bias=False))
                setattr(self, f"attn_{ja}_out", DenseGeneral((inner,), (d,)))
                setattr(self, f"norm_{jf}", LayerNorm(d, eps=1e-5))
                setattr(self, f"ff_{jf}_1", DenseGeneral((d,), (4 * d,)))
                setattr(self, f"ff_{jf}_2", DenseGeneral((4 * d,), (d,)))
            self.norm = LayerNorm(d, eps=1e-5)
        g = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            self.token_emb.embedding.normal_(0.0, 1.0, generator=g)
            self.pos_emb.embedding.normal_(0.0, 1.0, generator=g)
            _init_dense(self, g)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        h = self.token_emb(tokens) + self.pos_emb(pos)[None]
        b, n = tokens.shape
        shape = (b, n, self.heads, self.dim_head)
        for i in range(self.n_layer):
            ja, jf = 2 * i, 2 * i + 1
            a = getattr(self, f"norm_{ja}")(h)
            q, k, v = (getattr(self, f"attn_{ja}_{w}")(a).reshape(shape) for w in "qkv")
            dots = torch.einsum("bihd,bjhd->bhij", q, k) * self.dim_head ** -0.5
            o = torch.einsum("bhij,bjhd->bihd", torch.softmax(dots, dim=-1), v)
            h = h + getattr(self, f"attn_{ja}_out")(o.reshape(b, n, -1))
            f = getattr(self, f"ff_{jf}_1")(getattr(self, f"norm_{jf}")(h))
            h = h + getattr(self, f"ff_{jf}_2")(gelu_tanh(f))
        return self.norm(h)


def bert_state_dict_to_params(state_dict) -> dict:
    """The reference ``BERTEmbedder``'s state dict (``transformer.*``, the
    x_transformers layout) → the ``BERTEmbedder`` params tree."""
    p: dict = {}
    pre = "transformer."
    for key, v in state_dict.items():
        if not key.startswith(pre):
            continue
        k, v = key[len(pre):], as_numpy(v)
        if k == "token_emb.weight":
            p["token_emb"] = {"embedding": v}
        elif k == "pos_emb.emb.weight":
            p["pos_emb"] = {"embedding": v}
        elif k.startswith("norm."):
            p.setdefault("norm", {})["scale" if k.endswith("weight") else "bias"] = v
        elif k.startswith("attn_layers.layers."):
            parts = k.split(".")
            j, slot, rest = int(parts[2]), parts[3], parts[4:]
            leaf = "scale" if rest[-1] == "weight" else "bias"
            if slot == "0":                       # the pre-norm LayerNorm
                p.setdefault(f"norm_{j}", {})[leaf] = v
            elif rest[0] in ("to_q", "to_k", "to_v"):
                p.setdefault(f"attn_{j}_{rest[0][-1]}", {})["kernel"] = v.T
            elif rest[0] == "to_out":
                leaf = "kernel" if rest[-1] == "weight" else "bias"
                p.setdefault(f"attn_{j}_out", {})[leaf] = v.T if leaf == "kernel" else v
            elif rest[0] == "net":                # the feed-forward
                leaf = "kernel" if rest[-1] == "weight" else "bias"
                name = f"ff_{j}_1" if rest[1] == "0" else f"ff_{j}_2"
                p.setdefault(name, {})[leaf] = v.T if leaf == "kernel" else v
    return p


class BERTTextEncoder(nn.Module):
    """``BERTEmbedder`` behind ``encode(prompts)`` (the interface of
    ``TinyTextEncoder``), on crc32 hash tokens in place of a vocabulary's.
    A converted reference tree loads through ``models/bridge.py`` into
    ``.module``."""

    def __init__(self, context_dim: int = 1280, n_layer: int = 32,
                 max_length: int = 77, device=None, seed: int = 0):
        super().__init__()
        self.max_length = max_length
        self.module = BERTEmbedder(context_dim, n_layer, max_seq_len=max_length,
                                   device=device, seed=seed)

    def tokenize(self, prompts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(prompts), self.max_length), np.int32)
        for r, p in enumerate(prompts):
            toks = [zlib.crc32(w.encode()) % 30520 + 2
                    for w in p.lower().split()][: self.max_length - 2]
            out[r] = [1] + toks + [0] * (self.max_length - 1 - len(toks))
        return out

    @torch.no_grad()
    def encode(self, prompts: Sequence[str]) -> torch.Tensor:
        ids = torch.from_numpy(self.tokenize(prompts)).long()
        return self.module(ids.to(self.module.norm.scale.device))
