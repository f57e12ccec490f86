"""Conditioning encoders (port of ``eda_dm_tpu/models/encoders.py``): the
class embedder of the ImageNet task and the stand-in text encoder.

``ClassEmbedder``: a label → a (B, 1, embed_dim) float32 context, one
token for the cross-attention (``ClassEmbedder`` of the reference's
``encoders/modules.py``); cin256-v2 has 1001 rows, row 1000 the
unconditional token.  Never quantized.

The real SD v1.4 conditioner, CLIP ViT-L/14 (``FrozenCLIPTextEncoder``),
needs weights the repository does not hold.  The JAX package serves its
text path without them through ``TinyTextEncoder``: crc32 hash tokens → a
two-layer pre-LN transformer (flax ``nn.SelfAttention``, 4 heads) → a
final LayerNorm, giving (B, 77, context_dim) rows in float32.  It is never
quantized.

Parameters keep the flax names and layouts (``tok.embedding``, ``pos``,
``attn_0.query.kernel`` of shape (d, heads, head_dim), ``out.kernel``
(heads, head_dim, d), ``fc1_0.kernel`` (d, 4d)), so ``models/bridge.py``
loads the JAX tree as it is.
"""

from __future__ import annotations

import zlib
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from ..device import resolve_device
from ..nn.layers import LayerNorm, gelu_tanh


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


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral``: the last ``len(in_shape)`` axes of the
    input against a kernel of shape ``in_shape + out_shape`` (flax
    ``nn.Dense`` is the case of one axis each)."""

    def __init__(self, in_shape, out_shape):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.kernel = nn.Parameter(torch.empty(*self.in_shape, *self.out_shape))
        self.bias = nn.Parameter(torch.zeros(*self.out_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k_in, k_out = int(np.prod(self.in_shape)), int(np.prod(self.out_shape))
        lead = x.shape[:x.dim() - len(self.in_shape)]
        y = x.reshape(-1, k_in) @ self.kernel.reshape(k_in, k_out)
        return y.reshape(*lead, *self.out_shape) + self.bias


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
            for m in self.modules():
                if isinstance(m, DenseGeneral):
                    m.kernel.normal_(0.0, float(np.prod(m.in_shape)) ** -0.5,
                                     generator=g)

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
