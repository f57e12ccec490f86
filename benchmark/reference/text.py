"""The stand-in text encoder that conditions the SD configuration in
place of CLIP ViT-L/14 (whose weights are not in the repository): words
hashed by crc32 into a vocabulary, ``[1, words…, 0 padding]`` to 77
tokens, token and position embeddings, pre-LN transformer layers of
multi-head self-attention and a tanh-GELU MLP, a final LayerNorm; float32
(B, 77, width).  Parameter names and layouts are the program's (flax
``DenseGeneral`` kernels: ``query.kernel`` (d, heads, head_dim))."""

from __future__ import annotations

import zlib
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class Embed(nn.Module):
    def __init__(self, vocab, dim):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, dim))


class Dense(nn.Module):
    """A kernel of shape in_shape + out_shape over the last len(in_shape) axes."""

    def __init__(self, in_shape, out_shape):
        super().__init__()
        self.n_in = len(in_shape)
        self.kernel = nn.Parameter(torch.empty(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.zeros(*out_shape))

    def forward(self, x):
        k_in = self.kernel.shape[:self.n_in].numel()
        out = self.kernel.shape[self.n_in:]
        y = x.reshape(-1, k_in) @ self.kernel.reshape(k_in, -1)
        return y.reshape(*x.shape[:x.dim() - self.n_in], *out) + self.bias


class SelfAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        hd = dim // heads
        self.query, self.key, self.value = (Dense((dim,), (heads, hd)) for _ in range(3))
        self.out = Dense((heads, hd), (dim,))

    def forward(self, x):
        q, k, v = self.query(x), self.key(x), self.value(x)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q * q.shape[-1] ** -0.5, k), dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class LN(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, 1e-6)


class TextEncoder(nn.Module):
    """``a``: the configuration's ``text_encoder`` group (``width``,
    ``max_length``, ``vocab``, ``depth``, ``heads``)."""

    def __init__(self, a: dict):
        super().__init__()
        d, self.a = a["width"], dict(a)
        self.tok = Embed(a["vocab"], d)
        self.pos = nn.Parameter(torch.empty(1, a["max_length"], d))
        for i in range(a["depth"]):
            setattr(self, f"ln1_{i}", LN(d))
            setattr(self, f"attn_{i}", SelfAttention(d, a["heads"]))
            setattr(self, f"ln2_{i}", LN(d))
            setattr(self, f"fc1_{i}", Dense((d,), (4 * d,)))
            setattr(self, f"fc2_{i}", Dense((4 * d,), (d,)))
        self.ln_f = LN(d)

    def tokenize(self, prompts: Sequence[str]) -> torch.Tensor:
        n, vocab = self.a["max_length"], self.a["vocab"]
        rows = []
        for p in prompts:
            ids = [zlib.crc32(w.encode()) % (vocab - 2) + 2 for w in p.lower().split()][:n - 2]
            rows.append([1] + ids + [0] * (n - 1 - len(ids)))
        return torch.tensor(rows, dtype=torch.long, device=self.pos.device)

    def encode(self, prompts: Sequence[str]) -> torch.Tensor:
        h = self.tok.embedding[self.tokenize(prompts)] + self.pos
        for i in range(self.a["depth"]):
            h = h + getattr(self, f"attn_{i}")(getattr(self, f"ln1_{i}")(h))
            f = getattr(self, f"fc1_{i}")(getattr(self, f"ln2_{i}")(h))
            h = h + getattr(self, f"fc2_{i}")(F.gelu(f, approximate="tanh"))
        return self.ln_f(h)
