"""Layers of the reference, NHWC as the program's: quantized convs and
denses (per-tensor activation quantizer in front, per-channel W4 or W8
weights), GroupNorm, LayerNorm, the activations and the timestep
embedding.  Parameter names are the program's (``weight``, ``bias``,
``scale``)."""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .quant import ActQ, Ctx, rounded_weight


def swish(x, ctx: Ctx):
    return ctx.c(x * torch.sigmoid(x))


def gelu_tanh(x, ctx: Ctx):
    return ctx.c(F.gelu(x, approximate="tanh"))


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, [sin | cos], frequencies exp(-ln(1e4)·i/(half-1))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / (half - 1))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class GNorm(nn.Module):
    """GroupNorm(32, eps 1e-6) over NHWC, statistics in float32."""

    def __init__(self, ch: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x, ctx: Ctx):
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.groups, self.scale,
                         self.bias, self.eps)
        return ctx.c(y.permute(0, 2, 3, 1))


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, ctx: Ctx):
        return ctx.c(F.layer_norm(x.float(), x.shape[-1:], self.scale, self.bias, self.eps))


class _Quantized(nn.Module):
    """Weight-quantized layer: ``prepare()`` computes the served weight from
    ``weight`` (each input-channel group of a split layer on its own range)."""

    def _setup(self, in_ch: int, split: int, w_bits: int, a_bits: int,
               disable_act_quant: bool):
        self.split, self.w_levels = split, 2 ** w_bits
        self.disable_act_quant = disable_act_quant
        self.act_quantizer = ActQ(2 ** a_bits)
        if split:
            self.act_quantizer_1 = ActQ(2 ** a_bits)
        self.parts = [(0, split), (split, in_ch)] if split else [(0, in_ch)]
        self.served = None

    @torch.no_grad()
    def prepare(self) -> None:
        self.served = torch.cat([rounded_weight(self.weight[:, s:e], self.w_levels)
                                 for s, e in self.parts], dim=1)

    def _input(self, x, ctx: Ctx):
        if self.disable_act_quant:
            return x.float()
        if self.split:
            return torch.cat([self.act_quantizer(x[..., :self.split], ctx),
                              self.act_quantizer_1(x[..., self.split:], ctx)], -1).float()
        return self.act_quantizer(x, ctx).float()

    def _weight(self, ctx: Ctx):
        return self.served if ctx.quant and not ctx.calib else self.weight.float()


def same_pads(h: int, w: int, kh: int, kw: int, sh: int, sw: int):
    """XLA's SAME padding: an odd total puts its extra pixel at the end."""
    def one(size, k, s):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        return total // 2, total - total // 2
    return one(h, kh, sh), one(w, kw, sw)


class QConv(_Quantized):
    def __init__(self, in_ch: int, out_ch: int, k: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1), padding="SAME", split: int = 0,
                 w_bits: int = 4, a_bits: int = 8, disable_act_quant: bool = False):
        super().__init__()
        self.k, self.strides, self.padding = tuple(k), tuple(strides), padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *self.k))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self._setup(in_ch, split, w_bits, a_bits, disable_act_quant)

    def forward(self, x, ctx: Ctx):
        x = self._input(x, ctx).permute(0, 3, 1, 2)
        if self.padding == "SAME":
            (t, b), (l, r) = same_pads(x.shape[2], x.shape[3], *self.k, *self.strides)
        elif self.padding == "VALID":
            (t, b), (l, r) = (0, 0), (0, 0)
        else:
            (t, b), (l, r) = self.padding
        out = F.conv2d(F.pad(x, (l, r, t, b)), self._weight(ctx), self.bias.float(),
                       stride=self.strides)
        return ctx.c(out.permute(0, 2, 3, 1))


class QDense(_Quantized):
    def __init__(self, in_f: int, out_f: int, w_bits: int = 4, a_bits: int = 8,
                 use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_f, in_f))
        self.bias = nn.Parameter(torch.zeros(out_f)) if use_bias else None
        self._setup(in_f, 0, w_bits, a_bits, False)

    def forward(self, x, ctx: Ctx):
        out = self._input(x, ctx) @ self._weight(ctx).t()
        if self.bias is not None:
            out = out + self.bias.float()
        return ctx.c(out)


def attention(q, k, v, scale: float, quantizers, ctx: Ctx):
    """Quantized attention on (B, S, H, C) heads: q, k quantized, logits in
    float32 times ``scale``, softmax, the weights and v quantized, the
    weighted sum.  ``quantizers``: (q, k, w, v)."""
    aq, ak, aw, av = quantizers
    q, k = aq(q, ctx).float(), ak(k, ctx).float()
    w = torch.softmax(torch.einsum("bthc,bshc->bhts", q, k) * scale, dim=-1)
    w = aw(ctx.c(w), ctx).float()
    v = av(v, ctx).float()
    return ctx.c(torch.einsum("bhts,bshc->bthc", w, v))
