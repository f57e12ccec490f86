"""Quantization-aware layers, serving part (port of ``eda_dm_tpu/nn/layers.py``).

Activations are NHWC ``(N, H, W, C)`` tensors as in the JAX package.  Float
conv weights are ``[Cout, Cin, kh, kw]`` (what ``F.conv2d`` takes), dense
weights ``[out, in]``; integer weight codes are ``[Cout, kh, kw, Cin]`` and
``[out, in]``, K contiguous, as the int8 kernels take them.  Quantizer
state is buffers:

* ``ActQuantizer``: ``delta``, ``zero_point`` (per tensor);
* ``QConv``/``QDense``, per channel group ``w0`` (and ``w1`` for split
  layers): ``w{i}_delta``, ``w{i}_zp`` (Cout,), ``w{i}_alpha`` (weight
  shaped), and after ``export_serving_int8`` ``w{i}_int``, ``w{i}_isum``.

Modes: FP, DEPLOY (folded weights + act fake-quant) and DEPLOY_INT8.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.int8_conv import border_map, int8_conv, same_pads
from ..ops.int8_einsum import int8_dense, quantize_act_int8
from ..ops.serving_policy import int8_conv_serving
from ..quant.adaround import adaround_fake_quant, adaround_int
from ..quant.affine import fake_quant
from ..quant.config import QuantizerSpec, QuantMode


class ActQuantizer(nn.Module):
    """Frozen per-tensor activation fake-quantizer."""

    def __init__(self, spec: QuantizerSpec):
        super().__init__()
        self.spec = spec
        self.register_buffer("delta", torch.ones((), dtype=torch.float32))
        self.register_buffer("zero_point", torch.zeros((), dtype=torch.float32))

    def forward(self, x: torch.Tensor, mode: QuantMode,
                params_only: bool = False):
        if params_only:
            return self.delta, self.zero_point
        if not mode.a_quant:
            return x
        return fake_quant(x, self.delta, self.zero_point, self.spec.n_levels)


class GNorm(nn.Module):
    """GroupNorm(32, eps=1e-6) over NHWC with the JAX package's explicit
    two-pass float32 variance; the output keeps the input dtype.
    (``F.group_norm``'s variance differs and flips borderline act codes.)"""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        xg = x.float().reshape(*x.shape[:-1], self.num_groups,
                               c // self.num_groups)
        axes = tuple(range(1, x.dim() - 1)) + (x.dim(),)
        mean = xg.mean(dim=axes, keepdim=True)
        var = ((xg - mean) ** 2).mean(dim=axes, keepdim=True)
        y = (xg - mean) * torch.rsqrt(var + self.eps)
        y = y.reshape(x.shape) * self.scale + self.bias
        return y.to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, [sin | cos] order, float32."""
    half = dim // 2
    log_p = torch.log(torch.tensor(max_period, dtype=torch.float32,
                                   device=t.device))
    freqs = torch.exp(-log_p * torch.arange(half, dtype=torch.float32,
                                            device=t.device) / (half - 1))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def _promote(x: torch.Tensor, w: torch.Tensor):
    """Cast both to the wider dtype (serving trees may carry bf16 weights
    while callers feed f32, or the reverse)."""
    if w.dtype == x.dtype:
        return x, w
    ct = torch.promote_types(w.dtype, x.dtype)
    return x.to(ct), w.to(ct)


class _WeightQuantMixin:
    """Per-channel weight-quantizer state shared by QConv and QDense.
    ``_parts`` lists (name, start, end) input-channel groups."""

    def _init_weight_quant(self, out_ch: int, in_ch: int, tail: Tuple[int, ...],
                           split: int):
        self._parts = ([("w0", 0, split), ("w1", split, in_ch)] if split > 0
                       else [("w0", 0, in_ch)])
        for name, s, e in self._parts:
            self.register_buffer(f"{name}_delta", torch.ones(out_ch))
            self.register_buffer(f"{name}_zp", torch.zeros(out_ch))
            self.register_buffer(f"{name}_alpha",
                                 torch.zeros((out_ch, e - s) + tail))
            self.register_buffer(f"{name}_int", None)
            self.register_buffer(f"{name}_isum", None)

    def _per_channel(self, v: torch.Tensor) -> torch.Tensor:
        return v.reshape((-1,) + (1,) * (self.weight.dim() - 1))

    def folded_weight(self) -> torch.Tensor:
        """Hard-AdaRound dequantized weight, ``[Cout, Cin, ...]``."""
        parts = []
        for name, s, e in self._parts:
            parts.append(adaround_fake_quant(
                self.weight[:, s:e], self._per_channel(getattr(self, f"{name}_delta")),
                self._per_channel(getattr(self, f"{name}_zp")),
                getattr(self, f"{name}_alpha"), self.wq.n_levels))
        return torch.cat(parts, dim=1)

    def weight_codes(self):
        """Centered integer codes per group, in the kernel layout (int8), and
        their per-channel sums (float32)."""
        out = []
        for name, s, e in self._parts:
            q = adaround_int(
                self.weight[:, s:e], self._per_channel(getattr(self, f"{name}_delta")),
                self._per_channel(getattr(self, f"{name}_zp")),
                getattr(self, f"{name}_alpha"), self.wq.n_levels)
            isum = q.sum(dim=tuple(range(1, q.dim()))).float()
            if q.dim() == 4:                                  # -> [Cout, kh, kw, Cin]
                q = q.permute(0, 2, 3, 1)
            out.append((name, q.contiguous().to(torch.int8), isum))
        return out


class QConv(_WeightQuantMixin, nn.Module):
    """Quantization-aware NHWC convolution.  ``split > 0`` quantizes input
    channels ``[:split]`` and ``[split:]`` with their own quantizers (the
    split-shortcut trick); such layers serve on the folded path."""

    def __init__(self, in_ch: int, features: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1), padding="SAME",
                 wq: QuantizerSpec = QuantizerSpec(),
                 aq: QuantizerSpec = QuantizerSpec(), split: int = 0,
                 disable_act_quant: bool = False):
        super().__init__()
        self.kernel_size, self.strides = tuple(kernel_size), tuple(strides)
        self.padding, self.wq, self.aq = padding, wq, aq
        self.split, self.disable_act_quant = split, disable_act_quant
        self.features = features
        self.weight = nn.Parameter(torch.empty(features, in_ch, *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))
        self.act_quantizer = ActQuantizer(aq)
        if split > 0:
            self.act_quantizer_1 = ActQuantizer(aq)
        self._init_weight_quant(features, in_ch, self.kernel_size, split)
        self._border_cache = {}

    def pads(self, h: int, w: int):
        if self.padding == "SAME":
            return same_pads(h, w, *self.kernel_size, *self.strides)
        if self.padding == "VALID":
            return ((0, 0), (0, 0))
        return tuple(tuple(p) for p in self.padding)

    def forward(self, x: torch.Tensor, mode: QuantMode) -> torch.Tensor:
        if int8_conv_serving(mode, self.wq, self.aq, self.disable_act_quant,
                             self.split):
            return self._int8_forward(x, mode)
        if not self.disable_act_quant:
            if self.split > 0:
                x = torch.cat([self.act_quantizer(x[..., :self.split], mode),
                               self.act_quantizer_1(x[..., self.split:], mode)],
                              dim=-1)
            else:
                x = self.act_quantizer(x, mode)
        x, w = _promote(x, self.weight)
        (top, bottom), (left, right) = self.pads(x.shape[1], x.shape[2])
        if (self.kernel_size == (1, 1) and self.strides == (1, 1)
                and self.padding == "VALID" and mode.a_quant):
            n, h, ww, ci = x.shape
            out = (x.reshape(-1, ci) @ w.reshape(self.features, ci).t()
                   ).reshape(n, h, ww, self.features)
        else:
            xn = x.permute(0, 3, 1, 2)
            if top == bottom and left == right:
                out = F.conv2d(xn, w, stride=self.strides, padding=(top, left))
            else:
                out = F.conv2d(F.pad(xn, (left, right, top, bottom)), w,
                               stride=self.strides)
            out = out.permute(0, 2, 3, 1)
        return out + self.bias

    def border(self, h: int, w: int, pads) -> torch.Tensor:
        """int32 pad-indicator conv of the weight codes, cached per input
        size (the codes are fixed while serving)."""
        key = (h, w, self.w0_int.device, self.w0_int.data_ptr(),
               self.w0_int._version)
        b = self._border_cache.get(key)
        if b is None:
            self._border_cache.clear()
            b = self._border_cache[key] = border_map(
                self.w0_int, h, w, self.strides, pads)
        return b

    def _int8_forward(self, x: torch.Tensor, mode: QuantMode) -> torch.Tensor:
        """Quantize the unpadded input to int8 codes, run the int8 conv with
        int32 accumulation and the fused f32 epilogue (kernel K1)."""
        if self.w0_int is None:
            raise RuntimeError("DEPLOY_INT8 needs export_serving_int8 weights")
        h, w = x.shape[1], x.shape[2]
        pads = self.pads(h, w)
        d, zp = self.act_quantizer(x, mode, params_only=True)
        codes, c = quantize_act_int8(x, d, zp, self.aq.n_levels)
        border = (self.border(h, w, pads) if pads != ((0, 0), (0, 0))
                  else None)
        return int8_conv(codes.contiguous(), self.w0_int, self.w0_isum, c,
                         d * self.w0_delta, self.bias.float(), self.strides,
                         pads, border, x.dtype)


class QDense(_WeightQuantMixin, nn.Module):
    """Quantization-aware dense layer."""

    def __init__(self, in_features: int, features: int,
                 wq: QuantizerSpec = QuantizerSpec(),
                 aq: QuantizerSpec = QuantizerSpec(),
                 disable_act_quant: bool = False):
        super().__init__()
        self.wq, self.aq, self.features = wq, aq, features
        self.disable_act_quant = disable_act_quant
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.act_quantizer = ActQuantizer(aq)
        self._init_weight_quant(features, in_features, (), 0)

    def forward(self, x: torch.Tensor, mode: QuantMode) -> torch.Tensor:
        if int8_conv_serving(mode, self.wq, self.aq, self.disable_act_quant):
            if self.w0_int is None:
                raise RuntimeError("DEPLOY_INT8 needs export_serving_int8 weights")
            d, zp = self.act_quantizer(x, mode, params_only=True)
            codes, c = quantize_act_int8(x, d, zp, self.aq.n_levels)
            out = int8_dense(codes.reshape(-1, x.shape[-1]), self.w0_int,
                             c * self.w0_isum, d * self.w0_delta,
                             self.bias.float())
            return out.reshape(*x.shape[:-1], self.features).to(x.dtype)
        if not self.disable_act_quant:
            x = self.act_quantizer(x, mode)
        x, w = _promote(x, self.weight)
        return x @ w.t() + self.bias


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """N(0, 1/fan_in) initialisation (fan_in = every axis but the first)."""
    fan_in = math.prod(weight.shape[1:])
    with torch.no_grad():
        weight.normal_(0.0, fan_in ** -0.5, generator=generator)
