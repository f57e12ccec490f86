"""Quantization-aware layers (port of ``eda_dm_tpu/nn/layers.py``).

Activations are NHWC ``(N, H, W, C)`` tensors as in the JAX package.  Float
conv weights are ``[Cout, Cin, kh, kw]`` (what ``F.conv2d`` takes), dense
weights ``[out, in]``; integer weight codes are ``[Cout, kh, kw, Cin]`` and
``[out, in]``, K contiguous, as the int8 kernels take them.  Quantizer
state is buffers:

* ``ActQuantizer``: ``delta``, ``zero_point``, the calibration state
  ``running_min``, ``running_max``, ``one_side``, ``inited`` and the width
  ``a_bits`` (per tensor);
* ``QConv``/``QDense``, per channel group ``w0`` (and ``w1`` for split
  layers): ``w{i}_delta``, ``w{i}_zp`` (Cout,), ``w{i}_alpha`` (weight
  shaped), and after ``export_serving_int8`` ``w{i}_int``, ``w{i}_isum``.

Modes: the calibration modes CALIB_W (weight scales and alphas from the
weights), CALIB_A (act-range search + EMA per batch), WQ/WAQ and, in
reconstruction, soft AdaRound and QDrop (``quant/config.py``); the serving
modes FP, DEPLOY (folded weights + act fake-quant), DEPLOY_FUSED (DEPLOY
with the act fake-quant of 1×1 convs and denses inside the matmul, K7) and
DEPLOY_INT8.  On the int8 path a GroupNorm (+ swish) in front of a conv can
run fused with the conv's input quantize and pad (K6, :func:`norm_conv`),
and a norm with several consumers in one pass (:func:`norm_act`).  Layer
and block inputs and outputs are captured with forward hooks
(``calib/recon.py``), not by the layers.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.gn_int8 import NO_PADS, gn_norm, gn_swish_int8
from ..ops.int8_conv import border_map, int8_conv, same_pads
from ..ops.int8_einsum import int8_dense, quantize_act_int8
from ..ops.quant_matmul import fakequant_matmul
from ..ops.serving_policy import int8_conv_serving, int8_serving, use_fused_gn
from ..parallel import comm, rows, spatial
from ..quant import search
from ..quant.adaround import adaround_fake_quant, adaround_int, init_alpha
from ..quant.affine import ema_update, fake_quant, qdrop
from ..quant.config import QuantizerSpec, QuantMode


class ActQuantizer(nn.Module):
    """Per-tensor activation fake-quantizer with streaming MSE calibration.

    Under ``mode.calib_a`` each forward searches the range of the live
    batch (``search_range``, or ``search_range_hist`` past 4·``search_bins``
    elements), EMA-updates the running range (the first batch seeds it)
    and re-derives (delta, zero_point); the one-sidedness found on the
    first batch is kept (``mode.static_sides`` may give it by quantizer
    name).  Otherwise the frozen state is used.  Under ``mode.training``
    QDrop keeps each quantized value with probability ``spec.prob``, the
    mask drawn from ``self.generator`` (set by the caller; a QDrop forward
    without one raises).  ``name`` is the quantizer's module name in its
    model, which ``static_sides`` keys on (``scale_init.name_quantizers``).
    """

    def __init__(self, spec: QuantizerSpec):
        super().__init__()
        self.spec = spec
        self.generator: Optional[torch.Generator] = None
        self.name = ""
        f32 = dict(dtype=torch.float32)
        self.register_buffer("delta", torch.ones((), **f32))
        self.register_buffer("zero_point", torch.zeros((), **f32))
        self.register_buffer("running_min", torch.zeros((), **f32))
        self.register_buffer("running_max", torch.zeros((), **f32))
        self.register_buffer("one_side", torch.zeros((), dtype=torch.int32))
        self.register_buffer("inited", torch.zeros((), dtype=torch.bool))
        self.register_buffer("a_bits", torch.tensor(spec.n_bits, dtype=torch.int32))

    def forward(self, x: torch.Tensor, mode: QuantMode,
                params_only: bool = False):
        if params_only:
            return self.delta, self.zero_point
        if not (mode.a_quant or mode.calib_a):
            return x
        if spatial.active() and (mode.calib_a or (mode.training and self.spec.prob < 1.0)):
            raise NotImplementedError("calibration and QDrop forwards do not run "
                                      "with the height sharded (parallel/spatial.py)")
        if mode.calib_a:
            self.calibrate(x, mode)
        x_fq = fake_quant(x, self.delta, self.zero_point, self.spec.n_levels)
        if mode.training and self.spec.prob < 1.0:
            if self.generator is None:
                raise RuntimeError("a QDrop forward needs the quantizer's "
                                   "generator (calib/recon.py sets it)")
            keep = rows.draw(torch.rand, x.shape, generator=self.generator,
                             device=x.device) < self.spec.prob
            x_fq = qdrop(x_fq, x, self.spec.prob, mask=keep)
        return x_fq

    @torch.no_grad()
    def calibrate(self, x: torch.Tensor, mode: QuantMode) -> None:
        spec = self.spec
        xf = x.reshape(-1).float()
        group = rows.stats_group()
        static_side = (dict(mode.static_sides).get(self.name)
                       if mode.static_sides is not None else None)
        if static_side is not None:
            side = torch.tensor(static_side, dtype=torch.int32, device=x.device)
        elif int(self.one_side) == search.ONE_SIDE_UNSET:
            side = search.detect_one_side(xf, group)
        else:
            side = self.one_side
        if spec.search_bins and rows.global_rows(xf.numel()) > 4 * spec.search_bins:
            lo, hi = search.search_range_hist(
                xf, spec.n_levels, side, spec.symmetric, spec.num_candidates,
                spec.search_bins, static_side=static_side, group=group)
        else:
            if group is not None:
                xf = comm.all_gather(xf, group)     # small: the rows in rank order
            lo, hi = search.search_range(xf, spec.n_levels, side, spec.symmetric,
                                         spec.num_candidates,
                                         static_side=static_side)
        if bool(self.inited):
            lo, hi = ema_update(self.running_min, self.running_max, lo, hi)
        d, zp = search.range_qparams(lo, hi, spec.n_levels)
        if spec.always_zero:
            zp = torch.zeros_like(d)
        self.one_side.copy_(side)
        self.running_min.copy_(lo)
        self.running_max.copy_(hi)
        self.delta.copy_(d)
        self.zero_point.copy_(zp)
        self.inited.fill_(True)


class GNorm(nn.Module):
    """GroupNorm(32, eps=1e-6) over NHWC with the JAX package's explicit
    two-pass float32 variance; the output keeps the input dtype.
    (``F.group_norm``'s variance differs and flips borderline act codes.)
    On rows of a sharded height (``parallel/spatial.py``) each pass's sums
    are added over the ranks in rank order and divided by the global count
    (under ``spatial.rank_blocks``, one process's blocks of rows alike).
    ``params_only=True`` returns ``(scale, bias)`` for the fused kernel."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, params_only: bool = False):
        if params_only:
            return self.scale, self.bias
        c = x.shape[-1]
        xg = x.float().reshape(*x.shape[:-1], self.num_groups,
                               c // self.num_groups)
        axes = tuple(range(1, x.dim() - 1)) + (x.dim(),)
        if spatial.splits_sums(x):
            count = spatial.count(xg, axes)
            mean = spatial.height_sum(xg, axes) / count
            var = spatial.height_sum((xg - mean) ** 2, axes) / count
        else:
            mean = xg.mean(dim=axes, keepdim=True)
            var = ((xg - mean) ** 2).mean(dim=axes, keepdim=True)
        y = (xg - mean) * torch.rsqrt(var + self.eps)
        y = y.reshape(x.shape) * self.scale + self.bias
        return y.to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm()`` over the last axis, as flax computes it:
    epsilon 1e-6 unless given; mean and variance in float32, the variance
    E[x²] − E[x]² clipped at 0; the scale folded into the reciprocal
    deviation before the product; the output in the promotion of the
    input's and the parameters' dtypes (so a bf16 input with float32
    parameters gives a float32 output, and with bf16 parameters a bf16
    one).  PyTorch's ``F.layer_norm`` keeps the input dtype and computes
    the variance in two passes."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mean * mean,
                              0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        y = (xf - mean) * mul + self.bias.float()
        dtype = torch.promote_types(torch.promote_types(
            x.dtype, self.scale.dtype), self.bias.dtype)
        return y.to(dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default, the tanh form) as JAX computes it:
    ``x·½(1 + tanh(√(2/π)(x + 0.044715·x³)))`` with every constant and
    every step in the input's dtype.  On a bf16 carrier JAX rounds each
    step to bf16; ``F.gelu(approximate="tanh")``, which rounds once, gives
    another bf16 value for 43 % of inputs."""
    k = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
    return x * (k(0.5) * (k(1.0) + torch.tanh(
        k(math.sqrt(2.0 / math.pi)) * (x + k(0.044715) * x ** 3))))


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

    @torch.no_grad()
    def calibrate_weights(self) -> None:
        """CALIB_W: each group's (delta, zp) by the per-output-channel MSE
        search on the weight, and the alphas that make hard rounding
        round-to-nearest.  The search runs on the JAX package's layout
        (output channel, then kh, kw, Cin), so its sums go in JAX's
        order."""
        spec = self.wq
        for name, s, e in self._parts:
            w = self.weight[:, s:e].float()
            wj = w.permute(0, 2, 3, 1) if w.dim() == 4 else w
            d, zp = search.weight_qparams(wj, spec.n_levels, spec.symmetric,
                                          0 if spec.channel_wise else None,
                                          spec.num_candidates, spec.always_zero)
            d = d.reshape(-1).expand(w.shape[0]).contiguous()
            zp = zp.reshape(-1).expand(w.shape[0]).contiguous()
            setattr(self, f"{name}_delta", d)
            setattr(self, f"{name}_zp", zp)
            setattr(self, f"{name}_alpha", init_alpha(w, self._per_channel(d)))

    def quantized_weight(self, mode: QuantMode) -> torch.Tensor:
        """The weight under ``mode``: AdaRound fake-quant (soft under
        ``mode.soft_targets``, hard otherwise) when ``mode.w_quant``, after
        the CALIB_W search when ``mode.calib_w``; else the float weight."""
        if mode.calib_w:
            self.calibrate_weights()
        if not mode.w_quant:
            return self.weight
        return self._fake_quant_weight(mode.soft_targets)

    def _fake_quant_weight(self, soft: bool) -> torch.Tensor:
        parts = []
        for name, s, e in self._parts:
            parts.append(adaround_fake_quant(
                self.weight[:, s:e], self._per_channel(getattr(self, f"{name}_delta")),
                self._per_channel(getattr(self, f"{name}_zp")),
                getattr(self, f"{name}_alpha"), self.wq.n_levels, soft))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def folded_weight(self) -> torch.Tensor:
        """Hard-AdaRound dequantized weight, ``[Cout, Cin, ...]``."""
        return self._fake_quant_weight(False)

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

    def forward(self, x: torch.Tensor, mode: QuantMode,
                pre_gn=None) -> torch.Tensor:
        """``pre_gn = (scale, bias, swish)``: x is the input of the producer
        GroupNorm, which runs fused with the int8 quantize and pad (K6);
        only on the int8 serving path (callers: :func:`norm_conv`)."""
        if int8_conv_serving(mode, self.wq, self.aq, self.disable_act_quant,
                             self.split):
            return self._int8_forward(x, mode, pre_gn)
        if pre_gn is not None:
            raise ValueError("pre_gn requires the int8 serving path")
        if (mode.fused and mode.a_quant and not self.disable_act_quant
                and self.kernel_size == (1, 1) and self.strides == (1, 1)):
            # a 1×1 conv is a matmul over channels (K7); a split layer's
            # two quantizers give per-input-channel rows over their ranges
            c = x.shape[-1]
            parts = ([(self.act_quantizer, self.split),
                      (self.act_quantizer_1, c - self.split)] if self.split
                     else [(self.act_quantizer, c)])
            return _fused_matmul(x, self.weight.reshape(self.features, c).t(),
                                 parts, mode, self.aq.n_levels, self.bias)
        if not self.disable_act_quant:
            if self.split > 0:
                x = torch.cat([self.act_quantizer(x[..., :self.split], mode),
                               self.act_quantizer_1(x[..., self.split:], mode)],
                              dim=-1)
            else:
                x = self.act_quantizer(x, mode)
        x, w = _promote(x, self.quantized_weight(mode))

        def conv(x, pads):
            (top, bottom), (left, right) = pads
            if (self.kernel_size == (1, 1) and self.strides == (1, 1)
                    and self.padding == "VALID" and (mode.a_quant or mode.calib_a)):
                n, h, ww, ci = x.shape
                return (x.reshape(-1, ci) @ w.reshape(self.features, ci).t()
                        ).reshape(n, h, ww, self.features)
            xn = x.permute(0, 3, 1, 2)
            if top == bottom and left == right:
                out = F.conv2d(xn, w, stride=self.strides, padding=(top, left))
            else:
                out = F.conv2d(F.pad(xn, (left, right, top, bottom)), w,
                               stride=self.strides)
            return out.permute(0, 2, 3, 1)
        return spatial.conv(conv, x, self.kernel_size, self.strides, self.pads) + self.bias

    def border(self, h: int, w: int, pads) -> torch.Tensor:
        """int32 pad-indicator conv of the weight codes, cached per input
        size and pads (the codes are fixed while serving; the shards of a
        sharded height take other pads at the same size)."""
        key = (h, w, pads, self.w0_int.device, self.w0_int.data_ptr(),
               self.w0_int._version)
        b = self._border_cache.get(key)
        if b is None:
            self._border_cache.clear()
            b = self._border_cache[key] = border_map(
                self.w0_int, h, w, self.strides, pads)
        return b

    def _int8_forward(self, x: torch.Tensor, mode: QuantMode,
                      pre_gn=None) -> torch.Tensor:
        """Quantize the unpadded input to int8 codes, run the int8 conv with
        int32 accumulation and the fused f32 epilogue (kernel K1).  With
        ``pre_gn`` the fused GroupNorm (K6) writes the codes already padded
        with the code of 0, and K1 runs VALID over them, with no border
        correction.

        On rows of a sharded height (``parallel/spatial.py``) the halo rows
        are exchanged as int8 codes (quantization is elementwise under one
        Δ, so this equals exchanging the activations, at half a bf16
        carrier's bytes) and K1 takes the shard's pads, so the border
        correction applies only at the global edge.  With ``pre_gn``, K6
        computes its statistics over the tensor it is given, so it runs on
        the gathered height and this rank keeps its codes with their halo
        rows."""
        if self.w0_int is None:
            raise RuntimeError("DEPLOY_INT8 needs export_serving_int8 weights")
        if pre_gn is not None and self.split:
            raise ValueError("pre_gn takes no split layer")
        site = spatial.conv_site(x, self.kernel_size, self.strides, self.pads)
        pads = site.pads
        d, zp = self.act_quantizer(x, mode, params_only=True)
        if pre_gn is not None:
            gn_scale, gn_bias, act = pre_gn
            codes, c = gn_swish_int8(site.whole(x), gn_scale, gn_bias, d, zp,
                                     self.aq.n_levels, site.global_pads, swish=act)
            codes = site.padded_rows(codes)
            pads, border = NO_PADS, None
        else:
            codes, c = quantize_act_int8(x, d, zp, self.aq.n_levels)
            codes = site.rows(codes)
            border = (self.border(codes.shape[1], codes.shape[2], pads)
                      if pads != NO_PADS else None)
        return int8_conv(codes.contiguous(), self.w0_int, self.w0_isum, c,
                         d * self.w0_delta, self.bias.float(), self.strides,
                         pads, border, x.dtype)


class QDense(_WeightQuantMixin, nn.Module):
    """Quantization-aware dense layer; ``use_bias=False`` has no bias
    parameter (the JAX tree has no leaf for it)."""

    def __init__(self, in_features: int, features: int,
                 wq: QuantizerSpec = QuantizerSpec(),
                 aq: QuantizerSpec = QuantizerSpec(),
                 disable_act_quant: bool = False, use_bias: bool = True):
        super().__init__()
        self.wq, self.aq, self.features = wq, aq, features
        self.disable_act_quant = disable_act_quant
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
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
                             None if self.bias is None else self.bias.float())
            return out.reshape(*x.shape[:-1], self.features).to(x.dtype)
        if mode.fused and mode.a_quant and not self.disable_act_quant:
            return _fused_matmul(x, self.weight.t(),
                                 [(self.act_quantizer, x.shape[-1])], mode,
                                 self.aq.n_levels, self.bias)
        if not self.disable_act_quant:
            x = self.act_quantizer(x, mode)
        x, w = _promote(x, self.quantized_weight(mode))
        out = x @ w.t()
        return out if self.bias is None else out + self.bias


def _fused_matmul(x, w, parts, mode, n_levels, bias):
    """``fake_quant(x) @ w + bias`` over x's last axis through K7, for w
    (K, N); ``parts`` lists (act quantizer, channels) over consecutive
    input-channel ranges, whose (Δ, zp) become per-channel rows."""
    pairs = [q(x, mode, params_only=True) for q, _ in parts]
    delta_k = torch.cat([d.expand(n) for (d, _), (_, n) in zip(pairs, parts)])
    zp_k = torch.cat([z.expand(n) for (_, z), (_, n) in zip(pairs, parts)])
    out = fakequant_matmul(x.reshape(-1, x.shape[-1]), w, delta_k, zp_k,
                           n_levels, bias)
    return out.reshape(*x.shape[:-1], w.shape[1])


def norm_conv(norm: GNorm, conv: QConv, x: torch.Tensor, mode: QuantMode,
              act: bool = True) -> torch.Tensor:
    """``conv(swish(norm(x)))`` (``act=False``: ``conv(norm(x))``).  On the
    int8 serving path, where ``use_fused_gn`` admits x's shape, the norm
    (+ swish) runs fused with the conv's input quantize and pad (K6), as
    the JAX package's blocks choose it."""
    if (int8_conv_serving(mode, conv.wq, conv.aq, conv.disable_act_quant,
                          conv.split)
            and use_fused_gn(*spatial.global_shape(x)[1:])):
        return conv(x, mode, pre_gn=(*norm(x, params_only=True), act))
    y = norm(x)
    return conv(swish(y) if act else y, mode)


def norm_act(norm: GNorm, x: torch.Tensor, mode: QuantMode,
             act: bool = False) -> torch.Tensor:
    """``norm(x)`` (``act``: ``swish(norm(x))``) of an NHWC x, for a norm
    with several consumers; on the int8 serving path, where
    ``use_fused_gn`` admits the shape, in one pass (K6's ``gn_norm``; on
    rows of a sharded height, over the gathered height, this rank's rows
    kept)."""
    if int8_serving(mode) and use_fused_gn(*spatial.global_shape(x)[1:]):
        return spatial.run_whole(
            lambda t: gn_norm(t, *norm(t, params_only=True), swish=act), x)
    y = norm(x)
    return swish(y) if act else y


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """N(0, 1/fan_in) initialisation (fan_in = every axis but the first)."""
    fan_in = math.prod(weight.shape[1:])
    with torch.no_grad():
        weight.normal_(0.0, fan_in ** -0.5, generator=generator)
