"""LDM / Stable-Diffusion UNet (openai architecture), serving part (port of
``eda_dm_tpu/models/ldm_unet.py``).

Module names are the JAX package's flax names: a dict entry
``input_blocks["3_0"]`` of the flax module is the attribute
``input_blocks_3_0`` here, as are ``middle_block_1``, ``output_blocks_5_2``,
``time_embed_0`` and ``out_2``; inside the blocks every name is kept
(``in_layers_2``, ``emb_layers_1``, ``qkv``, ``act_quantizer_w``,
``transformer_blocks_0``, ``attn1``, ``to_q``, ``net_0_proj``).  Layout is
NHWC; dropout is omitted (inference only).

Modes: the calibration modes (CALIB_W, CALIB_A, WQ/WAQ and, in
reconstruction, soft AdaRound and QDrop: the layers' own, ``nn/layers.py``)
and the serving modes FP, DEPLOY, DEPLOY_FUSED, DEPLOY_INT8.  Outside
DEPLOY_INT8 every attention site runs the float path, its q, k, softmax
and v quantizers in the JAX package's call order.  Both attention families
are ported: the legacy ``AttentionBlockL`` (bedroom, church) and the
spatial transformer (SD v1.4: ``SpatialTransformerL`` →
``BasicTransformerBlockL`` with self- and cross-attention and a GEGLU
feed-forward).  Each int8 attention site takes the branch
``attention_impl`` gives it: K4 (fused), K5 (flash) or K2 → K3 → K2
(einsum).  Class conditioning comes in two forms: ImageNet cin256-v2 feeds
its label as a one-token cross-attention context (``ClassEmbedder``,
``models/encoders.py``), and a config with ``num_classes`` adds a float
embedding of ``y`` (``label_emb``, never quantized) to the timestep
embedding, in every mode, as the JAX package does.

flax's ``nn.LayerNorm`` returns the promotion of its input's and its
parameters' dtypes, so in the transformer blocks a bf16 input with float32
norm parameters (the FP model fed a bf16 input) is carried in float32 from
the first norm on, through ``attn(norm(x)) + x``; after
``export_serving(..., bf16)`` the norm parameters are bf16 too and the
blocks stay bf16.  ``LayerNorm`` here does the same.

The first/last policy: ``time_embed_0`` and ``out_2`` are 8-bit (so they
serve on the folded path), ``out_2``'s act quant is disabled, and the
registration-last act quantizer of the last output-block item (a skip
conv, ``proj_out`` or the upsample conv) is 8-bit (``aq_last``).

:func:`ldm_recon_plan` and :func:`ldm_layer_plan` list the reconstruction
targets as the JAX package does (names, paths, kinds, ``has_temb``,
``has_ctx``, inner taps, order).  As in ``ddpm_unet.py``, a block's
``block_in`` / ``block_out`` and a layer's ``in`` / ``out`` are its
forward's first argument and its output, read by forward hooks
(``calib/recon.py``); a transformer block's ``block_ctx`` is its forward's
second argument, and the timestep embedding the res blocks take is
``temb``'s output (``LDMUNet.temb_module``: the sum after ``label_emb``,
else ``time_embed_2``'s output).  TDAC's feature is
``middle_block_1``'s input (``pipelines/latent.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..calib.recon import ReconTarget, conv_spec, dense_spec, module_spec
from ..device import resolve_device
from ..nn.layers import (ActQuantizer, GNorm, LayerNorm, QConv, QDense,
                         gelu_tanh, lecun_normal_, norm_act, norm_conv, swish,
                         timestep_embedding)
from ..ops.gn_int8 import gn_norm
from ..ops.int8_attention import (int8_flash_attention_heads,
                                  int8_fused_attention_heads)
from ..ops.int8_einsum import (int8_act_einsum, int8_code_einsum,
                               quantize_act_int8)
from ..ops.serving_policy import (attention_impl, int8_attention_serving,
                                  int8_serving, use_fused_gn)
from ..ops.softmax_codes import softmax_codes
from ..parallel import spatial
from ..parallel.rows import global_rows
from ..quant.config import FP, QuantConfig, QuantizerSpec, QuantMode
from ..utils.run import span
from .encoders import Embed


@dataclasses.dataclass(frozen=True)
class LDMUNetConfig:
    """UNetModel constructor args (openaimodel.py:477-503) that the ported
    UNet reads; resampling is always by conv."""
    image_size: int = 64
    in_channels: int = 3
    model_channels: int = 224
    out_channels: int = 3
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (8, 4, 2)  # in downsample rates
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    num_classes: Optional[int] = None
    num_heads: int = -1
    num_head_channels: int = -1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    use_spatial_transformer: bool = False
    transformer_depth: int = 1
    context_dim: Optional[int] = None
    legacy: bool = True

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * 4

    def head_split(self, ch: int) -> Tuple[int, int]:
        """(num_heads, dim_head) at a given channel width."""
        if self.num_head_channels == -1:
            heads, dim = self.num_heads, ch // self.num_heads
        else:
            heads, dim = ch // self.num_head_channels, self.num_head_channels
        if self.legacy:
            dim = ch // heads if self.use_spatial_transformer \
                else self.num_head_channels
        return heads, dim


@dataclasses.dataclass
class LayerItem:
    key: str              # flax dict key, e.g. "3_0"
    kind: str             # 'conv' | 'res' | 'attn' | 'tx' | 'down' | 'up'
    in_ch: int = 0
    out_ch: int = 0
    heads: int = 0
    dim_head: int = 0
    split: int = 0        # split point for output-block skip convs
    updown: str = ""      # '', 'up', 'down' for resblock_updown ResBlocks


@dataclasses.dataclass
class UNetLayout:
    input_blocks: List[LayerItem]
    middle_block: List[LayerItem]
    output_blocks: List[LayerItem]


def build_layout(cfg: LDMUNetConfig, split_shortcut: bool) -> UNetLayout:
    """Replays UNetModel.__init__'s channel bookkeeping."""
    mc = cfg.model_channels
    attn = "tx" if cfg.use_spatial_transformer else "attn"
    inputs: List[LayerItem] = [LayerItem("0_0", "conv", cfg.in_channels, mc)]
    input_chans = [mc]
    ch, ds, idx = mc, 1, 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            inputs.append(LayerItem(f"{idx}_0", "res", ch, mult * mc))
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                heads, dim = cfg.head_split(ch)
                inputs.append(LayerItem(f"{idx}_1", attn, ch, ch, heads, dim))
            input_chans.append(ch)
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            inputs.append(LayerItem(f"{idx}_0", "res", ch, ch, updown="down")
                          if cfg.resblock_updown
                          else LayerItem(f"{idx}_0", "down", ch, ch))
            input_chans.append(ch)
            idx += 1
            ds *= 2

    heads, dim = cfg.head_split(ch)
    middle = [LayerItem("0", "res", ch, ch),
              LayerItem("1", attn, ch, ch, heads, dim),
              LayerItem("2", "res", ch, ch)]

    outputs: List[LayerItem] = []
    out_idx = 0
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = input_chans.pop()
            outputs.append(LayerItem(f"{out_idx}_0", "res", ch + ich, mc * mult,
                                     split=ch if split_shortcut else 0))
            ch = mc * mult
            j = 1
            if ds in cfg.attention_resolutions:
                heads, dim = cfg.head_split(ch)
                outputs.append(LayerItem(f"{out_idx}_{j}", attn, ch, ch,
                                         heads, dim))
                j += 1
            if level and i == cfg.num_res_blocks:
                outputs.append(LayerItem(f"{out_idx}_{j}", "res", ch, ch,
                                         updown="up")
                               if cfg.resblock_updown
                               else LayerItem(f"{out_idx}_{j}", "up", ch, ch))
                ds //= 2
            out_idx += 1
    return UNetLayout(inputs, middle, outputs)


def _group(items: List[LayerItem]) -> Dict[int, List[LayerItem]]:
    grouped: Dict[int, List[LayerItem]] = {}
    for it in items:
        grouped.setdefault(int(it.key.split("_")[0]), []).append(it)
    return grouped


def _up2(x: torch.Tensor) -> torch.Tensor:
    """2× nearest upsample, NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 average pool, NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class ResBlockL(nn.Module):
    """LDM ResBlock, with scale-shift norm and resblock up/down."""

    @staticmethod
    def inner_taps(in_ch: int, out_ch: int) -> Tuple[Tuple[str, ...], ...]:
        taps = [("in_layers_2",), ("emb_layers_1",), ("out_layers_3",)]
        if in_ch != out_ch:
            taps.append(("skip_connection",))
        return tuple(taps)

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int, wq: QuantizerSpec,
                 aq: QuantizerSpec, use_scale_shift_norm: bool = False,
                 updown: str = "", split: int = 0,
                 aq_last: Optional[QuantizerSpec] = None):
        super().__init__()
        self.updown, self.use_scale_shift_norm = updown, use_scale_shift_norm
        self.in_layers_0 = GNorm(in_ch)
        self.in_layers_2 = QConv(in_ch, out_ch, (3, 3), wq=wq, aq=aq)
        self.emb_layers_1 = QDense(emb_ch, 2 * out_ch if use_scale_shift_norm
                                   else out_ch, wq=wq, aq=aq)
        self.out_layers_0 = GNorm(out_ch)
        self.out_layers_3 = QConv(out_ch, out_ch, (3, 3), wq=wq, aq=aq)
        self.skip_connection = (QConv(in_ch, out_ch, (1, 1), padding="VALID",
                                      wq=wq, aq=aq_last or aq, split=split)
                                if in_ch != out_ch else None)

    def _resample(self, x):
        if self.updown == "up":
            return spatial.upsample(_up2, x)
        return spatial.downsample(_avg_pool2, x) if self.updown == "down" else x

    def forward(self, x, emb, mode: QuantMode):
        # a resample between the norm and the conv keeps the norm unfused
        if self.updown:
            h = self.in_layers_2(self._resample(swish(self.in_layers_0(x))),
                                 mode)
        else:
            h = norm_conv(self.in_layers_0, self.in_layers_2, x, mode)
        x = self._resample(x)
        emb_out = self.emb_layers_1(swish(emb), mode)[:, None, None, :]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = swish(self.out_layers_0(h) * (1 + scale) + shift)
            h = self.out_layers_3(h, mode)
        else:
            h = norm_conv(self.out_layers_0, self.out_layers_3, h + emb_out,
                          mode)
        if self.skip_connection is not None:
            x = self.skip_connection(x, mode)
        return x + h


class _QKVAttention(nn.Module):
    """The q/k/w/v quantizers of one attention site and its three int8
    serving branches.  ``attend`` takes q (B, Sq, H, C) and k, v
    (B, Skv, H, C) and returns (B, Sq, H, C): through K4 (``'fused'``), K5
    (``'flash'``), whose kernels fold ``attn_scale`` into dq·dk, or
    K2 → K3 → K2 (``'einsum'``), which scales the epilogue's f32 logits
    afterwards, as the float path does (a scale of 1.0 is skipped)."""

    def _init_quantizers(self, aq: QuantizerSpec, aq_w: QuantizerSpec):
        self.aq, self.aq_w = aq, aq_w
        self.act_quantizer_q = ActQuantizer(aq)
        self.act_quantizer_k = ActQuantizer(aq)
        self.act_quantizer_w = ActQuantizer(aq_w)
        self.act_quantizer_v = ActQuantizer(aq)

    def attend(self, q, k, v, attn_scale: float, mode: QuantMode, dtype):
        b, sq, heads, c = q.shape
        L, Lw = self.aq.n_levels, self.aq_w.n_levels
        if int8_attention_serving(mode) and L <= 256 and Lw <= 256:
            dq, zq = self.act_quantizer_q(q, mode, params_only=True)
            dk, zk = self.act_quantizer_k(k, mode, params_only=True)
            dw, zw = self.act_quantizer_w(None, mode, params_only=True)
            dv, zv = self.act_quantizer_v(v, mode, params_only=True)
            impl = attention_impl(global_rows(b), heads, sq, k.shape[1], c)
            if impl in ("fused", "flash"):
                # the (b, h, i, j) logits never reach device memory
                Qc, cq = quantize_act_int8(q, dq, zq, L)
                Kc, ck = quantize_act_int8(k, dk, zk, L)
                V, cv = quantize_act_int8(v, dv, zv, L)
                fn = (int8_fused_attention_heads if impl == "fused"
                      else int8_flash_attention_heads)
                return fn(Qc, cq, dq, Kc, ck, dk, V, cv, dv, attn_scale, dw,
                          zw, Lw)
            # K2 → K3 → K2 on the heads layout
            w = int8_act_einsum("bthc,bshc->bhts", q, (dq, zq, L),
                                k, (dk, zk, L))
            if attn_scale != 1.0:
                w = w * attn_scale
            W, cw = softmax_codes(w, dw, zw, Lw)
            V, cv = quantize_act_int8(v, dv, zv, L)
            return int8_code_einsum("bhts,bshc->bthc", W, cw, dw, V, cv, dv)
        q = self.act_quantizer_q(q, mode)
        k = self.act_quantizer_k(k, mode)
        w = torch.einsum("bthc,bshc->bhts", q.float(), k.float())
        if attn_scale != 1.0:
            w = w * attn_scale
        w = torch.softmax(w, dim=-1).to(dtype)
        w = self.act_quantizer_w(w, mode)
        v = self.act_quantizer_v(v, mode)
        return torch.einsum("bhts,bshc->bthc", w.float(), v.float())


class AttentionBlockL(_QKVAttention):
    """LDM AttentionBlock with legacy QKV attention: q·C^-¼ and k·C^-¼
    quantized before the logits product (so the logit scale is 1); the
    softmax output (sm_abit, always_zero) and v before the value product.
    The ``qkv`` channels are heads × (q|k|v) × ch.  As in the JAX package,
    the residual adds the normalized input."""

    inner_taps = (("qkv",), ("proj_out",))

    def __init__(self, ch: int, num_heads: int, wq: QuantizerSpec,
                 aq: QuantizerSpec, aq_w: QuantizerSpec,
                 aq_last: Optional[QuantizerSpec] = None):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GNorm(ch)
        self.qkv = QDense(ch, 3 * ch, wq=wq, aq=aq)
        self._init_quantizers(aq, aq_w)
        self.proj_out = QDense(ch, ch, wq=wq, aq=aq_last or aq)

    def forward(self, x, mode: QuantMode):
        return spatial.run_whole(self._forward, x, mode)

    def _forward(self, x, mode: QuantMode):
        b, hh, ww, c = x.shape
        t_len, heads = hh * ww, self.num_heads
        if int8_serving(mode) and use_fused_gn(hh, ww, c):
            # K6 on the 4-D view (GroupNorm ignores the spatial layout)
            xs = gn_norm(x, *self.norm(x, params_only=True)).reshape(
                b, t_len, c)
        else:
            xs = self.norm(x.reshape(b, t_len, c))
        ch = c // heads
        qkv = self.qkv(xs, mode).reshape(b, t_len, heads, 3, ch)
        scale = 1.0 / torch.sqrt(torch.sqrt(torch.tensor(float(ch))))
        q, k, v = qkv[..., 0, :] * scale, qkv[..., 1, :] * scale, qkv[..., 2, :]
        a = self.attend(q, k, v, 1.0, mode, x.dtype)
        a = a.to(x.dtype).reshape(b, t_len, c)
        return (xs + self.proj_out(a, mode)).reshape(b, hh, ww, c)


class CrossAttentionL(_QKVAttention):
    """CrossAttention with the SD quantizers: bias-free ``to_q/to_k/to_v``,
    q/k/v quantized unscaled after the head split, the softmax output at
    sm_abit (always_zero), logits scaled by dim_head^-½.  ``context=None``
    attends to ``x`` itself (``attn1``)."""

    def __init__(self, query_dim: int, context_dim: int, heads: int,
                 dim_head: int, out_dim: int, wq: QuantizerSpec,
                 aq: QuantizerSpec, aq_w: QuantizerSpec):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = QDense(query_dim, inner, wq=wq, aq=aq, use_bias=False)
        self.to_k = QDense(context_dim, inner, wq=wq, aq=aq, use_bias=False)
        self.to_v = QDense(context_dim, inner, wq=wq, aq=aq, use_bias=False)
        self._init_quantizers(aq, aq_w)
        self.to_out_0 = QDense(inner, out_dim, wq=wq, aq=aq)

    def forward(self, x, context, mode: QuantMode):
        ctx = x if context is None else context
        q = self.to_q(x, mode)
        k, v = self.to_k(ctx, mode), self.to_v(ctx, mode)
        b, n, _ = q.shape
        m, h, d = k.shape[1], self.heads, self.dim_head
        out = self.attend(q.reshape(b, n, h, d), k.reshape(b, m, h, d),
                          v.reshape(b, m, h, d), d ** -0.5, mode, x.dtype)
        return self.to_out_0(out.to(x.dtype).reshape(b, n, h * d), mode)


class FeedForwardL(nn.Module):
    """GEGLU feed-forward: ``net_2(a · gelu(gate))`` with ``a, gate`` the
    halves of ``net_0_proj(x)``; ``jax.nn.gelu``'s default, the tanh form,
    rounded as JAX rounds it (``gelu_tanh``)."""

    def __init__(self, dim: int, wq: QuantizerSpec, aq: QuantizerSpec,
                 mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net_0_proj = QDense(dim, 2 * inner, wq=wq, aq=aq)
        self.net_2 = QDense(inner, dim, wq=wq, aq=aq)

    def forward(self, x, mode: QuantMode):
        a, gate = self.net_0_proj(x, mode).chunk(2, dim=-1)
        return self.net_2(a * gelu_tanh(gate), mode)


class BasicTransformerBlockL(nn.Module):
    """attn1 (self) → attn2 (cross) → ff, each after its LayerNorm and
    with a residual add."""

    # the reference's hook order over its modules: attn1's projections,
    # the feed-forward, then attn2's
    inner_taps = (("attn1", "to_q"), ("attn1", "to_k"), ("attn1", "to_v"),
                  ("attn1", "to_out_0"), ("ff", "net_0_proj"), ("ff", "net_2"),
                  ("attn2", "to_q"), ("attn2", "to_k"), ("attn2", "to_v"),
                  ("attn2", "to_out_0"))

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int], wq: QuantizerSpec,
                 aq: QuantizerSpec, aq_w: QuantizerSpec):
        super().__init__()
        self.attn1 = CrossAttentionL(dim, dim, heads, dim_head, dim, wq, aq, aq_w)
        self.norm1 = LayerNorm(dim)
        self.attn2 = CrossAttentionL(dim, context_dim or dim, heads, dim_head,
                                     dim, wq, aq, aq_w)
        self.norm2 = LayerNorm(dim)
        self.ff = FeedForwardL(dim, wq, aq)
        self.norm3 = LayerNorm(dim)

    def forward(self, x, context, mode: QuantMode):
        x = self.attn1(self.norm1(x), None, mode) + x
        x = self.attn2(self.norm2(x), context, mode) + x
        return self.ff(self.norm3(x), mode) + x


class SpatialTransformerL(nn.Module):
    """GroupNorm → 1×1 ``proj_in`` → ``depth`` transformer blocks over the
    H·W tokens → 1×1 ``proj_out`` (the registration-last act quantizer,
    ``aq_last``), plus the input."""

    def __init__(self, ch: int, heads: int, dim_head: int, depth: int,
                 context_dim: Optional[int], wq: QuantizerSpec,
                 aq: QuantizerSpec, aq_w: QuantizerSpec,
                 aq_last: Optional[QuantizerSpec] = None):
        super().__init__()
        self.inner = inner = heads * dim_head
        self.depth = depth
        self.norm = GNorm(ch)
        self.proj_in = QConv(ch, inner, (1, 1), padding="VALID", wq=wq, aq=aq)
        for d in range(depth):
            setattr(self, f"transformer_blocks_{d}", BasicTransformerBlockL(
                inner, heads, dim_head, context_dim, wq, aq, aq_w))
        self.proj_out = QConv(inner, ch, (1, 1), padding="VALID", wq=wq,
                              aq=aq_last or aq)

    def forward(self, x, context, mode: QuantMode):
        return spatial.run_whole(self._forward, x, context, mode)

    def _forward(self, x, context, mode: QuantMode):
        b, hh, ww, _ = x.shape
        h = norm_conv(self.norm, self.proj_in, x, mode, act=False).reshape(
            b, hh * ww, self.inner)
        for d in range(self.depth):
            h = getattr(self, f"transformer_blocks_{d}")(h, context, mode)
        h = self.proj_out(h.reshape(b, hh, ww, self.inner), mode)
        return x + h


class DownsampleL(nn.Module):
    """Stride-2 3×3 conv with the symmetric ((1,1),(1,1)) pad."""

    def __init__(self, ch: int, wq: QuantizerSpec, aq: QuantizerSpec):
        super().__init__()
        self.op = QConv(ch, ch, (3, 3), strides=(2, 2),
                        padding=((1, 1), (1, 1)), wq=wq, aq=aq)

    def forward(self, x, mode):
        return self.op(x, mode)


class UpsampleL(nn.Module):
    """2× nearest upsample + 3×3 conv."""

    def __init__(self, ch: int, wq: QuantizerSpec, aq: QuantizerSpec):
        super().__init__()
        self.conv = QConv(ch, ch, (3, 3), wq=wq, aq=aq)

    def forward(self, x, mode):
        return self.conv(spatial.upsample(_up2, x), mode)


class LDMUNet(nn.Module):
    """The LDM UNet.  Built on ``device`` (the card unless the caller passes
    ``"cpu"``) with N(0, 1/fan_in) weights drawn from ``seed``; real
    weights come through ``models/bridge.py``.  Positional order
    ``(x, t, context, y, mode)`` as in the JAX package, so a calibration
    tuple ``(x, t, ctx)`` is passed as it is."""

    temb_module = "temb"               # its output is the res blocks' temb

    def __init__(self, cfg: LDMUNetConfig = LDMUNetConfig(),
                 qc: QuantConfig = QuantConfig(), device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.qc = cfg, qc
        wq, aq = qc.wq, qc.aq
        # softmax quantizers: always_zero; the attention blocks' search is
        # asymmetric, the transformers' inherits the config's symmetry
        aq_w = qc.aq_softmax(always_zero=True, symmetric=False)
        aq_w_tx = qc.aq_softmax(always_zero=True)
        self.layout = build_layout(cfg, qc.split)
        mc, ted = cfg.model_channels, cfg.time_embed_dim
        last_key = self.layout.output_blocks[-1].key

        def make(it: LayerItem, aq_last: Optional[QuantizerSpec]):
            if it.kind == "conv":
                return QConv(it.in_ch, mc, (3, 3), wq=wq, aq=aq)
            if it.kind == "res":
                return ResBlockL(it.in_ch, it.out_ch, ted, wq, aq,
                                 cfg.use_scale_shift_norm, it.updown,
                                 it.split, aq_last)
            if it.kind == "attn":
                return AttentionBlockL(it.out_ch, it.heads, wq, aq, aq_w,
                                       aq_last)
            if it.kind == "tx":
                return SpatialTransformerL(it.out_ch, it.heads, it.dim_head,
                                           cfg.transformer_depth,
                                           cfg.context_dim, wq, aq, aq_w_tx,
                                           aq_last)
            if it.kind == "down":
                return DownsampleL(it.out_ch, wq, aq)
            if it.kind == "up":
                return UpsampleL(it.out_ch, wq, aq_last or aq)
            raise ValueError(it.kind)

        with torch.device(device):
            self.time_embed_0 = QDense(mc, ted, wq=wq.with_bits(8), aq=aq)
            self.time_embed_2 = QDense(ted, ted, wq=wq, aq=aq)
            if cfg.num_classes is not None:
                self.label_emb = Embed(cfg.num_classes, ted)
            self.temb = nn.Identity()
            for prefix in ("input_blocks", "middle_block", "output_blocks"):
                for it in getattr(self.layout, prefix):
                    last = (prefix == "output_blocks" and it.key == last_key)
                    setattr(self, f"{prefix}_{it.key}",
                            make(it, aq.with_bits(8) if last else None))
            self.out_0 = GNorm(mc)
            self.out_2 = QConv(mc, cfg.out_channels, (3, 3),
                               wq=wq.with_bits(8), aq=aq,
                               disable_act_quant=True)
        # each block group with its span name (utils/run.py::span)
        self.input_groups = [(f"edm.unet.input_blocks.{i}", items) for i, items
                             in sorted(_group(self.layout.input_blocks).items())]
        self.output_groups = [(f"edm.unet.output_blocks.{i}", items) for i, items
                              in sorted(_group(self.layout.output_blocks).items())]
        self.init_weights(seed)

    def init_weights(self, seed: int) -> None:
        g = torch.Generator(device=self.out_2.weight.device).manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (QConv, QDense)):
                lecun_normal_(m.weight, g)
        if self.cfg.num_classes is not None:
            with torch.no_grad():
                self.label_emb.embedding.normal_(0.0, 1.0, generator=g)

    def _run(self, name: str, prefix: str, items: List[LayerItem], h, emb,
             context, mode):
        with span(name):
            for it in items:
                m = getattr(self, f"{prefix}_{it.key}")
                if it.kind == "res":
                    h = m(h, emb, mode)
                elif it.kind == "tx":
                    h = m(h, context, mode)
                else:
                    h = m(h, mode)
            return h

    def forward(self, x: torch.Tensor, t: torch.Tensor, context=None, y=None,
                mode: QuantMode = FP) -> torch.Tensor:
        # unconditional models never read `context`: a QuantMode passed where
        # DDPMUNet takes its mode would otherwise run the whole net in FP
        if isinstance(context, QuantMode) or isinstance(y, QuantMode):
            raise TypeError("pass the QuantMode as mode=...; LDMUNet's "
                            "positional order is (x, t, context, y, mode)")
        with span("edm.unet.forward"):
            # the carrier dtype follows the input (bf16 on the deployment path)
            emb = timestep_embedding(t, self.cfg.model_channels).to(x.dtype)
            emb = self.time_embed_0(emb, mode)
            emb = self.time_embed_2(swish(emb), mode)
            if self.cfg.num_classes is not None:
                emb = emb + self.label_emb(y)
            emb = self.temb(emb)
            hs, h = [], x
            for name, items in self.input_groups:
                h = self._run(name, "input_blocks", items, h, emb, context, mode)
                hs.append(h)
            h = self._run("edm.unet.middle_block", "middle_block",
                          self.layout.middle_block, h, emb, context, mode)
            for name, items in self.output_groups:
                h = self._run(name, "output_blocks", items,
                              torch.cat([h, hs.pop()], -1), emb, context, mode)
            return self.out_2(norm_act(self.out_0, h, mode, act=True), mode)


# --------------------------------------------------------------------------
# reconstruction plans
# --------------------------------------------------------------------------

def ldm_recon_plan(cfg: LDMUNetConfig, qc: QuantConfig) -> List[ReconTarget]:
    """Ordered reconstruction targets, the reference's walk over the UNet:
    the time-embedding denses as layers; every res block and attention
    block as a block; a spatial transformer as ``proj_in`` (layer), its
    transformer blocks (blocks, with the text context where the config
    has one) and ``proj_out`` (layer); the down- and upsample convs and
    ``out_2`` as layers; the output blocks in execution order.  Each
    target's spec carries the JAX package's module fields, so targets
    group as they do there."""
    wq, aq = qc.wq, qc.aq
    aq_w_attn = qc.aq_softmax(always_zero=True, symmetric=False)
    aq_w_tx = qc.aq_softmax(always_zero=True)
    layout = build_layout(cfg, qc.split)
    plan = [ReconTarget("time_embed_0", ("time_embed_0",),
                        dense_spec(cfg.time_embed_dim, wq.with_bits(8), aq), "layer"),
            ReconTarget("time_embed_2", ("time_embed_2",),
                        dense_spec(cfg.time_embed_dim, wq, aq), "layer")]

    def add_item(prefix: str, it: LayerItem):
        base, name = (f"{prefix}_{it.key}",), f"{prefix}.{it.key}"
        if it.kind == "conv":
            plan.append(ReconTarget(name, base,
                                    conv_spec(cfg.model_channels, (3, 3), wq, aq),
                                    "layer"))
        elif it.kind == "res":
            plan.append(ReconTarget(
                name, base, module_spec(
                    "ResBlockL", out_ch=it.out_ch, wq=wq, aq=aq,
                    use_scale_shift_norm=cfg.use_scale_shift_norm,
                    updown=it.updown, split=it.split, use_conv_skip=False,
                    aq_last=None),
                "block", has_temb=True,
                inner_taps=ResBlockL.inner_taps(it.in_ch, it.out_ch)))
        elif it.kind == "attn":
            plan.append(ReconTarget(
                name, base, module_spec("AttentionBlockL", num_heads=it.heads,
                                        wq=wq, aq=aq, aq_w=aq_w_attn, aq_last=None),
                "block", inner_taps=AttentionBlockL.inner_taps))
        elif it.kind == "tx":
            inner = it.heads * it.dim_head
            plan.append(ReconTarget(f"{name}.proj_in", base + ("proj_in",),
                                    conv_spec(inner, (1, 1), wq, aq, padding="VALID"),
                                    "layer"))
            for d in range(cfg.transformer_depth):
                plan.append(ReconTarget(
                    f"{name}.tx_{d}", base + (f"transformer_blocks_{d}",),
                    module_spec("BasicTransformerBlockL", heads=it.heads,
                                dim_head=it.dim_head, dim=inner, wq=wq, aq=aq,
                                aq_w=aq_w_tx),
                    "block", has_ctx=cfg.context_dim is not None,
                    inner_taps=BasicTransformerBlockL.inner_taps))
            plan.append(ReconTarget(f"{name}.proj_out", base + ("proj_out",),
                                    conv_spec(it.out_ch, (1, 1), wq, aq, padding="VALID"),
                                    "layer"))
        elif it.kind == "down":
            plan.append(ReconTarget(name, base + ("op",),
                                    conv_spec(it.out_ch, (3, 3), wq, aq, strides=(2, 2),
                                              padding=((1, 1), (1, 1))), "layer"))
        elif it.kind == "up":
            plan.append(ReconTarget(name, base + ("conv",),
                                    conv_spec(it.out_ch, (3, 3), wq, aq), "layer"))

    for prefix in ("input_blocks", "middle_block", "output_blocks"):
        for it in getattr(layout, prefix):
            add_item(prefix, it)
    plan.append(ReconTarget("out_2", ("out_2",),
                            conv_spec(cfg.out_channels, (3, 3), wq.with_bits(8), aq,
                                      disable_act_quant=True), "layer"))
    return plan


def ldm_layer_plan(cfg: LDMUNetConfig, qc: QuantConfig) -> List[ReconTarget]:
    """Layer-mode plan (the reference's ablation path): every quantized
    layer reconstructs alone; an attention block becomes its ``qkv``, a
    whole-block target that trains only its act deltas (``act_only``) and
    its ``proj_out``; transformer blocks keep their block targets."""
    wq, aq = qc.wq, qc.aq
    plan = []
    for t in ldm_recon_plan(cfg, qc):
        cls, fields = t.spec[0], dict(t.spec[1])
        if t.kind == "layer" or cls == "BasicTransformerBlockL":
            plan.append(t)
        elif cls == "AttentionBlockL":
            ch = _layer_item(cfg, qc, t.path).out_ch
            plan.append(ReconTarget(f"{t.name}.qkv", t.path + ("qkv",),
                                    dense_spec(3 * ch, wq, aq), "layer"))
            plan.append(ReconTarget(f"{t.name}.acts", t.path, t.spec, "block",
                                    act_only=True, inner_taps=t.inner_taps))
            plan.append(ReconTarget(f"{t.name}.proj_out", t.path + ("proj_out",),
                                    dense_spec(ch, wq, aq), "layer"))
        else:                                   # ResBlockL: its layers in order
            out_ch = fields["out_ch"]
            emb = 2 * out_ch if cfg.use_scale_shift_norm else out_ch
            for (leaf,) in t.inner_taps:
                spec = (dense_spec(emb, wq, aq) if leaf == "emb_layers_1" else
                        conv_spec(out_ch, (1, 1), wq, aq, padding="VALID",
                                  split=fields["split"]) if leaf == "skip_connection"
                        else conv_spec(out_ch, (3, 3), wq, aq))
                plan.append(ReconTarget(f"{t.name}.{leaf}", t.path + (leaf,), spec,
                                        "layer"))
    return plan


def _layer_item(cfg: LDMUNetConfig, qc: QuantConfig, path) -> LayerItem:
    """The layout item whose module is at ``path`` (``("input_blocks_1_1",)``)."""
    layout = build_layout(cfg, qc.split)
    for prefix in ("input_blocks", "middle_block", "output_blocks"):
        for it in getattr(layout, prefix):
            if (f"{prefix}_{it.key}",) == tuple(path):
                return it
    raise KeyError(path)
