"""DDPM UNet (CIFAR/LSUN pixel space), serving part (port of
``eda_dm_tpu/models/ddpm_unet.py``).

Module paths follow the JAX variable paths mechanically: a flax list entry
``down_0/block_1/conv1`` is ``down[0].block[1].conv1`` here, every other
name is kept (``mid_attn_1.act_quantizer_q``, ``GroupNorm_0``).  Layout is
NHWC; dropout is omitted (inference only).

The first/last policy: the first weight quantizer (``temb_dense_0``) and
the last (``conv_out``) are 8-bit, ``conv_out``'s act quant is disabled and
the top level's upsample conv has an 8-bit act quantizer.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from ..device import resolve_device
from ..nn.layers import (ActQuantizer, GNorm, QConv, QDense, lecun_normal_,
                         swish, timestep_embedding)
from ..ops.int8_einsum import (int8_act_einsum, int8_code_einsum,
                               quantize_act_int8)
from ..ops.serving_policy import int8_serving
from ..ops.softmax_codes import softmax_int8_codes
from ..quant.config import FP, QuantConfig, QuantizerSpec, QuantMode


@dataclasses.dataclass(frozen=True)
class DDPMConfig:
    """Architecture hyperparameters (configs/cifar10.yml 'model' section)."""
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 2, 2)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    resolution: int = 32

    @property
    def temb_ch(self) -> int:
        return self.ch * 4

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)


class ResnetBlockD(nn.Module):
    """DDPM ResnetBlock; ``split`` > 0 puts the dual quantizer on the 1×1
    shortcut only."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: int,
                 wq: QuantizerSpec, aq: QuantizerSpec, split: int = 0):
        super().__init__()
        self.GroupNorm_0 = GNorm(in_ch)
        self.conv1 = QConv(in_ch, out_ch, (3, 3), wq=wq, aq=aq)
        self.temb_proj = QDense(temb_ch, out_ch, wq=wq, aq=aq)
        self.GroupNorm_1 = GNorm(out_ch)
        self.conv2 = QConv(out_ch, out_ch, (3, 3), wq=wq, aq=aq)
        self.nin_shortcut = (QConv(in_ch, out_ch, (1, 1), padding="VALID",
                                   wq=wq, aq=aq, split=split)
                             if in_ch != out_ch else None)

    def forward(self, x, temb, mode: QuantMode):
        h = self.conv1(swish(self.GroupNorm_0(x)), mode)
        h = h + self.temb_proj(swish(temb), mode)[:, None, None, :]
        h = self.conv2(swish(self.GroupNorm_1(h)), mode)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x, mode)
        return x + h


class AttnBlockD(nn.Module):
    """DDPM self-attention block.  q and k are quantized unscaled after
    their 1×1 convs; the softmax output is quantized at sm_abit and v at
    act_bit before the second product."""

    def __init__(self, ch: int, wq: QuantizerSpec, aq: QuantizerSpec,
                 aq_w: QuantizerSpec):
        super().__init__()
        self.aq, self.aq_w = aq, aq_w
        self.GroupNorm_0 = GNorm(ch)
        self.q = QConv(ch, ch, (1, 1), padding="VALID", wq=wq, aq=aq)
        self.k = QConv(ch, ch, (1, 1), padding="VALID", wq=wq, aq=aq)
        self.v = QConv(ch, ch, (1, 1), padding="VALID", wq=wq, aq=aq)
        self.act_quantizer_q = ActQuantizer(aq)
        self.act_quantizer_k = ActQuantizer(aq)
        self.act_quantizer_v = ActQuantizer(aq)
        self.act_quantizer_w = ActQuantizer(aq_w)
        self.proj_out = QConv(ch, ch, (1, 1), padding="VALID", wq=wq, aq=aq)

    def forward(self, x, mode: QuantMode):
        n, hh, ww, c = x.shape
        h = self.GroupNorm_0(x)
        q = self.q(h, mode).reshape(n, hh * ww, c)
        k = self.k(h, mode).reshape(n, hh * ww, c)
        v = self.v(h, mode).reshape(n, hh * ww, c)
        L, Lw = self.aq.n_levels, self.aq_w.n_levels
        if int8_serving(mode) and L <= 256 and Lw <= 256:
            # both products run int8×int8→int32 (kernel K2) with the exact
            # recentering epilogue; softmax→codes is kernel K3.  This einsum
            # branch is the only int8 attention until the fused kernels
            # (K4/K5) are ported.
            dq, zq = self.act_quantizer_q(q, mode, params_only=True)
            dk, zk = self.act_quantizer_k(k, mode, params_only=True)
            dv, zv = self.act_quantizer_v(v, mode, params_only=True)
            dw, zw = self.act_quantizer_w(None, mode, params_only=True)
            w = int8_act_einsum("nic,njc->nij", q, (dq, zq, L),
                                k, (dk, zk, L)) * (c ** -0.5)
            W, cw = softmax_int8_codes(w, dw, zw, Lw)
            V, cv = quantize_act_int8(v, dv, zv, L)
            h = int8_code_einsum("nij,njc->nic", W, cw, dw, V, cv, dv)
        else:
            q = self.act_quantizer_q(q, mode)
            k = self.act_quantizer_k(k, mode)
            w = torch.bmm(q.float(), k.float().transpose(1, 2)) * (c ** -0.5)
            w = torch.softmax(w, dim=-1).to(x.dtype)
            v = self.act_quantizer_v(v, mode)
            w = self.act_quantizer_w(w, mode)
            h = torch.bmm(w.float(), v.float())
        h = h.to(x.dtype).reshape(n, hh, ww, c)
        return x + self.proj_out(h, mode)


class Downsample(nn.Module):
    """Stride-2 conv with the reference's asymmetric ((0,1),(0,1)) pad."""

    def __init__(self, ch: int, wq: QuantizerSpec, aq: QuantizerSpec):
        super().__init__()
        self.conv = QConv(ch, ch, (3, 3), strides=(2, 2),
                          padding=((0, 1), (0, 1)), wq=wq, aq=aq)

    def forward(self, x, mode):
        return self.conv(x, mode)


class Upsample(nn.Module):
    """2× nearest upsample + 3×3 conv."""

    def __init__(self, ch: int, wq: QuantizerSpec, aq: QuantizerSpec):
        super().__init__()
        self.conv = QConv(ch, ch, (3, 3), wq=wq, aq=aq)

    def forward(self, x, mode):
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return self.conv(x, mode)


class DownLevel(nn.Module):
    def __init__(self, cfg: DDPMConfig, level: int, wq, aq, aq_w):
        super().__init__()
        in_ch_mult = (1,) + tuple(cfg.ch_mult)
        block_in = cfg.ch * in_ch_mult[level]
        block_out = cfg.ch * cfg.ch_mult[level]
        has_attn = cfg.resolution // (2 ** level) in cfg.attn_resolutions
        self.block = nn.ModuleList(
            ResnetBlockD(block_in if i == 0 else block_out, block_out,
                         cfg.temb_ch, wq, aq)
            for i in range(cfg.num_res_blocks))
        self.attn = nn.ModuleList(
            AttnBlockD(block_out, wq, aq, aq_w)
            for _ in range(cfg.num_res_blocks if has_attn else 0))
        self.downsample = (Downsample(block_out, wq, aq)
                           if level != cfg.num_resolutions - 1 else None)

    def forward(self, h, temb, mode):
        outs = []
        for i, blk in enumerate(self.block):
            h = blk(h, temb, mode)
            if len(self.attn):
                h = self.attn[i](h, mode)
            outs.append(h)
        if self.downsample is not None:
            h = self.downsample(h, mode)
            outs.append(h)
        return h, outs


class UpLevel(nn.Module):
    def __init__(self, cfg: DDPMConfig, level: int, wq, aq, aq_w,
                 split_channels: Tuple[int, ...],
                 aq_upsample: Optional[QuantizerSpec] = None):
        super().__init__()
        in_ch_mult = (1,) + tuple(cfg.ch_mult)
        block_out = cfg.ch * cfg.ch_mult[level]
        h_first = cfg.ch * (cfg.ch_mult[-1] if level == cfg.num_resolutions - 1
                            else cfg.ch_mult[level + 1])
        has_attn = cfg.resolution // (2 ** level) in cfg.attn_resolutions
        blocks = []
        for j in range(cfg.num_res_blocks + 1):
            skip = cfg.ch * (in_ch_mult[level] if j == cfg.num_res_blocks
                             else cfg.ch_mult[level])
            h_ch = h_first if j == 0 else block_out
            blocks.append(ResnetBlockD(h_ch + skip, block_out, cfg.temb_ch,
                                       wq, aq, split=split_channels[j]))
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(
            AttnBlockD(block_out, wq, aq, aq_w)
            for _ in range(cfg.num_res_blocks + 1 if has_attn else 0))
        self.upsample = (Upsample(block_out, wq, aq_upsample or aq)
                         if level != 0 else None)

    def forward(self, h, skips: List[torch.Tensor], temb, mode):
        for i, blk in enumerate(self.block):
            h = blk(torch.cat([h, skips.pop()], dim=-1), temb, mode)
            if len(self.attn):
                h = self.attn[i](h, mode)
        if self.upsample is not None:
            h = self.upsample(h, mode)
        return h


class DDPMUNet(nn.Module):
    """The full pixel-space UNet.  Built on ``device`` (the card unless the
    caller passes ``"cpu"``) with N(0, 1/fan_in) weights drawn from
    ``seed``; real weights come through ``models/bridge.py``."""

    def __init__(self, cfg: DDPMConfig = DDPMConfig(),
                 qc: QuantConfig = QuantConfig(), device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.qc = cfg, qc
        wq, aq = qc.wq, qc.aq
        aq_w = qc.aq_softmax(always_zero=False)
        L = cfg.num_resolutions
        mid_ch = cfg.ch * cfg.ch_mult[-1]
        with torch.device(device):
            self.temb_dense_0 = QDense(cfg.ch, cfg.temb_ch, wq=wq.with_bits(8), aq=aq)
            self.temb_dense_1 = QDense(cfg.temb_ch, cfg.temb_ch, wq=wq, aq=aq)
            self.conv_in = QConv(cfg.in_channels, cfg.ch, (3, 3), wq=wq, aq=aq)
            self.down = nn.ModuleList(DownLevel(cfg, i, wq, aq, aq_w)
                                      for i in range(L))
            self.mid_block_1 = ResnetBlockD(mid_ch, mid_ch, cfg.temb_ch, wq, aq)
            self.mid_attn_1 = AttnBlockD(mid_ch, wq, aq, aq_w)
            self.mid_block_2 = ResnetBlockD(mid_ch, mid_ch, cfg.temb_ch, wq, aq)
            self.up = nn.ModuleList(
                UpLevel(cfg, i, wq, aq, aq_w, self._split_channels(i),
                        aq.with_bits(8) if i == L - 1 else None)
                for i in range(L))
            self.norm_out = GNorm(cfg.ch * cfg.ch_mult[0])
            self.conv_out = QConv(cfg.ch * cfg.ch_mult[0], cfg.out_ch, (3, 3),
                                  wq=wq.with_bits(8), aq=aq,
                                  disable_act_quant=True)
        self.init_weights(seed)

    def init_weights(self, seed: int) -> None:
        g = torch.Generator(device=self.conv_in.weight.device).manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (QConv, QDense)):
                lecun_normal_(m.weight, g)

    def _split_channels(self, level: int) -> Tuple[int, ...]:
        """Channels of h entering each up-block concat (the split point)."""
        cfg = self.cfg
        if not self.qc.split:
            return tuple(0 for _ in range(cfg.num_res_blocks + 1))
        block_out = cfg.ch * cfg.ch_mult[level]
        first = cfg.ch * (cfg.ch_mult[-1] if level == cfg.num_resolutions - 1
                          else cfg.ch_mult[level + 1])
        return (first,) + (block_out,) * cfg.num_res_blocks

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                mode: QuantMode = FP) -> torch.Tensor:
        # the carrier dtype follows the input (bf16 on the deployment path)
        temb = timestep_embedding(t, self.cfg.ch).to(x.dtype)
        temb = self.temb_dense_0(temb, mode)
        temb = self.temb_dense_1(swish(temb), mode)
        hs = [self.conv_in(x, mode)]
        h = hs[-1]
        for lvl in self.down:
            h, outs = lvl(h, temb, mode)
            hs.extend(outs)
        h = self.mid_block_1(h, temb, mode)
        h = self.mid_attn_1(h, mode)
        h = self.mid_block_2(h, temb, mode)
        for i in reversed(range(self.cfg.num_resolutions)):
            h = self.up[i](h, hs, temb, mode)
        return self.conv_out(swish(self.norm_out(h)), mode)
