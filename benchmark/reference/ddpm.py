"""The pixel-space DDPM UNet (Ho et al. 2020; the CIFAR-10 model of
``configs/cifar10.yml``) under the W4A8 policy of EDA-DM: 8-bit weights in
the first dense and the last conv, the last conv's input unquantized, the
concatenated skip inputs of the up path quantized in two halves.  Module
and parameter names are the program's."""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import GNorm, QConv, QDense, attention, swish, timestep_embedding
from .quant import ActQ, Ctx


class ResnetBlockD(nn.Module):
    def __init__(self, in_ch, out_ch, temb_ch, split=0):
        super().__init__()
        self.GroupNorm_0 = GNorm(in_ch)
        self.conv1 = QConv(in_ch, out_ch)
        self.temb_proj = QDense(temb_ch, out_ch)
        self.GroupNorm_1 = GNorm(out_ch)
        self.conv2 = QConv(out_ch, out_ch)
        self.nin_shortcut = (QConv(in_ch, out_ch, (1, 1), padding="VALID", split=split)
                             if in_ch != out_ch else None)

    def forward(self, x, temb, ctx):
        h = self.conv1(swish(self.GroupNorm_0(x, ctx), ctx), ctx)
        h = ctx.c(h + self.temb_proj(swish(temb, ctx), ctx)[:, None, None, :])
        h = self.conv2(swish(self.GroupNorm_1(h, ctx), ctx), ctx)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x, ctx)
        return ctx.c(x + h)


class AttnBlockD(nn.Module):
    """Single-head self-attention over the H·W pixels; the softmax output's
    quantizer keeps a free zero point."""

    def __init__(self, ch):
        super().__init__()
        self.GroupNorm_0 = GNorm(ch)
        self.q = QConv(ch, ch, (1, 1), padding="VALID")
        self.k = QConv(ch, ch, (1, 1), padding="VALID")
        self.v = QConv(ch, ch, (1, 1), padding="VALID")
        self.quantizers = nn.ModuleList([ActQ(), ActQ(), ActQ(), ActQ()])
        self.proj_out = QConv(ch, ch, (1, 1), padding="VALID")

    def forward(self, x, ctx):
        n, hh, ww, c = x.shape
        h = self.GroupNorm_0(x, ctx)
        q, k, v = (m(h, ctx).reshape(n, hh * ww, 1, c) for m in (self.q, self.k, self.v))
        a = attention(q, k, v, c ** -0.5, self.quantizers, ctx).reshape(n, hh, ww, c)
        return ctx.c(x + self.proj_out(a, ctx))


class Downsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = QConv(ch, ch, (3, 3), strides=(2, 2), padding=((0, 1), (0, 1)))

    def forward(self, x, ctx):
        return self.conv(x, ctx)


class Upsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = QConv(ch, ch)

    def forward(self, x, ctx):
        return self.conv(x.repeat_interleave(2, 1).repeat_interleave(2, 2), ctx)


class DownLevel(nn.Module):
    def __init__(self, a, level):
        super().__init__()
        mult = (1,) + tuple(a["ch_mult"])
        cin, cout = a["ch"] * mult[level], a["ch"] * a["ch_mult"][level]
        attn = a["resolution"] // 2 ** level in a["attn_resolutions"]
        self.block = nn.ModuleList(ResnetBlockD(cin if i == 0 else cout, cout, 4 * a["ch"])
                                   for i in range(a["num_res_blocks"]))
        self.attn = nn.ModuleList(AttnBlockD(cout) for _ in range(a["num_res_blocks"] if attn else 0))
        self.downsample = Downsample(cout) if level != len(a["ch_mult"]) - 1 else None


class UpLevel(nn.Module):
    def __init__(self, a, level):
        super().__init__()
        ch, cm, nb = a["ch"], a["ch_mult"], a["num_res_blocks"]
        mult = (1,) + tuple(cm)
        cout = ch * cm[level]
        first = ch * (cm[-1] if level == len(cm) - 1 else cm[level + 1])
        attn = a["resolution"] // 2 ** level in a["attn_resolutions"]
        blocks = []
        for j in range(nb + 1):
            skip = ch * (mult[level] if j == nb else cm[level])
            h_ch = first if j == 0 else cout
            blocks.append(ResnetBlockD(h_ch + skip, cout, 4 * ch, split=h_ch))
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(AttnBlockD(cout) for _ in range(nb + 1 if attn else 0))
        self.upsample = Upsample(cout) if level != 0 else None


class DDPMUNet(nn.Module):
    """``arch``: the configuration's widths (``in_channels``, ``out_ch``,
    ``ch``, ``ch_mult``, ``num_res_blocks``, ``attn_resolutions``,
    ``resolution``)."""

    def __init__(self, arch: dict):
        super().__init__()
        a = self.arch = dict(arch)
        ch, levels = a["ch"], len(a["ch_mult"])
        mid = ch * a["ch_mult"][-1]
        self.temb_dense_0 = QDense(ch, 4 * ch, w_bits=8)
        self.temb_dense_1 = QDense(4 * ch, 4 * ch)
        self.conv_in = QConv(a["in_channels"], ch)
        self.down = nn.ModuleList(DownLevel(a, i) for i in range(levels))
        self.mid_block_1 = ResnetBlockD(mid, mid, 4 * ch)
        self.mid_attn_1 = AttnBlockD(mid)
        self.mid_block_2 = ResnetBlockD(mid, mid, 4 * ch)
        self.up = nn.ModuleList(UpLevel(a, i) for i in range(levels))
        self.norm_out = GNorm(ch * a["ch_mult"][0])
        self.conv_out = QConv(ch * a["ch_mult"][0], a["out_ch"], w_bits=8,
                              disable_act_quant=True)

    def forward(self, x, t, ctx: Ctx):
        temb = ctx.c(timestep_embedding(t, self.arch["ch"]))
        temb = self.temb_dense_0(temb, ctx)
        temb = self.temb_dense_1(swish(temb, ctx), ctx)
        hs = [self.conv_in(x.float(), ctx)]
        h = hs[-1]
        for lvl in self.down:
            for i, blk in enumerate(lvl.block):
                h = blk(h, temb, ctx)
                if len(lvl.attn):
                    h = lvl.attn[i](h, ctx)
                hs.append(h)
            if lvl.downsample is not None:
                h = lvl.downsample(h, ctx)
                hs.append(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h, temb, ctx), ctx), temb, ctx)
        for lvl in reversed(self.up):
            for i, blk in enumerate(lvl.block):
                h = blk(torch.cat([h, hs.pop()], -1), temb, ctx)
                if len(lvl.attn):
                    h = lvl.attn[i](h, ctx)
            if lvl.upsample is not None:
                h = lvl.upsample(h, ctx)
        return self.conv_out(swish(self.norm_out(h, ctx), ctx), ctx)


def forward_blocks(model: DDPMUNet, x, t, ctx: Ctx, block: int) -> torch.Tensor:
    """The forward over blocks of ``block`` rows (each row is independent)."""
    return torch.cat([model(xb, tb, ctx) for xb, tb in zip(x.split(block), t.split(block))])

