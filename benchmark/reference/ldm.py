"""The latent-diffusion UNet of Stable Diffusion v1 (the openaimodel
``UNetModel`` with spatial transformers, ``v1-inference.yaml``) under the
W4A8 policy of EDA-DM: 8-bit weights in ``time_embed_0`` and ``out_2``,
``out_2``'s input unquantized, each output block's skip concatenation
quantized in two halves, softmax outputs at 8 bits with the zero point at
0.  Module and parameter names are the program's (``input_blocks_1_0``,
``transformer_blocks_0``, ``attn2``, ``net_0_proj``)."""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import GNorm, LayerNorm, QConv, QDense, attention, gelu_tanh, swish, timestep_embedding
from .quant import ActQ, Ctx


def head_split(a: dict, ch: int):
    if a["num_head_channels"] == -1:
        heads, dim = a["num_heads"], ch // a["num_heads"]
    else:
        heads, dim = ch // a["num_head_channels"], a["num_head_channels"]
    if a["legacy"]:
        dim = ch // heads if a["use_spatial_transformer"] else a["num_head_channels"]
    return heads, dim


def layout(a: dict):
    """UNetModel.__init__'s channel bookkeeping: (name, kind, in, out, heads,
    dim_head, split) for the input, middle and output blocks."""
    if not a["use_spatial_transformer"] or a["use_scale_shift_norm"] or a["resblock_updown"]:
        raise NotImplementedError("the reference holds SD v1's UNet family")
    mc = a["model_channels"]
    ins = [("input_blocks_0_0", "conv", a["in_channels"], mc, 0, 0, 0)]
    chans, ch, ds, idx = [mc], mc, 1, 1
    for level, mult in enumerate(a["channel_mult"]):
        for _ in range(a["num_res_blocks"]):
            ins.append((f"input_blocks_{idx}_0", "res", ch, mult * mc, 0, 0, 0))
            ch = mult * mc
            if ds in a["attention_resolutions"]:
                ins.append((f"input_blocks_{idx}_1", "tx", ch, ch, *head_split(a, ch), 0))
            chans.append(ch)
            idx += 1
        if level != len(a["channel_mult"]) - 1:
            ins.append((f"input_blocks_{idx}_0", "down", ch, ch, 0, 0, 0))
            chans.append(ch)
            idx += 1
            ds *= 2
    mid = [("middle_block_0", "res", ch, ch, 0, 0, 0),
           ("middle_block_1", "tx", ch, ch, *head_split(a, ch), 0),
           ("middle_block_2", "res", ch, ch, 0, 0, 0)]
    outs, o = [], 0
    for level, mult in list(enumerate(a["channel_mult"]))[::-1]:
        for i in range(a["num_res_blocks"] + 1):
            skip = chans.pop()
            outs.append((f"output_blocks_{o}_0", "res", ch + skip, mc * mult, 0, 0, ch))
            ch, j = mc * mult, 1
            if ds in a["attention_resolutions"]:
                outs.append((f"output_blocks_{o}_{j}", "tx", ch, ch, *head_split(a, ch), 0))
                j += 1
            if level and i == a["num_res_blocks"]:
                outs.append((f"output_blocks_{o}_{j}", "up", ch, ch, 0, 0, 0))
                ds //= 2
            o += 1
    return ins, mid, outs


class ResBlockL(nn.Module):
    def __init__(self, cin, cout, emb, split=0):
        super().__init__()
        self.in_layers_0 = GNorm(cin)
        self.in_layers_2 = QConv(cin, cout)
        self.emb_layers_1 = QDense(emb, cout)
        self.out_layers_0 = GNorm(cout)
        self.out_layers_3 = QConv(cout, cout)
        self.skip_connection = (QConv(cin, cout, (1, 1), padding="VALID", split=split)
                                if cin != cout else None)

    def forward(self, x, emb, context, ctx):
        h = self.in_layers_2(swish(self.in_layers_0(x, ctx), ctx), ctx)
        h = ctx.c(h + self.emb_layers_1(swish(emb, ctx), ctx)[:, None, None, :])
        h = self.out_layers_3(swish(self.out_layers_0(h, ctx), ctx), ctx)
        if self.skip_connection is not None:
            x = self.skip_connection(x, ctx)
        return ctx.c(x + h)


class CrossAttentionL(nn.Module):
    def __init__(self, qdim, cdim, heads, dim_head):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = QDense(qdim, inner, use_bias=False)
        self.to_k = QDense(cdim, inner, use_bias=False)
        self.to_v = QDense(cdim, inner, use_bias=False)
        self.quantizers = nn.ModuleList([ActQ(), ActQ(), ActQ(always_zero=True), ActQ()])
        self.to_out_0 = QDense(inner, qdim)

    def forward(self, x, context, ctx):
        c = x if context is None else context
        b, n, m, h, d = x.shape[0], x.shape[1], c.shape[1], self.heads, self.dim_head
        q = self.to_q(x, ctx).reshape(b, n, h, d)
        k = self.to_k(c, ctx).reshape(b, m, h, d)
        v = self.to_v(c, ctx).reshape(b, m, h, d)
        a = attention(q, k, v, d ** -0.5, self.quantizers, ctx)
        return self.to_out_0(a.reshape(b, n, h * d), ctx)


class FeedForwardL(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        self.net_0_proj = QDense(dim, 2 * dim * mult)
        self.net_2 = QDense(dim * mult, dim)

    def forward(self, x, ctx):
        a, gate = self.net_0_proj(x, ctx).chunk(2, dim=-1)
        return self.net_2(ctx.c(a * gelu_tanh(gate, ctx)), ctx)


class BasicTransformerBlockL(nn.Module):
    def __init__(self, dim, heads, dim_head, cdim):
        super().__init__()
        self.attn1 = CrossAttentionL(dim, dim, heads, dim_head)
        self.norm1 = LayerNorm(dim)
        self.attn2 = CrossAttentionL(dim, cdim, heads, dim_head)
        self.norm2 = LayerNorm(dim)
        self.ff = FeedForwardL(dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, x, context, ctx):
        x = ctx.c(self.attn1(self.norm1(x, ctx), None, ctx) + x)
        x = ctx.c(self.attn2(self.norm2(x, ctx), context, ctx) + x)
        return ctx.c(self.ff(self.norm3(x, ctx), ctx) + x)


class SpatialTransformerL(nn.Module):
    def __init__(self, ch, heads, dim_head, depth, cdim):
        super().__init__()
        self.inner, self.depth = heads * dim_head, depth
        self.norm = GNorm(ch)
        self.proj_in = QConv(ch, self.inner, (1, 1), padding="VALID")
        for d in range(depth):
            setattr(self, f"transformer_blocks_{d}",
                    BasicTransformerBlockL(self.inner, heads, dim_head, cdim))
        self.proj_out = QConv(self.inner, ch, (1, 1), padding="VALID")

    def forward(self, x, emb, context, ctx):
        b, hh, ww, _ = x.shape
        h = self.proj_in(self.norm(x, ctx), ctx).reshape(b, hh * ww, self.inner)
        for d in range(self.depth):
            h = getattr(self, f"transformer_blocks_{d}")(h, context, ctx)
        return ctx.c(x + self.proj_out(h.reshape(b, hh, ww, self.inner), ctx))


class DownsampleL(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.op = QConv(ch, ch, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))

    def forward(self, x, emb, context, ctx):
        return self.op(x, ctx)


class UpsampleL(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = QConv(ch, ch)

    def forward(self, x, emb, context, ctx):
        return self.conv(x.repeat_interleave(2, 1).repeat_interleave(2, 2), ctx)


class LDMUNet(nn.Module):
    """``arch``: the configuration's ``unet`` group (the program's
    ``LDMUNetConfig`` fields)."""

    def __init__(self, arch: dict):
        super().__init__()
        a = self.arch = dict(arch)
        mc, ted = a["model_channels"], 4 * a["model_channels"]
        self.time_embed_0 = QDense(mc, ted, w_bits=8)
        self.time_embed_2 = QDense(ted, ted)
        ins, mid, outs = layout(a)
        self.convs = set()
        for part in (ins, mid, outs):
            for name, kind, cin, cout, heads, dim, split in part:
                if kind == "conv":
                    self.convs.add(name)
                setattr(self, name, {
                    "conv": lambda: QConv(cin, mc),
                    "res": lambda: ResBlockL(cin, cout, ted, split),
                    "tx": lambda: SpatialTransformerL(cout, heads, dim, a["transformer_depth"],
                                                      a["context_dim"]),
                    "down": lambda: DownsampleL(cout),
                    "up": lambda: UpsampleL(cout)}[kind]())
        group = lambda items: [[n for n, *_ in items if n.rsplit("_", 1)[0] == g]
                               for g in dict.fromkeys(n.rsplit("_", 1)[0] for n, *_ in items)]
        self.inputs, self.outputs = group(ins), group(outs)
        self.middle = [n for n, *_ in mid]
        self.out_0 = GNorm(mc)
        self.out_2 = QConv(mc, a["out_channels"], w_bits=8, disable_act_quant=True)

    def forward(self, x, t, context, ctx: Ctx):
        emb = ctx.c(timestep_embedding(t, self.arch["model_channels"]))
        emb = self.time_embed_2(swish(self.time_embed_0(emb, ctx), ctx), ctx)
        def run(names, h):
            for n in names:
                h = (getattr(self, n)(h, ctx) if n in self.convs
                     else getattr(self, n)(h, emb, context, ctx))
            return h
        hs, h = [], x.float()
        for names in self.inputs:
            h = run(names, h)
            hs.append(h)
        h = run(self.middle, h)
        for names in self.outputs:
            h = run(names, torch.cat([h, hs.pop()], -1))
        return self.out_2(swish(self.out_0(h, ctx), ctx), ctx)


def forward_blocks(model: LDMUNet, x, t, context, ctx: Ctx, block: int) -> torch.Tensor:
    """The forward over blocks of ``block`` rows (each row is independent)."""
    return torch.cat([model(xb, tb, cb, ctx) for xb, tb, cb in
                      zip(x.split(block), t.split(block), context.split(block))])
