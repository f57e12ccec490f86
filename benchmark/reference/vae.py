"""The KL-f8 first stage's decoder (``AutoencoderKL``, ``ddconfig`` of the
model yamls) in float32, NCHW inside, NHWC latents in and images out.
Module and parameter names are the program's (``decoder.up_0_block_1``,
``post_quant_conv``)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv(nn.Module):
    def __init__(self, cin, cout, k=3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, padding=self.weight.shape[-1] // 2)


class GroupNorm(nn.Module):
    def __init__(self, ch, groups=32, eps=1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return F.group_norm(x, self.groups, self.scale, self.bias, self.eps)


class Block(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1, self.conv1 = GroupNorm(cin), Conv(cin, cout)
        self.norm2, self.conv2 = GroupNorm(cout), Conv(cout, cout)
        self.nin_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class Attn(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.norm = GroupNorm(ch)
        self.q, self.k, self.v, self.proj_out = (Conv(ch, ch, 1) for _ in range(4))

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q, k, v = (m(h).reshape(b, c, hh * ww) for m in (self.q, self.k, self.v))
        w = torch.softmax(torch.bmm(q.transpose(1, 2), k) * c ** -0.5, dim=-1)
        return x + self.proj_out(torch.bmm(v, w.transpose(1, 2)).reshape(b, c, hh, ww))


class Decoder(nn.Module):
    def __init__(self, a: dict):
        super().__init__()
        mult, nb = a["ch_mult"], a["num_res_blocks"]
        ch = a["ch"] * mult[-1]
        res = a["resolution"] // 2 ** (len(mult) - 1)
        self.conv_in = Conv(a["z_channels"], ch)
        self.mid_block_1, self.mid_attn_1, self.mid_block_2 = Block(ch, ch), Attn(ch), Block(ch, ch)
        self.order = []
        for i in reversed(range(len(mult))):
            cout = a["ch"] * mult[i]
            for j in range(nb + 1):
                self._add(f"up_{i}_block_{j}", Block(ch, cout))
                ch = cout
                if res in a["attn_resolutions"]:
                    self._add(f"up_{i}_attn_{j}", Attn(ch))
            if i != 0:
                self._add(f"up_{i}_upsample", Conv(ch, ch))
                res *= 2
        self.norm_out = GroupNorm(ch)
        self.conv_out = Conv(ch, a["out_ch"])

    def _add(self, name, m):
        setattr(self, name, m)
        self.order.append(name)

    def forward(self, z):
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(self.conv_in(z))))
        for name in self.order:
            if name.endswith("_upsample"):
                h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = getattr(self, name)(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class FirstStage(nn.Module):
    """``decode(z)``: NHWC latents (already divided by the scale factor) →
    NHWC images."""

    def __init__(self, a: dict):
        super().__init__()
        if a.get("n_embed") is not None:
            raise NotImplementedError("the reference holds the KL first stage")
        self.decoder = Decoder(a)
        self.post_quant_conv = Conv(a["embed_dim"], a["z_channels"], 1)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
