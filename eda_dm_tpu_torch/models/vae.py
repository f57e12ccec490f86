"""First-stage VAE (port of ``eda_dm_tpu/models/vae.py``): the encoder
(``encode``) and the decoder (``decode``).

The first stage is never quantized; it runs in float32.  The public
functions keep the JAX package's NHWC layout (latents in, images out);
inside, the decoder runs NCHW, PyTorch's convolution layout.  Module names
are the flax names (``decoder.up_0_block_1.conv1``, ``post_quant_conv``,
``codebook``), so ``models/bridge.py`` maps the trees one to one.

On rows of a sharded height (``parallel/spatial.py``; NCHW, so H is dim
2) the convs exchange their halo rows, the GroupNorm's two sums are
reduced over the ranks in one collective, the attention blocks run on the
gathered height and the decoder's 2× upsample is local.

Two details follow flax rather than PyTorch's habits: the GroupNorm is
flax ``nn.GroupNorm`` (variance E[x²] − E[x]², clipped at 0, and the scale
folded into the reciprocal deviation before the product), and the VQ
lookup computes ``|z|² − 2z·E + |E|²`` in that order, in row chunks, as
``FirstStage.quantize`` does.  Call it with TF32 off on the card
(``ops.int8_einsum.tf32_off``): the reference is full float32.

``vae_state_dict_to_params`` converts a reference AutoencoderKL / VQModel
state dict (encoder included) to the JAX package's tree;
``models/bridge.py::first_stage_from_jax`` reads it whole, or its decode
part alone.  ``LatentDiffusion`` holds a decode-only first stage, as the
JAX package's reads only the decode part of a checkpoint.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..nn.layers import lecun_normal_
from ..parallel import spatial
from .convert import as_numpy, insert

VQ_CHUNK = 8192          # rows of the (pixels, n_embed) distance matrix at once


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """ddconfig of the model yamls (JAX ``VAEConfig``)."""
    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    in_channels: int = 3
    resolution: int = 256
    z_channels: int = 3
    double_z: bool = False
    embed_dim: int = 3
    n_embed: Optional[int] = None     # set → VQ model, else KL


class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW: SAME padding at stride 1; at stride 2
    VALID, the input padded by one row and column at its end first (the
    encoder's downsample, ``jnp.pad(h, ((0, 0), (0, 1), (0, 1), (0, 0)))``)."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 3, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def _pads(self, h: int, w: int):
        if self.stride == 1:
            p = self.weight.shape[-1] // 2
            return (p, p), (p, p)
        return (0, 1), (0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        site = spatial.conv_site(x, (k, k), (self.stride,) * 2, self._pads, dim=2)
        x = site.rows(x)
        (top, bottom), (left, right) = site.pads
        if self.stride == 1 and top == bottom == left == right:
            return F.conv2d(x, self.weight, self.bias, padding=top)
        return F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight, self.bias,
                        stride=self.stride)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=32, epsilon=1e-6)`` on NCHW."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = self.num_groups
        xg = x.reshape(n, g, c // g, -1)
        if spatial.is_sharded(x, dim=2):
            sums = spatial.all_reduce_stats(torch.cat(
                [xg.sum(dim=(2, 3), keepdim=True), (xg * xg).sum(dim=(2, 3), keepdim=True)]))
            mean, mean2 = (sums / (spatial.count(x, (2, 3), dim=2) * (c // g))).chunk(2)
        else:
            mean = xg.mean(dim=(2, 3), keepdim=True)
            mean2 = (xg * xg).mean(dim=(2, 3), keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.reshape(1, g, c // g, 1)
        y = (xg - mean) * mul + self.bias.reshape(1, g, c // g, 1)
        return y.reshape(x.shape)


class VAEResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm(in_ch)
        self.conv1 = Conv(in_ch, out_ch)
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = Conv(out_ch, out_ch)
        self.nin_shortcut = Conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head spatial self-attention, float32 products."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = GroupNorm(ch)
        self.q, self.k, self.v = Conv(ch, ch, 1), Conv(ch, ch, 1), Conv(ch, ch, 1)
        self.proj_out = Conv(ch, ch, 1)

    def forward(self, x):
        return spatial.run_whole(self._forward, x, dim=2)

    def _forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q = self.q(h).reshape(b, c, hh * ww)
        k = self.k(h).reshape(b, c, hh * ww)
        v = self.v(h).reshape(b, c, hh * ww)
        w = torch.bmm(q.transpose(1, 2), k) * (c ** -0.5)
        w = torch.softmax(w, dim=-1)
        h = torch.bmm(v, w.transpose(1, 2)).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


class _Path(nn.Module):
    """A module whose ``order`` lists, in call order, the flax-named
    submodules of its down or up path."""

    def __init__(self):
        super().__init__()
        self.order = []

    def _add(self, name, module):
        setattr(self, name, module)
        self.order.append(name)


class VAEEncoder(_Path):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        curr_res = cfg.resolution
        self.conv_in = Conv(cfg.in_channels, cfg.ch)
        ch = cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            out_ch = cfg.ch * mult
            for j in range(cfg.num_res_blocks):
                self._add(f"down_{i}_block_{j}", VAEResnetBlock(ch, out_ch))
                ch = out_ch
                if curr_res in cfg.attn_resolutions:
                    self._add(f"down_{i}_attn_{j}", VAEAttnBlock(ch))
            if i != len(cfg.ch_mult) - 1:
                self._add(f"down_{i}_downsample", Conv(ch, ch, stride=2))
                curr_res //= 2
        self.mid_block_1 = VAEResnetBlock(ch, ch)
        self.mid_attn_1 = VAEAttnBlock(ch)
        self.mid_block_2 = VAEResnetBlock(ch, ch)
        self.norm_out = GroupNorm(ch)
        self.conv_out = Conv(ch, 2 * cfg.z_channels if cfg.double_z else cfg.z_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for name in self.order:
            h = getattr(self, name)(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class VAEDecoder(_Path):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        n_lv = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        curr_res = cfg.resolution // 2 ** (n_lv - 1)
        self.conv_in = Conv(cfg.z_channels, block_in)
        self.mid_block_1 = VAEResnetBlock(block_in, block_in)
        self.mid_attn_1 = VAEAttnBlock(block_in)
        self.mid_block_2 = VAEResnetBlock(block_in, block_in)
        ch = block_in
        for i in reversed(range(n_lv)):
            out_ch = cfg.ch * cfg.ch_mult[i]
            for j in range(cfg.num_res_blocks + 1):
                self._add(f"up_{i}_block_{j}", VAEResnetBlock(ch, out_ch))
                ch = out_ch
                if curr_res in cfg.attn_resolutions:
                    self._add(f"up_{i}_attn_{j}", VAEAttnBlock(ch))
            if i != 0:
                self._add(f"up_{i}_upsample", Conv(ch, ch))
                curr_res *= 2
        self.norm_out = GroupNorm(ch)
        self.conv_out = Conv(ch, cfg.out_ch)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for name in self.order:
            if name.endswith("_upsample"):
                h = spatial.upsample(
                    lambda t: F.interpolate(t, scale_factor=2, mode="nearest"), h, dim=2)
            h = getattr(self, name)(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class FirstStage(nn.Module):
    """VQModelInterface / AutoencoderKL encode and decode surface
    (``encoder=False``: decode only).  Built on ``device`` (the card unless
    the caller passes ``"cpu"``) with N(0, 1/fan_in) conv weights and a
    U[0, 1) codebook drawn from ``seed`` (the encoder's drawn after the
    decode part's, which are the same with or without it); real weights
    come through ``models/bridge.py``."""

    def __init__(self, cfg: VAEConfig, device=None, seed: int = 0,
                 encoder: bool = True):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        with torch.device(device):
            self.decoder = VAEDecoder(cfg)
            self.post_quant_conv = Conv(cfg.embed_dim, cfg.z_channels, 1)
            self.codebook = (nn.Parameter(torch.empty(cfg.n_embed, cfg.embed_dim))
                             if cfg.n_embed is not None else None)
            self.encoder = self.quant_conv = None
            if encoder:
                two = 2 if cfg.double_z else 1
                self.encoder = VAEEncoder(cfg)
                self.quant_conv = Conv(two * cfg.z_channels, two * cfg.embed_dim, 1)
        g = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for part in (self.decoder, self.post_quant_conv, self.codebook,
                         self.encoder, self.quant_conv):
                if isinstance(part, nn.Parameter):
                    part.uniform_(0.0, 1.0, generator=g)
                elif part is not None:
                    for m in part.modules():
                        if isinstance(m, Conv):
                            lecun_normal_(m.weight, g)

    @torch.no_grad()
    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """Nearest-codebook lookup of NHWC latents, VQ_CHUNK rows at a time
        (the whole distance matrix is 6.7 GB at the bedroom batch of 50)."""
        flat = z.reshape(-1, self.cfg.embed_dim)
        cb2 = torch.sum(self.codebook ** 2, dim=1)[None, :]
        idx = torch.cat([
            torch.argmin(torch.sum(fc ** 2, dim=1, keepdim=True)
                         - (2.0 * fc) @ self.codebook.T + cb2, dim=1)
            for fc in flat.split(VQ_CHUNK)])
        zq = self.codebook[idx].reshape(z.shape)
        return z + (zq - z)        # the straight-through value, as JAX forms it

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images → NHWC latents: VQ the pre-quantization latents, KL
        the concatenated (mean, logvar)."""
        if self.encoder is None:
            raise RuntimeError("a decode-only first stage has no encoder")
        h = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        return h.permute(0, 2, 3, 1)

    @torch.no_grad()
    def decode(self, z: torch.Tensor, force_not_quantize: bool = False):
        """NHWC latents → NHWC images (float32, roughly in [-1, 1])."""
        if self.codebook is not None and not force_not_quantize:
            z = self.quantize(z)
        h = self.post_quant_conv(z.permute(0, 3, 1, 2))
        return self.decoder(h).permute(0, 2, 3, 1)


# --------------------------------------------------------------------------
# converter
# --------------------------------------------------------------------------

_VAE_RULES = [
    (re.compile(r"^(encoder|decoder)\.mid\.(\w+)\."),
     lambda m: f"{m.group(1)}.mid_{m.group(2)}."),
    (re.compile(r"^(encoder|decoder)\.(down|up)\.(\d+)\.(block|attn)\.(\d+)\."),
     lambda m: f"{m.group(1)}.{m.group(2)}_{m.group(3)}_{m.group(4)}_{m.group(5)}."),
    (re.compile(r"^(encoder|decoder)\.(down|up)\.(\d+)\.(downsample|upsample)\.conv\."),
     lambda m: f"{m.group(1)}.{m.group(2)}_{m.group(3)}_{m.group(4)}."),
    (re.compile(r"^quantize\.embedding\.weight$"), lambda m: "codebook"),
]


def vae_state_dict_to_params(state_dict: Mapping) -> Dict:
    """A reference AutoencoderKL / VQModel state dict → the JAX package's
    ``FirstStage`` params tree (numpy); ``loss.*`` entries are dropped."""
    params: Dict = {}
    for key, val in state_dict.items():
        if key.startswith("loss."):
            continue
        arr = as_numpy(val)
        tkey = key
        for pat, repl in _VAE_RULES:
            tkey = pat.sub(repl, tkey)
        if tkey == "codebook":
            insert(params, ["codebook"], arr)
            continue
        parts = tkey.split(".")
        leaf = parts[-1]
        if leaf == "weight":
            if arr.ndim == 4:
                leaf, arr = "kernel", np.transpose(arr, (2, 3, 1, 0))
            else:
                leaf = "scale"
        insert(params, parts[:-1] + [leaf], arr)
    return params
