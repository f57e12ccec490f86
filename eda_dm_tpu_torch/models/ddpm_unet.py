"""DDPM UNet (CIFAR/LSUN pixel space), serving part (port of
``eda_dm_tpu/models/ddpm_unet.py``).

Module paths follow the JAX variable paths mechanically: a flax list entry
``down_0/block_1/conv1`` is ``down[0].block[1].conv1`` here, every other
name is kept (``mid_attn_1.act_quantizer_q``, ``GroupNorm_0``).  Layout is
NHWC; dropout is omitted (inference only).

The first/last policy: the first weight quantizer (``temb_dense_0``) and
the last (``conv_out``) are 8-bit, ``conv_out``'s act quant is disabled and
the top level's upsample conv has an 8-bit act quantizer.

:func:`ddpm_recon_plan` and :func:`ddpm_layer_plan` list the
reconstruction targets as the JAX package does (names, paths, kinds,
inner taps, order).  A block's ``block_in`` / ``block_out`` and a layer's
``in`` / ``out`` are its forward's first argument and its output, read by
forward hooks (``calib/recon.py``); the timestep embedding the blocks take
is ``temb_dense_1``'s output (``DDPMUNet.temb_module``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from ..calib.recon import ReconTarget, conv_spec, dense_spec, module_spec
from ..device import resolve_device
from ..nn.layers import (ActQuantizer, GNorm, QConv, QDense, lecun_normal_,
                         norm_act, norm_conv, swish, timestep_embedding)
from ..ops.int8_attention import int8_fused_attention
from ..ops.int8_einsum import (int8_act_einsum, int8_code_einsum,
                               quantize_act_int8)
from ..ops.serving_policy import (attention_impl, int8_attention_serving,
                                  use_fused_softmax)
from ..ops.softmax_codes import softmax_codes
from ..parallel import spatial
from ..parallel.rows import global_rows
from ..quant.config import FP, QuantConfig, QuantizerSpec, QuantMode
from ..utils.run import span


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
        h = norm_conv(self.GroupNorm_0, self.conv1, x, mode)
        h = h + self.temb_proj(swish(temb), mode)[:, None, None, :]
        h = norm_conv(self.GroupNorm_1, self.conv2, h, mode)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x, mode)
        return x + h


class AttnBlockD(nn.Module):
    """DDPM self-attention block.  q and k are quantized unscaled after
    their 1×1 convs; the softmax output is quantized at sm_abit and v at
    act_bit before the second product.  On rows of a sharded height the
    block runs on the gathered height (``spatial.run_whole``), as one
    process runs it."""

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
        return spatial.run_whole(self._forward, x, mode)

    def _forward(self, x, mode: QuantMode):
        n, hh, ww, c = x.shape
        h = norm_act(self.GroupNorm_0, x, mode)
        q = self.q(h, mode).reshape(n, hh * ww, c)
        k = self.k(h, mode).reshape(n, hh * ww, c)
        v = self.v(h, mode).reshape(n, hh * ww, c)
        L, Lw = self.aq.n_levels, self.aq_w.n_levels
        if int8_attention_serving(mode) and L <= 256 and Lw <= 256:
            dq, zq = self.act_quantizer_q(q, mode, params_only=True)
            dk, zk = self.act_quantizer_k(k, mode, params_only=True)
            dv, zv = self.act_quantizer_v(v, mode, params_only=True)
            dw, zw = self.act_quantizer_w(None, mode, params_only=True)
            # the global batch's branch, as JAX's traced shapes choose it
            if attention_impl(global_rows(n), 1, hh * ww, hh * ww, c) == "fused":
                # the whole attention in one kernel (K4): the (n, hw, hw)
                # logits never reach device memory
                Qc, cq = quantize_act_int8(q, dq, zq, L)
                Kc, ck = quantize_act_int8(k, dk, zk, L)
                V, cv = quantize_act_int8(v, dv, zv, L)
                h = int8_fused_attention(Qc, cq, dq, Kc, ck, dk, V, cv, dv,
                                         c ** -0.5, dw, zw, Lw)
            else:
                # both products int8×int8→int32 (K2) with the exact
                # recentering epilogue; softmax→codes is K3
                w = int8_act_einsum("nic,njc->nij", q, (dq, zq, L),
                                    k, (dk, zk, L)) * (c ** -0.5)
                W, cw = softmax_codes(w, dw, zw, Lw)
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
        x = spatial.upsample(
            lambda t: t.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2), x)
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

    temb_module = "temb_dense_1"       # its output is the blocks' temb

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
            # the block groups' span names (utils/run.py::span)
            self.down_spans = tuple(f"edm.unet.down.{i}" for i in range(L))
            self.up_spans = tuple(f"edm.unet.up.{i}" for i in range(L))
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
        with span("edm.unet.forward"):
            # the carrier dtype follows the input (bf16 on the deployment path)
            temb = timestep_embedding(t, self.cfg.ch).to(x.dtype)
            temb = self.temb_dense_0(temb, mode)
            temb = self.temb_dense_1(swish(temb), mode)
            hs = [self.conv_in(x, mode)]
            h = hs[-1]
            for lvl, name in zip(self.down, self.down_spans):
                with span(name):
                    h, outs = lvl(h, temb, mode)
                hs.extend(outs)
            with span("edm.unet.mid"):
                h = self.mid_block_1(h, temb, mode)
                h = self.mid_attn_1(h, mode)
                h = self.mid_block_2(h, temb, mode)
            for i in reversed(range(self.cfg.num_resolutions)):
                with span(self.up_spans[i]):
                    h = self.up[i](h, hs, temb, mode)
            return self.conv_out(norm_act(self.norm_out, h, mode, act=True), mode)


# --------------------------------------------------------------------------
# reconstruction plans
# --------------------------------------------------------------------------

def ddpm_recon_plan(cfg: DDPMConfig, qc: QuantConfig):
    """Ordered reconstruction targets: the temb denses and conv_in as
    layers, the down levels (blocks and attentions interleaved in forward
    order, each downsample conv a layer), mid, the up levels in reversed
    index order, conv_out last.  The order matters: each target's
    quantized-input capture runs under the state earlier targets left."""
    wq, aq = qc.wq, qc.aq
    aq_w = qc.aq_softmax(always_zero=False)
    ch, temb_ch = cfg.ch, cfg.temb_ch
    in_ch_mult = (1,) + tuple(cfg.ch_mult)
    res_taps = lambda in_ch, out_ch: tuple(
        (t,) for t in (["conv1", "temb_proj", "conv2"] +
                       (["nin_shortcut"] if in_ch != out_ch else [])))
    attn_taps = (("q",), ("k",), ("v",), ("proj_out",))

    plan = [
        ReconTarget("temb_dense_0", ("temb_dense_0",),
                    dense_spec(temb_ch, wq.with_bits(8), aq), "layer"),
        ReconTarget("temb_dense_1", ("temb_dense_1",), dense_spec(temb_ch, wq, aq),
                    "layer"),
        ReconTarget("conv_in", ("conv_in",), conv_spec(ch, (3, 3), wq, aq), "layer"),
    ]

    def resblock(path, name, in_ch, out_ch, split=0):
        return ReconTarget(name, path,
                           module_spec("ResnetBlockD", out_ch=out_ch,
                                       temb_ch=temb_ch, wq=wq, aq=aq,
                                       split=split, conv_shortcut=False),
                           "block", has_temb=True,
                           inner_taps=res_taps(in_ch, out_ch))

    def attnblock(path, name):
        return ReconTarget(name, path,
                           module_spec("AttnBlockD", wq=wq, aq=aq, aq_w=aq_w),
                           "block", inner_taps=attn_taps)

    for i in range(cfg.num_resolutions):
        has_attn = cfg.resolution // (2 ** i) in cfg.attn_resolutions
        block_in, block_out = ch * in_ch_mult[i], ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks):
            plan.append(resblock((f"down_{i}", f"block_{j}"),
                                 f"down_{i}.block_{j}", block_in, block_out))
            block_in = block_out
            if has_attn:
                plan.append(attnblock((f"down_{i}", f"attn_{j}"),
                                      f"down_{i}.attn_{j}"))
        if i != cfg.num_resolutions - 1:
            plan.append(ReconTarget(
                f"down_{i}.downsample.conv", (f"down_{i}", "downsample", "conv"),
                conv_spec(block_out, (3, 3), wq, aq, strides=(2, 2),
                      padding=((0, 1), (0, 1))), "layer"))

    mid_ch = ch * cfg.ch_mult[-1]
    plan.append(resblock(("mid_block_1",), "mid_block_1", mid_ch, mid_ch))
    plan.append(attnblock(("mid_attn_1",), "mid_attn_1"))
    plan.append(resblock(("mid_block_2",), "mid_block_2", mid_ch, mid_ch))

    for i in reversed(range(cfg.num_resolutions)):
        has_attn = cfg.resolution // (2 ** i) in cfg.attn_resolutions
        block_out = ch * cfg.ch_mult[i]
        h_first = ch * (cfg.ch_mult[-1] if i == cfg.num_resolutions - 1
                        else cfg.ch_mult[i + 1])
        splits = ((h_first,) + (block_out,) * cfg.num_res_blocks if qc.split
                  else (0,) * (cfg.num_res_blocks + 1))
        for j in range(cfg.num_res_blocks + 1):
            skip_in = ch * (in_ch_mult[i] if j == cfg.num_res_blocks
                            else cfg.ch_mult[i])
            h_ch = h_first if j == 0 else block_out
            plan.append(resblock((f"up_{i}", f"block_{j}"), f"up_{i}.block_{j}",
                                 h_ch + skip_in, block_out, split=splits[j]))
            if has_attn:
                plan.append(attnblock((f"up_{i}", f"attn_{j}"),
                                      f"up_{i}.attn_{j}"))
        if i != 0:
            plan.append(ReconTarget(
                f"up_{i}.upsample.conv", (f"up_{i}", "upsample", "conv"),
                conv_spec(block_out, (3, 3), wq,
                      aq.with_bits(8) if i == cfg.num_resolutions - 1 else aq),
                "layer"))

    plan.append(ReconTarget("conv_out", ("conv_out",),
                            conv_spec(cfg.out_ch, (3, 3), wq.with_bits(8), aq,
                                  disable_act_quant=True), "layer"))
    return plan


def ddpm_layer_plan(cfg: DDPMConfig, qc: QuantConfig):
    """Layer-mode plan (the reference's ablation path): every quantized
    layer reconstructs alone; an attention block gets q/k/v as layers, a
    whole-block target that trains only its act deltas, then proj_out."""
    wq, aq = qc.wq, qc.aq
    plan = []
    last_ch = cfg.ch
    for t in ddpm_recon_plan(cfg, qc):
        cls, fields = t.spec[0], dict(t.spec[1])
        if t.kind == "layer":
            plan.append(t)
        elif cls == "AttnBlockD":
            # attention always follows a res block at the same width
            one_by_one = conv_spec(last_ch, (1, 1), wq, aq, padding="VALID")
            for leaf in ("q", "k", "v"):
                plan.append(ReconTarget(f"{t.name}.{leaf}", t.path + (leaf,),
                                        one_by_one, "layer"))
            plan.append(ReconTarget(f"{t.name}.acts", t.path, t.spec, "block",
                                    act_only=True, inner_taps=t.inner_taps))
            plan.append(ReconTarget(f"{t.name}.proj_out", t.path + ("proj_out",),
                                    one_by_one, "layer"))
        else:                                 # ResnetBlockD: its layers in order
            out_ch = last_ch = fields["out_ch"]
            for (leaf,) in t.inner_taps:
                spec = (dense_spec(out_ch, wq, aq) if leaf == "temb_proj" else
                        conv_spec(out_ch, (1, 1), wq, aq, padding="VALID",
                              split=fields["split"]) if leaf == "nin_shortcut"
                        else conv_spec(out_ch, (3, 3), wq, aq))
                plan.append(ReconTarget(f"{t.name}.{leaf}", t.path + (leaf,),
                                        spec, "layer"))
    return plan
