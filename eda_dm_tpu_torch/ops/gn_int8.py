"""Fused GroupNorm (+swish) (+int8 act quantize and pad) (kernel K6).

Port of ``eda_dm_tpu/ops/pallas_gn.py`` (``gn_swish_int8``, ``gn_norm``).
Per (batch element, group of g = C / 32 channels), in float32:

    μ    = Σx / (hw·g)
    σ²   = Σ(x − μ)² / (hw·g)                  (two-pass variance)
    inv  = 1 / sqrt(σ² + eps)
    y    = (x − μ)·(inv·scale) + bias          (scale folded into inv first)
    y    = y·sigmoid(y)                        (optional swish)

``gn_swish_int8`` quantizes y, from float32, to centered int8 act codes
``clip(round(y/Δ), −zp, L−1−zp) − (L/2 − zp)`` and writes them already
padded, the rim holding the code of 0 (−c), so the next conv (K1) runs
VALID over them with no border correction.  ``gn_norm`` returns y in the
input's dtype, for norms with several consumers (attention input,
``norm_out``).

Both sums are taken in float64 and rounded once to float32 before the
float32 division by the count, so the statistics do not depend on the
order in which the kernel's threads add (the JAX kernel adds in float32,
in XLA's order).  Every later step is one IEEE float32 operation in the
order above, ``1/sqrt`` as a division by a square root and sigmoid as
``1/(1 + exp(−y))``: the kernel and the plain version run the same
operations, and the kernel contracts none of them into an FMA.

On a CUDA tensor the functions launch ``csrc/gn_int8.cu``; on a CPU tensor
they run the plain version.  Activations are NHWC.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._build import check_launch, cuda_lib, launch_counts, ptr, stream_ptr

Pads = Tuple[Tuple[int, int], Tuple[int, int]]
NO_PADS: Pads = ((0, 0), (0, 0))

_GN_SIG = {"edm_gn_int8": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
           + [ctypes.c_float, ctypes.c_void_p]}
# the shared memory one block may hold for the (h·w, g) slice in float32:
# 227 KB less the block's 64-byte reduction buffer
SMEM_BYTES = 227 * 1024 - 64


def gn_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             delta: Optional[torch.Tensor], zp: Optional[torch.Tensor],
             n_levels: int, pads: Pads, swish: bool, num_groups: int,
             eps: float) -> torch.Tensor:
    """K6's arithmetic in plain PyTorch.  With ``delta`` the padded int8
    codes, else y in ``x.dtype``.  Divisions are tensor by tensor: on the
    card PyTorch divides by a Python number as a product with its
    reciprocal, which rounds differently."""
    b, h, w, c = x.shape
    g = c // num_groups
    xg = x.float().reshape(b, h * w, num_groups, g)
    cnt = torch.tensor(float(h * w * g), dtype=torch.float32, device=x.device)
    mean = xg.double().sum((1, 3), keepdim=True).float() / cnt
    xc = xg - mean
    var = (xc * xc).double().sum((1, 3), keepdim=True).float() / cnt
    inv = 1.0 / torch.sqrt(var + eps)
    y = xc * (inv * scale.float().reshape(1, 1, num_groups, g)) \
        + bias.float().reshape(1, 1, num_groups, g)
    if swish:
        y = y * (1.0 / (1.0 + torch.exp(-y)))
    y = y.reshape(b, h, w, c)
    if delta is None:
        return y.to(x.dtype)
    cc = n_levels / 2 - zp
    q = torch.clamp(torch.round(y / delta), -zp, float(n_levels - 1) - zp)
    (pt, pb), (pl, pr) = pads
    out = (-cc).to(torch.int8).expand(b, h + pt + pb, w + pl + pr, c).contiguous()
    out[:, pt:pt + h, pl:pl + w, :] = (q - cc).to(torch.int8)
    return out


def _f32_param(t: torch.Tensor, c: int, dev, what: str) -> torch.Tensor:
    if t.shape != (c,) or t.device != dev:
        raise ValueError(f"{what} must be ({c},) on {dev}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.float().contiguous()


def _gn_cuda(x, scale, bias, delta, zp, n_levels, pads, swish, num_groups,
             eps):
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise ValueError(f"gn_int8 takes a float32 or bfloat16 NHWC tensor, "
                         f"not {x.dtype} {tuple(x.shape)}")
    b, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"{c} channels are not {num_groups} whole groups")
    if h * w * (c // num_groups) * 4 > SMEM_BYTES:
        raise ValueError(f"one group of {h}x{w}x{c // num_groups} does not fit "
                         f"a block's shared memory (outside the gate)")
    x = x.contiguous()
    scale = _f32_param(scale, c, dev, "scale")
    bias = _f32_param(bias, c, dev, "bias")
    (pt, pb), (pl, pr) = pads
    if delta is None:
        out = torch.empty_like(x)
    else:
        for t, what in ((delta, "delta"), (zp, "zp")):
            if t.numel() != 1 or t.dtype != torch.float32 or t.device != dev:
                raise ValueError(f"{what} must be a float32 scalar on {dev}")
        out = torch.empty((b, h + pt + pb, w + pl + pr, c), dtype=torch.int8,
                          device=dev)
    lib = cuda_lib("gn_int8", _GN_SIG)
    err = lib.edm_gn_int8(
        ptr(x), ptr(scale), ptr(bias), ptr(delta), ptr(zp),
        ptr(out), int(x.dtype == torch.bfloat16), int(swish), b, h, w, c,
        num_groups, n_levels, pt, pb, pl, pr, eps, stream_ptr(dev))
    check_launch(lib, err, "gn_int8")
    launch_counts["gn_int8"] += 1
    return out


def _gn(x, *args):
    if x.is_cuda:
        return _gn_cuda(x, *args)
    if x.device.type != "cpu":
        raise ValueError(f"gn_int8: unsupported device {x.device}")
    return gn_plain(x, *args)


def gn_swish_int8(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  delta: torch.Tensor, zp: torch.Tensor, n_levels: int,
                  pads: Pads = NO_PADS, swish: bool = True,
                  num_groups: int = 32, eps: float = 1e-6
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm → (swish) → centered int8 act codes → pad, in one pass.
    Returns ``(padded codes, c)`` with the ``quantize_act_int8`` contract;
    the rim carries the code of x = 0 (−c), as padding x with zeros before
    the quantizer would."""
    if n_levels > 256:
        raise ValueError("int8 act codes require act_bit <= 8")
    pads = tuple(tuple(p) for p in pads)
    codes = _gn(x, scale, bias, delta, zp, n_levels, pads, swish, num_groups,
                eps)
    return codes, n_levels / 2 - zp


def gn_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            swish: bool = False, num_groups: int = 32,
            eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm (+ swish) in one pass, returned in ``x.dtype``."""
    return _gn(x, scale, bias, None, None, 0, NO_PADS, swish, num_groups, eps)
