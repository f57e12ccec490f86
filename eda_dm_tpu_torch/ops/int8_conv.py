"""Int8 convolution with the zero-code-padding epilogue (kernel K1).

Port of the int8 ``lax.conv_general_dilated`` calls in
``eda_dm_tpu/nn/layers.py`` (``QConv._int8_forward``).  The input is
quantized UNPADDED to centered int8 codes; the convolution zero-pads the
CODE array, which over-counts each border tap by ``c·w`` (x = 0 has code
−c); the epilogue subtracts ``c·border`` with ``border`` the int32 conv of
the pad indicator:

    out = (acc + c·(isum − border))·(Δx·Δw) + bias

On a CUDA tensor :func:`int8_conv` launches ``csrc/int8_conv.cu`` (an
implicit GEMM on the tensor-core mainloop ``csrc/int8_gemm.cuh``, by the
tile and load route :func:`conv_plan` chooses); on a CPU tensor it runs
the plain version.
Activations are NHWC, weight codes ``[Cout, kh, kw, Cin]``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import check_launch, cuda_lib, launch_counts, ptr, stream_ptr
from .int8_einsum import TILE_LARGE, TILE_SMALL, exact_float, load_route, tf32_off

Pads = Tuple[Tuple[int, int], Tuple[int, int]]

_CONV_SIG = {"edm_int8_conv": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14
             + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]}

SMALL_COUT_MAX = 64      # the 128 x 64 tile up to this many output channels


def conv_plan(cin: int, cout: int, x_ptr: int, w_ptr: int) -> Tuple[int, int]:
    """K1's (tile, route) for a conv of ``cin`` → ``cout`` channels on codes
    at ``x_ptr`` and weight codes at ``w_ptr``: the 128 x 64 tile
    (``TILE_SMALL``) where Cout ≤ 64, the UNets' ``conv_out``s (Cout = 3 or
    4; on the H100 it took CIFAR's 0.45 ms on the 128 x 128 tile to 0.28,
    ``probes/conv_plans.py``), else 128 x 128; the route by
    :func:`~eda_dm_tpu_torch.ops.int8_einsum.load_route` of a pixel's Cin
    codes (a 16-byte copy never crosses a tap where Cin % 16 == 0).  The K
    step and ring are fixed per route in ``csrc/int8_conv.cu``."""
    tile = TILE_SMALL if cout <= SMALL_COUT_MAX else TILE_LARGE
    return tile, load_route(cin, x_ptr, w_ptr)


def same_pads(h: int, w: int, kh: int, kw: int, sh: int, sw: int) -> Pads:
    """XLA's SAME padding: the extra pixel of an odd total goes at the end."""
    def one(size, k, s):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        return (total // 2, total - total // 2)
    return one(h, kh, sh), one(w, kw, sw)


def out_size(h: int, w: int, kh: int, kw: int, stride, pads: Pads):
    return ((h + pads[0][0] + pads[0][1] - kh) // stride[0] + 1,
            (w + pads[1][0] + pads[1][1] - kw) // stride[1] + 1)


def border_map(w_codes: torch.Tensor, h: int, w: int, stride,
               pads: Pads) -> torch.Tensor:
    """int32 ``border[ho, wo, co]``: the sum of the weight codes of every tap
    of output pixel (ho, wo) that lands in the padding.  Equal to the JAX
    package's VALID int32 conv of the padded indicator; it depends only on
    the layer and the input size, so callers cache it."""
    cout, kh, kw, _ = w_codes.shape
    ho, wo = out_size(h, w, kh, kw, stride, pads)
    dev = w_codes.device
    hi = (torch.arange(ho, device=dev)[:, None] * stride[0] - pads[0][0]
          + torch.arange(kh, device=dev)[None])
    wi = (torch.arange(wo, device=dev)[:, None] * stride[1] - pads[1][0]
          + torch.arange(kw, device=dev)[None])
    out_h = (hi < 0) | (hi >= h)                        # (Ho, kh)
    out_w = (wi < 0) | (wi >= w)                        # (Wo, kw)
    in_pad = out_h[:, None, :, None] | out_w[None, :, None, :]
    tap_sum = w_codes.to(torch.int32).sum(-1)           # (Cout, kh, kw)
    border = (in_pad.reshape(ho, wo, kh * kw, 1).to(torch.int32)
              * tap_sum.reshape(cout, kh * kw).t()[None, None]).sum(2)
    return border.to(torch.int32).contiguous()


def int8_conv_acc_plain(codes: torch.Tensor, w_codes: torch.Tensor, stride,
                        pads: Pads) -> torch.Tensor:
    """Exact int32 accumulators of the zero-padded code convolution, NHWC:
    a sum over the kh·kw taps of (pixels × Cin)·(Cin × Cout) products in a
    float type where every partial sum is an exact integer.  (cuDNN is
    avoided on purpose: its Winograd algorithms round.)"""
    n, h, w, cin = codes.shape
    cout, kh, kw, _ = w_codes.shape
    ho, wo = out_size(h, w, kh, kw, stride, pads)
    dt = exact_float(128 * int(w_codes.to(torch.int32).abs().max()) * kh * kw * cin)
    xp = F.pad(codes.to(dt), (0, 0, pads[1][0], pads[1][1],
                              pads[0][0], pads[0][1]))
    wt = w_codes.to(dt)
    acc = torch.zeros((n * ho * wo, cout), dtype=dt, device=codes.device)
    with tf32_off():
        for r in range(kh):
            for s in range(kw):
                patch = xp[:, r:r + (ho - 1) * stride[0] + 1:stride[0],
                           s:s + (wo - 1) * stride[1] + 1:stride[1], :]
                acc += patch.reshape(-1, cin) @ wt[:, r, s, :].t()
    return acc.reshape(n, ho, wo, cout).to(torch.int32)


def conv_epilogue(acc, isum, border, c, scale, bias, out_dtype):
    """``(acc + c·(isum − border))·scale + bias`` in float32, JAX order."""
    corr = c * (isum - border.float()) if border is not None else c * isum
    out = (acc.float() + corr) * scale
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def int8_conv_plain(codes, w_codes, isum, c, scale, bias, stride, pads,
                    border, out_dtype):
    return conv_epilogue(int8_conv_acc_plain(codes, w_codes, stride, pads),
                         isum, border, c, scale, bias, out_dtype)


def _int8_conv_cuda(codes, w_codes, isum, c, scale, bias, stride, pads,
                    border, out_dtype, tile=None):
    """The kernel's launch at :func:`conv_plan`'s plan, or at ``tile`` with
    its route (the card tests and the probe pass both tiles)."""
    dev = codes.device
    if codes.dtype != torch.int8 or w_codes.dtype != torch.int8:
        raise ValueError("int8_conv takes int8 codes and int8 weight codes")
    if not (codes.is_contiguous() and w_codes.is_contiguous()):
        raise ValueError("int8_conv takes contiguous NHWC codes and "
                         "[Cout, kh, kw, Cin] weight codes")
    n, h, w, cin = codes.shape
    cout, kh, kw, cin_w = w_codes.shape
    if cin_w != cin:
        raise ValueError(f"Cin mismatch: codes {cin}, weights {cin_w}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_conv writes float32 or bfloat16, not {out_dtype}")
    ho, wo = out_size(h, w, kh, kw, stride, pads)
    if n * max(h * w, ho * wo) >= 2 ** 31:
        raise ValueError("int8_conv indexes pixels in 32 bits")
    plan_tile, route = conv_plan(cin, cout, codes.data_ptr(), w_codes.data_ptr())
    tile = plan_tile if tile is None else tile
    for t, shape, dt, what in ((isum, (cout,), torch.float32, "isum"),
                               (scale, (cout,), torch.float32, "scale"),
                               (c, (), torch.float32, "c"),
                               (bias, (cout,), torch.float32, "bias"),
                               (border, (ho, wo, cout), torch.int32, "border")):
        if t is not None and (t.shape != shape or t.dtype != dt
                              or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{what} must be a contiguous {dt} {shape} on {dev}")
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=dev)
    lib = cuda_lib("int8_conv", _CONV_SIG)
    err = lib.edm_int8_conv(
        ptr(codes), ptr(w_codes), ptr(out), int(out_dtype == torch.bfloat16),
        n, h, w, cin, ho, wo, cout, kh, kw, stride[0], stride[1],
        pads[0][0], pads[1][0], ptr(isum), ptr(border), ptr(c), ptr(scale),
        ptr(bias), tile, route, stream_ptr(dev))
    check_launch(lib, err, "int8_conv")
    launch_counts["int8_conv"] += 1
    return out


def int8_conv(codes: torch.Tensor, w_codes: torch.Tensor, isum: torch.Tensor,
              c: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
              stride, pads: Pads, border: Optional[torch.Tensor],
              out_dtype: torch.dtype) -> torch.Tensor:
    """Zero-code-padded int8 conv + fused dequant epilogue.

    codes (N, H, W, Cin) int8; w_codes (Cout, kh, kw, Cin) int8; isum,
    scale, bias (Cout,) float32; c scalar float32; border (Ho, Wo, Cout)
    int32 or None when there is no padding.  Returns (N, Ho, Wo, Cout) in
    ``out_dtype``.
    """
    if codes.is_cuda:
        return _int8_conv_cuda(codes, w_codes, isum, c, scale, bias, stride,
                               pads, border, out_dtype)
    if codes.device.type != "cpu":
        raise ValueError(f"int8_conv: unsupported device {codes.device}")
    return int8_conv_plain(codes, w_codes, isum, c, scale, bias, stride, pads,
                           border, out_dtype)
