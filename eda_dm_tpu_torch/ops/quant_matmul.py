"""Serving matmul with the activation fake-quant fused into the tile load
(kernel K7).

Port of ``eda_dm_tpu/ops/pallas_quant.py::fakequant_matmul``, which the
DEPLOY_FUSED mode runs for every 1×1 conv and dense:

    out = (clip(round(x/Δ_k), −zp_k, L−1−zp_k)·Δ_k).to(w.dtype) @ w + bias

with per-input-channel rows Δ_k, zp_k (a split layer's two quantizers
give two channel ranges), products accumulated in float32 and the output
in ``x.dtype``.  The layout is the JAX package's: x (M, K), w (K, N).  The
port stores weights ``[out, in]``, so callers pass the transposed view
(``weight.t()``): the wrapper hands the kernel w's two strides, and takes
any strided (K, N) view without a copy.

On a CUDA tensor :func:`fakequant_matmul` launches
``csrc/fakequant_matmul.cu``; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import check_launch, cuda_lib, launch_counts, ptr, stream_ptr
from .int8_einsum import tf32_off

_FQ_SIG = {"edm_fakequant_matmul": [ctypes.c_void_p] * 6
           + [ctypes.c_int] * 8 + [ctypes.c_void_p]}


def fakequant_rows(x: torch.Tensor, delta_k: torch.Tensor, zp_k: torch.Tensor,
                   n_levels: int, dtype: torch.dtype) -> torch.Tensor:
    """The fake-quantized x in ``dtype``: level boundaries in float32, the
    product ``q·Δ`` in float32, then one rounding to ``dtype``."""
    q = torch.clamp(torch.round(x.float() / delta_k), -zp_k,
                    float(n_levels - 1) - zp_k)
    return (q * delta_k).to(dtype)


def fakequant_matmul_plain(x, w, delta_k, zp_k, n_levels, bias):
    xq = fakequant_rows(x, delta_k, zp_k, n_levels, w.dtype)
    with tf32_off():
        acc = xq.float() @ w.float()
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(x.dtype)


def _fakequant_matmul_cuda(x, w, delta_k, zp_k, n_levels, bias):
    dev = x.device
    for t, what in ((x, "x"), (w, "w")):
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dim() != 2:
            raise ValueError(f"fakequant_matmul takes a float32 or bfloat16 "
                             f"matrix {what}, not {t.dtype} {tuple(t.shape)}")
    m, k = x.shape
    if w.shape[0] != k or w.device != dev:
        raise ValueError(f"shape mismatch {tuple(x.shape)} x {tuple(w.shape)}")
    n = w.shape[1]
    rows = []
    for t, shape, what in ((delta_k, (k,), "delta_k"), (zp_k, (k,), "zp_k"),
                           (bias, (n,), "bias")):
        if t is not None and (t.shape != shape or t.device != dev):
            raise ValueError(f"{what} must be {shape} on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
        rows.append(None if t is None else t.float().contiguous())
    x = x.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    lib = cuda_lib("fakequant_matmul", _FQ_SIG)
    err = lib.edm_fakequant_matmul(
        ptr(x), ptr(w), ptr(rows[0]), ptr(rows[1]), ptr(rows[2]), ptr(out),
        int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
        m, n, k, w.stride(0), w.stride(1), n_levels, stream_ptr(dev))
    check_launch(lib, err, "fakequant_matmul")
    launch_counts["fakequant_matmul"] += 1
    return out


def fakequant_matmul(x: torch.Tensor, w: torch.Tensor, delta_k: torch.Tensor,
                     zp_k: torch.Tensor, n_levels: int = 256,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``fq(x) @ w (+ bias)``: x (M, K) float32/bf16, w (K, N) folded
    weights (any strides), delta_k / zp_k (K,) and bias (N,) float32.
    Returns (M, N) in ``x.dtype``."""
    if x.is_cuda:
        return _fakequant_matmul_cuda(x, w, delta_k, zp_k, n_levels, bias)
    if x.device.type != "cpu":
        raise ValueError(f"fakequant_matmul: unsupported device {x.device}")
    return fakequant_matmul_plain(x, w, delta_k, zp_k, n_levels, bias)
