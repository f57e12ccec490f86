"""Uniform affine quantization primitives (port of ``eda_dm_tpu/quant/affine.py``).

Forward arithmetic only: the serving slice never differentiates through a
quantizer.  ``torch.round`` rounds half to even, like ``jnp.round``.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def calculate_qparams(x_min: torch.Tensor, x_max: torch.Tensor, n_levels: int,
                      always_zero: bool = False):
    """(scale, zero_point) from a clipping range.

    The range is widened to include zero; zero_point is an integer-valued
    float clipped to [0, n_levels-1].  Exactly symmetric ranges land on
    zp = (n_levels-1)/2 = x.5, where the last bit of the division decides
    the rounding; the canonical half-to-even result ``n_levels // 2`` is
    pinned instead.
    """
    x_min = torch.as_tensor(x_min, dtype=torch.float32)
    x_max = torch.as_tensor(x_max, dtype=torch.float32, device=x_min.device)
    min_neg = torch.clamp(x_min, max=0.0)
    max_pos = torch.clamp(x_max, min=0.0)
    scale = torch.clamp((max_pos - min_neg) / float(n_levels - 1), min=EPS)
    if always_zero:
        return scale, torch.zeros_like(scale)
    zero_point = torch.clamp(torch.round(-min_neg / scale), 0.0, n_levels - 1)
    zero_point = torch.where(min_neg == -max_pos,
                             torch.full_like(zero_point, n_levels // 2),
                             zero_point)
    return scale, zero_point


def fake_quant(x: torch.Tensor, delta: torch.Tensor, zero_point: torch.Tensor,
               n_levels: int) -> torch.Tensor:
    """Quantize→dequantize.  Level boundaries are computed in float32 (so a
    bf16 carrier picks the same levels as f32); the result has ``x.dtype``.
    ``clip(round(x/Δ), -zp, L-1-zp)·Δ`` is the affine form with zp folded
    into the clip bounds (zp is integer-valued, so the fold is exact)."""
    x_q = torch.clamp(torch.round(x.float() / delta), -zero_point,
                      n_levels - 1 - zero_point)
    return (x_q * delta).to(x.dtype)


def fake_quant_nograd(x: torch.Tensor, delta, zero_point, n_levels: int) -> torch.Tensor:
    """Quantize→dequantize in the offset form used inside the range
    searches: ``(clip(round(x/Δ) + zp, 0, L−1) − zp)·Δ``, in the type that
    ``x`` and ``delta`` promote to."""
    if isinstance(delta, torch.Tensor):
        x = x.to(torch.promote_types(x.dtype, delta.dtype))
    x_int = torch.round(x / delta) + zero_point
    x_quant = torch.clamp(x_int, 0.0, n_levels - 1)
    return (x_quant - zero_point) * delta
