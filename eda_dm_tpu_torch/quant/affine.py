"""Uniform affine quantization primitives (port of ``eda_dm_tpu/quant/affine.py``).

``torch.round`` rounds half to even, like ``jnp.round``.  A clip between
tensor bounds is ``minimum(maximum(x, lo), hi)``: where x equals a bound
both libraries then pass half the gradient to x (``torch.clamp`` would
pass all of it), so the straight-through gradients of :func:`fake_quant`
(whose codes land on their bounds) are JAX's.  Between number bounds it is
``torch.clamp``, which makes no device tensor of them; there (soft
AdaRound's rectified sigmoid) an input equal to a bound is a tie of float
sums that does not occur in practice.
"""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-8


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    if not (isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor)):
        return torch.clamp(x, lo, hi)
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def lp_loss(pred: torch.Tensor, tgt: torch.Tensor, p: float = 2.0,
            channel_axis: Optional[int] = None) -> torch.Tensor:
    """L_p reconstruction loss: with ``channel_axis`` the sum over that axis,
    meaned over the rest; otherwise the mean over all elements."""
    err = torch.abs(pred - tgt) ** p
    if channel_axis is None:
        return err.mean()
    return err.sum(dim=channel_axis).mean()


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
    """Quantize→dequantize with a straight-through gradient with respect to
    ``x`` and ``delta``.  Level boundaries are computed in float32 (so a
    bf16 carrier picks the same levels as f32); the result has ``x.dtype``.
    ``clip(round(x/Δ), -zp, L-1-zp)·Δ`` is the affine form with zp folded
    into the clip bounds (zp is integer-valued, so the fold is exact)."""
    x_q = _clip(round_ste(x.float() / delta), -zero_point,
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


def qdrop(x_fq: torch.Tensor, x: torch.Tensor, prob: float,
          generator: Optional[torch.Generator] = None,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """QDrop stochastic bypass: keep the quantized value with probability
    ``prob``.  The keep mask is ``mask`` when given, else drawn uniformly
    from ``generator`` on x's device."""
    if mask is None:
        mask = torch.rand(x.shape, generator=generator, device=x.device) < prob
    return torch.where(mask, x_fq, x)


def ema_update(running_min, running_max, x_min, x_max, momentum: float = 0.9):
    """EMA range update of activation (leaf) quantizers; the caller seeds
    the running range with the first batch's values."""
    new_min = (1.0 - momentum) * x_min + momentum * running_min
    new_max = (1.0 - momentum) * x_max + momentum * running_max
    return new_min, new_max
