"""AdaRound adaptive rounding (port of ``eda_dm_tpu/quant/adaround.py``).

``alpha`` is a weight-shaped tensor.  Soft rounding (a target under
reconstruction) adds the rectified sigmoid ``h(alpha)`` to the floor and is
differentiable in alpha; hard rounding (deployment) adds ``alpha >= 0``.
``init_alpha`` makes hard rounding coincide with round-to-nearest.
"""

from __future__ import annotations

import torch

from .affine import _clip

GAMMA, ZETA = -0.1, 1.1


def soft_targets(alpha: torch.Tensor) -> torch.Tensor:
    """Rectified sigmoid h(alpha) in [0, 1]."""
    return _clip(torch.sigmoid(alpha) * (ZETA - GAMMA) + GAMMA, 0.0, 1.0)


def init_alpha(w: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Invert the rectified sigmoid so h(alpha) equals the rounding residue."""
    rest = w / delta - torch.floor(w / delta)            # [0, 1)
    return -torch.log((ZETA - GAMMA) / (rest - GAMMA) - 1.0)


def adaround_fake_quant(w: torch.Tensor, delta: torch.Tensor,
                        zero_point: torch.Tensor, alpha: torch.Tensor,
                        n_levels: int, soft: bool = False) -> torch.Tensor:
    """Weight fake-quant with learned rounding: ``floor + h(alpha)`` when
    ``soft``, else ``floor + (alpha >= 0)``."""
    w_floor = torch.floor(w / delta)
    if soft:
        w_int = w_floor + soft_targets(alpha)
    else:
        w_int = w_floor + (alpha >= 0).to(w.dtype)
    w_quant = _clip(w_int + zero_point, 0.0, n_levels - 1)
    return (w_quant - zero_point) * delta


def adaround_int(w: torch.Tensor, delta: torch.Tensor,
                 zero_point: torch.Tensor, alpha: torch.Tensor,
                 n_levels: int) -> torch.Tensor:
    """Centered integer codes ``clip(floor(w/Δ) + (α≥0) + zp, 0, L-1) − zp``
    (float-valued): the integers whose ``q·Δ`` is the hard fake-quant."""
    w_int = torch.floor(w / delta) + (alpha >= 0).to(w.dtype)
    return torch.clamp(w_int + zero_point, 0.0, n_levels - 1) - zero_point


def round_regularization(alpha: torch.Tensor, b) -> torch.Tensor:
    """f_reg = sum(1 - |2h-1|^b), the rounding relaxation penalty."""
    h = soft_targets(alpha)
    return torch.sum(1.0 - torch.abs((h - 0.5) * 2.0) ** b)
