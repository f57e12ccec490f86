"""AdaRound hard rounding (port of ``eda_dm_tpu/quant/adaround.py``).

``alpha`` is a weight-shaped tensor; hard rounding adds ``alpha >= 0`` to
the floor, and ``init_alpha`` makes that coincide with round-to-nearest.
"""

from __future__ import annotations

import torch

GAMMA, ZETA = -0.1, 1.1


def init_alpha(w: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Invert the rectified sigmoid so h(alpha) equals the rounding residue."""
    rest = w / delta - torch.floor(w / delta)            # [0, 1)
    return -torch.log((ZETA - GAMMA) / (rest - GAMMA) - 1.0)


def adaround_fake_quant(w: torch.Tensor, delta: torch.Tensor,
                        zero_point: torch.Tensor, alpha: torch.Tensor,
                        n_levels: int, soft: bool = False) -> torch.Tensor:
    """Weight fake-quant with learned rounding; only the hard (deployment)
    form is ported."""
    if soft:
        raise NotImplementedError("soft AdaRound targets belong to calibration")
    w_int = torch.floor(w / delta) + (alpha >= 0).to(w.dtype)
    w_quant = torch.clamp(w_int + zero_point, 0.0, n_levels - 1)
    return (w_quant - zero_point) * delta


def adaround_int(w: torch.Tensor, delta: torch.Tensor,
                 zero_point: torch.Tensor, alpha: torch.Tensor,
                 n_levels: int) -> torch.Tensor:
    """Centered integer codes ``clip(floor(w/Δ) + (α≥0) + zp, 0, L-1) − zp``
    (float-valued): the integers whose ``q·Δ`` is the hard fake-quant."""
    w_int = torch.floor(w / delta) + (alpha >= 0).to(w.dtype)
    return torch.clamp(w_int + zero_point, 0.0, n_levels - 1) - zero_point
