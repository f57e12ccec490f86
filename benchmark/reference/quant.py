"""Quantizer arithmetic of the reference: range to (scale, zero point), the
stand-in state's hard-rounded weights, activation fake quantization, and
the carrier rounding of the control."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

EPS = 1e-8
GAMMA, ZETA = -0.1, 1.1            # AdaRound's rectified sigmoid
FP8_MAX = 448.0                    # largest finite float8_e4m3fn


def qparams(lo, hi, n_levels: int, always_zero: bool = False):
    """(scale, zero point) of a clipping range widened to include 0; an
    exactly symmetric range takes the zero point ``n_levels // 2``."""
    lo = torch.as_tensor(lo, dtype=torch.float32)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=lo.device)
    min_neg = torch.clamp(lo, max=0.0)
    max_pos = torch.clamp(hi, min=0.0)
    scale = torch.clamp((max_pos - min_neg) / float(n_levels - 1), min=EPS)
    if always_zero:
        return scale, torch.zeros_like(scale)
    zp = torch.clamp(torch.round(-min_neg / scale), 0.0, n_levels - 1)
    zp = torch.where(min_neg == -max_pos, torch.full_like(zp, n_levels // 2), zp)
    return scale, zp


def rounded_weight(w: torch.Tensor, n_levels: int) -> torch.Tensor:
    """The stand-in state's weight: symmetric per-output-channel range
    (``[-max|w|, max|w|]``), each value rounded to the nearest level by the
    AdaRound form ``floor(w/Δ) + [α ≥ 0]`` with α the inverse rectified
    sigmoid of the residue, clipped to the grid, times Δ."""
    w = w.float()
    amax = w.abs().reshape(w.shape[0], -1).amax(1)
    d, zp = qparams(-amax, amax, n_levels)
    shape = (-1,) + (1,) * (w.dim() - 1)
    d, zp = d.reshape(shape), zp.reshape(shape)
    rest = w / d - torch.floor(w / d)
    alpha = -torch.log((ZETA - GAMMA) / (rest - GAMMA) - 1.0)
    q = torch.floor(w / d) + (alpha >= 0).to(w.dtype)
    return (torch.clamp(q + zp, 0.0, n_levels - 1) - zp) * d


@dataclasses.dataclass
class Ctx:
    """What a reference forward does: ``calib`` records each activation
    quantizer's input range (a float forward); otherwise ``quant`` applies
    the quantizers.  ``carrier`` rounds each layer's output (None: float32
    throughout)."""
    calib: bool = False
    quant: bool = True
    carrier: Optional[torch.dtype] = None

    def c(self, x: torch.Tensor) -> torch.Tensor:
        if self.carrier is None:
            return x
        if self.carrier == torch.float8_e4m3fn:        # saturating, as fp8 GEMMs scale
            x = torch.clamp(x, -FP8_MAX, FP8_MAX)
        return x.to(self.carrier).float()


class ActQ(torch.nn.Module):
    """A per-tensor activation quantizer: ``n_levels`` levels,
    ``always_zero`` pins the zero point (softmax outputs).  Holds no
    parameter; its range comes from the reference's own float forward."""

    def __init__(self, n_levels: int = 256, always_zero: bool = False):
        super().__init__()
        self.n_levels, self.always_zero = n_levels, always_zero
        self.lo = self.hi = None
        self.delta = self.zp = None

    def forward(self, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        if ctx.calib:
            lo, hi = x.min().float(), x.max().float()
            self.lo = lo if self.lo is None else torch.minimum(self.lo, lo)
            self.hi = hi if self.hi is None else torch.maximum(self.hi, hi)
            return x
        if not ctx.quant:
            return x
        q = torch.clamp(torch.round(x.float() / self.delta), -self.zp,
                        self.n_levels - 1 - self.zp)
        return q * self.delta

    def freeze(self) -> None:
        self.delta, self.zp = qparams(self.lo, self.hi, self.n_levels, self.always_zero)


def calibrate(model: torch.nn.Module, run) -> int:
    """The stand-in activation state: ``run(ctx)`` makes the float forward
    (over as many row blocks as it likes); every quantizer keeps the min and
    max of its inputs.  Returns the number of quantizers set."""
    qs = [m for m in model.modules() if isinstance(m, ActQ)]
    for q in qs:
        q.lo = q.hi = None
    run(Ctx(calib=True, quant=False))
    seen = [q for q in qs if q.lo is not None]
    for q in seen:
        q.freeze()
    return len(seen)
