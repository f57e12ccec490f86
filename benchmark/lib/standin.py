"""The stand-in for a calibrated quant state, set on the program's model:
a frozen copy of ``chip_smoke.py::smoke_quant_state`` at commit 34da27b,
with the range-to-scale and AdaRound-alpha arithmetic it called frozen in
from ``reference/quant.py`` (the same formulas).

Weights: each quantized layer's input-channel groups get symmetric
per-output-channel ranges ``[-max|w|, max|w|]`` and the alphas that make
hard rounding round to nearest.  Activations: the min and max that one
float forward (TF32 off) shows at every activation quantizer."""

from __future__ import annotations

import contextlib

import torch

from ..reference.quant import GAMMA, ZETA, qparams


@contextlib.contextmanager
def tf32(enabled: bool = False):
    """TF32 in the card's float32 products and convolutions off (the
    default: full float32) or on."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _alpha(w, d):
    rest = w / d - torch.floor(w / d)
    return -torch.log((ZETA - GAMMA) / (rest - GAMMA) - 1.0)


@torch.no_grad()
def set_state(model, inputs, kwargs) -> int:
    """Set the stand-in state on ``model`` (a program UNet); ``inputs`` and
    ``kwargs`` are its float forward's arguments.  Returns the number of
    activation quantizers set."""
    from eda_dm_tpu_torch.nn.layers import ActQuantizer, QConv, QDense
    from eda_dm_tpu_torch.quant import FP
    for m in model.modules():
        if isinstance(m, (QConv, QDense)):
            for name, s, e in m._parts:
                w = m.weight[:, s:e]
                amax = w.abs().reshape(w.shape[0], -1).amax(1)
                d, zp = qparams(-amax, amax, m.wq.n_levels)
                setattr(m, f"{name}_delta", d)
                setattr(m, f"{name}_zp", zp)
                setattr(m, f"{name}_alpha", _alpha(w, m._per_channel(d)))
    ranges, hooks = {}, []
    for m in model.modules():
        if isinstance(m, ActQuantizer):
            def hook(mod, args, _out):
                v = args[0].float()
                lo, hi = ranges.get(mod, (v.min(), v.max()))
                ranges[mod] = (torch.minimum(lo, v.min()), torch.maximum(hi, v.max()))
            hooks.append(m.register_forward_hook(hook))
    try:
        with tf32():
            model(*inputs, **kwargs, mode=FP)
    finally:
        for h in hooks:
            h.remove()
    for m, (lo, hi) in ranges.items():
        m.delta, m.zero_point = qparams(lo, hi, m.spec.n_levels, m.spec.always_zero)
    return len(ranges)
