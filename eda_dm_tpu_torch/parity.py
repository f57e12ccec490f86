"""Layer-by-layer parity probes: where two runs of one model part ways.

Two runs of a quantized model (host and card, port and JAX, two summation
orders) agree to the last bit only where every operation does.  Where a
float operation rounds differently, an activation that sits on a rounding
boundary of its quantizer takes the adjacent code, and the flip spreads to
everything downstream.  These probes tell the two apart:

* :func:`tap` keeps a host copy of the input and the output of every call
  of the chosen modules; with ``replace=`` each of those calls computes on
  the other run's recorded input instead of its own (teacher forcing), so
  every module is held against the other run alone, with no drift from
  upstream;
* :func:`act_code_flips` counts, quantizer by quantizer, the activation
  codes on which two tapped runs differ.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from .nn.layers import ActQuantizer

Record = Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]]


def _host(v):
    return v.detach().float().cpu() if torch.is_tensor(v) else v


@contextlib.contextmanager
def tap(model: torch.nn.Module, kinds, replace: Optional[Record] = None):
    """Record ``{module name: [(input, output) per call]}`` for every module
    of ``kinds`` (host float32 copies; the input is the call's first
    argument, as the run computed it).  With ``replace``, each call then
    runs on ``replace[name][call][0]`` instead, cast to the input's device
    and dtype.  Calls whose first argument is not a tensor (the softmax
    quantizer's ``params_only`` call) are not recorded."""
    rec: Record = {}
    names = {m: n for n, m in model.named_modules()}
    pending = {}

    def pre(mod, args):
        x = args[0] if args else None
        if not torch.is_tensor(x):
            return None
        name = names[mod]
        pending[mod] = _host(x)
        if replace is not None:
            forced = replace[name][len(rec.get(name, []))][0]
            return (forced.to(x.device, x.dtype),) + tuple(args[1:])
        return None

    def post(mod, args, out):
        if mod in pending:
            rec.setdefault(names[mod], []).append(
                (pending.pop(mod), _host(out)))

    handles = []
    for m in model.modules():
        if isinstance(m, kinds):
            handles += [m.register_forward_pre_hook(pre),
                        m.register_forward_hook(post)]
    try:
        yield rec
    finally:
        for h in handles:
            h.remove()


def act_code_flips(model: torch.nn.Module, a: Record, b: Record):
    """``[(quantizer name, elements, codes that differ, max |Δ input|)]`` in
    call order of ``a``, for two runs tapped at the ``ActQuantizer``s.  The
    codes are ``clip(round(x/Δ), −zp, L−1−zp)`` with each quantizer's own
    state."""
    quantizers = dict(model.named_modules())
    rows = []
    for name, calls in a.items():
        q = quantizers[name]
        assert isinstance(q, ActQuantizer), name
        d, zp = q.delta.float().cpu(), q.zero_point.float().cpu()
        hi = float(q.spec.n_levels - 1)
        for (xa, _), (xb, _) in zip(calls, b[name]):
            ca = torch.clamp(torch.round(xa / d), -zp, hi - zp)
            cb = torch.clamp(torch.round(xb / d), -zp, hi - zp)
            rows.append((name, xa.numel(), int((ca != cb).sum()),
                         float((xa - xb).abs().max())))
    return rows
