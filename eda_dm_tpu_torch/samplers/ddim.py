"""Pixel-space DDIM sampling (port of ``eda_dm_tpu/samplers/ddim.py``).

The JAX package's ``lax.scan`` is a Python step loop here.  Noise comes
from an explicit ``torch.Generator`` or is passed in per step: JAX's PRNG
and torch's give different numbers from one seed.  At ``eta=0`` the noise
term is multiplied by zero, so no noise is drawn.  On a batch sharded over
ranks (``parallel/dp.py``) each rank draws the global batch's noise and
keeps its rows (``parallel/rows.py``), as one process would draw it; on a
height sharded over ranks (``parallel/spatial.py``) each rank draws the
global height and keeps its rows of it.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..parallel import spatial
from ..utils.run import span
from .schedules import alphas_cumprod_padded

STEP = "edm.sampler.step"      # one span a sampler step (utils/run.py::span)


def ddim_denoise_step(x, et, at, at_next, eta, noise):
    """One generalized DDIM update; returns (x_next, x0)."""
    x0 = (x - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)
    c1 = eta * torch.sqrt((1.0 - at / at_next) * (1.0 - at_next) / (1.0 - at))
    c2 = torch.sqrt((1.0 - at_next) - c1 ** 2)
    x_next = torch.sqrt(at_next) * x0
    if noise is not None:
        x_next = x_next + c1 * noise
    return x_next + c2 * et, x0


def _seq_pairs(seq):
    """(t, t_next) pairs in sampling order (descending t)."""
    seq = np.asarray(seq)
    seq_next = np.concatenate([[-1], seq[:-1]])
    return list(zip(seq[::-1].tolist(), seq_next[::-1].tolist()))


@torch.no_grad()
def generalized_steps(x: torch.Tensor, seq, model_fn: Callable, betas,
                      eta: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[Sequence[torch.Tensor]] = None,
                      device=None, capture_fn: Optional[Callable] = None,
                      record_xt: bool = False, model_returns_aux: bool = False):
    """Run the reverse DDIM trajectory over the ascending timestep subset
    ``seq``.  ``model_fn(x, t) -> eps`` with ``t`` float32 of shape (N,);
    with ``model_returns_aux`` it returns (eps, aux) and aux is stacked per
    step.  ``record_xt`` stacks every step's input x_t (``"x"``) and its
    integer timestep (``"t"``); ``capture_fn(x, t)`` records anything else
    (``"extra"``).  With ``eta > 0`` the per-step noise is ``noise[k]`` when
    given, else drawn from ``generator``.

    Returns x_0, or (x_0, per-step dict) when any of ``record_xt``,
    ``model_returns_aux`` and ``capture_fn`` is given."""
    device = resolve_device(device)
    x = x.to(device)
    alphas = alphas_cumprod_padded(betas, device=device)
    n = x.shape[0]
    ys = {}
    for k, (i, j) in enumerate(_seq_pairs(seq)):
        with span(STEP):
            t = torch.full((n,), float(i), dtype=torch.float32, device=device)
            if model_returns_aux:
                et, aux = model_fn(x, t)
                ys.setdefault("aux", []).append(aux)
            else:
                et = model_fn(x, t)
            if record_xt:
                ys.setdefault("x", []).append(x)
                ys.setdefault("t", []).append(i)
            if capture_fn is not None:
                ys.setdefault("extra", []).append(capture_fn(x, t))
            z = None
            if eta != 0.0:
                z = (noise[k] if noise is not None else
                     spatial.draw(torch.randn, x.shape, generator=generator,
                               device=device, dtype=x.dtype))
            x, _ = ddim_denoise_step(x, et, alphas[i + 1], alphas[j + 1], eta, z)
    if not (record_xt or model_returns_aux or capture_fn is not None):
        return x
    out = {k: torch.stack(v) for k, v in ys.items() if k in ("x", "aux")}
    if record_xt:
        out["t"] = torch.tensor(ys["t"], dtype=torch.int32)
    if capture_fn is not None:
        out["extra"] = ys["extra"]
    return x, out


@torch.no_grad()
def ddpm_steps(x: torch.Tensor, seq, model_fn: Callable, betas,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Sequence[torch.Tensor]] = None,
               device=None) -> torch.Tensor:
    """Ancestral DDPM sampling over the timestep subset ``seq``; the
    per-step noise is ``noise[k]`` when given, else drawn from
    ``generator``."""
    device = resolve_device(device)
    x = x.to(device)
    alphas = alphas_cumprod_padded(betas, device=device)
    n = x.shape[0]
    for k, (i, j) in enumerate(_seq_pairs(seq)):
        with span(STEP):
            t = torch.full((n,), float(i), dtype=torch.float32, device=device)
            at, atm1 = alphas[i + 1], alphas[j + 1]
            beta_t = 1.0 - at / atm1
            e = model_fn(x, t)
            x0 = torch.clamp(torch.sqrt(1.0 / at) * x - torch.sqrt(1.0 / at - 1.0) * e,
                             -1.0, 1.0)
            mean = (torch.sqrt(atm1) * beta_t * x0 +
                    torch.sqrt(1.0 - beta_t) * (1.0 - atm1) * x) / (1.0 - at)
            z = (noise[k] if noise is not None else
                 spatial.draw(torch.randn, x.shape, generator=generator, device=device,
                           dtype=x.dtype))
            mask = float(i != 0)
            x = mean + mask * torch.exp(0.5 * torch.log(beta_t)) * z
    return x
