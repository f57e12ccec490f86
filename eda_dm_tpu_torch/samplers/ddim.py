"""Pixel-space DDIM sampling (port of ``eda_dm_tpu/samplers/ddim.py``).

The JAX package's ``lax.scan`` is a Python step loop here.  Noise comes
from an explicit ``torch.Generator`` or is passed in per step: JAX's PRNG
and torch's give different numbers from one seed.  At ``eta=0`` the noise
term is multiplied by zero, so no noise is drawn.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .schedules import alphas_cumprod_padded


def ddim_denoise_step(x, et, at, at_next, eta, noise):
    """One generalized DDIM update; returns (x_next, x0)."""
    x0 = (x - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)
    c1 = eta * torch.sqrt((1.0 - at / at_next) * (1.0 - at_next) / (1.0 - at))
    c2 = torch.sqrt((1.0 - at_next) - c1 ** 2)
    x_next = torch.sqrt(at_next) * x0
    if noise is not None:
        x_next = x_next + c1 * noise
    return x_next + c2 * et, x0


@torch.no_grad()
def generalized_steps(x: torch.Tensor, seq, model_fn: Callable, betas,
                      eta: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[Sequence[torch.Tensor]] = None,
                      device=None) -> torch.Tensor:
    """Run the reverse DDIM trajectory over the ascending timestep subset
    ``seq``.  ``model_fn(x, t) -> eps`` with ``t`` float32 of shape (N,).
    With ``eta > 0`` the per-step noise is ``noise[k]`` when given, else
    drawn from ``generator``.  Returns x_0."""
    device = resolve_device(device)
    x = x.to(device)
    alphas = alphas_cumprod_padded(betas, device=device)
    seq = np.asarray(seq)
    seq_next = np.concatenate([[-1], seq[:-1]])
    n = x.shape[0]
    for k, (i, j) in enumerate(zip(seq[::-1].tolist(), seq_next[::-1].tolist())):
        t = torch.full((n,), float(i), dtype=torch.float32, device=device)
        et = model_fn(x, t)
        z = None
        if eta != 0.0:
            z = (noise[k] if noise is not None else
                 torch.randn(x.shape, generator=generator, device=device,
                             dtype=x.dtype))
        x, _ = ddim_denoise_step(x, et, alphas[i + 1], alphas[j + 1], eta, z)
    return x
