"""The samplers of the benchmark's tasks in plain PyTorch, found by the
name a traffic mix gives (``SAMPLERS``): DDIM (Song et al. 2021, the
reference's ``generalized_steps`` and ``p_sample_ddim``) and PLMS (Liu et
al. 2022, ``plms.py``), each over a schedule of steps
``(t, alpha_bar_t, alpha_bar_prev)`` in sampling order: the pixel DDPM's
linear betas on a DDIM grid (``pixel_steps``) or the latent models'
``linear`` schedule (``ldm_steps``).

Each loop takes ``eps(x, t)``; the benchmark's check hands it the
program's recorded UNet outputs (guided, where the mix is), so a replay
follows the program's own trajectory and tests the update arithmetic
alone.  At ``eta`` above 0 it takes step k's noise as ``noise[k]``, the
same that the benchmark handed the program.  ``dtype`` is the
arithmetic's type (float32; the control runs bfloat16)."""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


def quad_sequence(steps: int, num_timesteps: int) -> np.ndarray:
    seq = np.linspace(0, np.sqrt(num_timesteps * 0.8), steps) ** 2
    return np.array([int(s) for s in seq], dtype=np.int64)


def uniform_sequence(steps: int, num_timesteps: int) -> np.ndarray:
    return np.arange(0, num_timesteps, num_timesteps // steps, dtype=np.int64)


GRIDS = {"quad": quad_sequence, "uniform": uniform_sequence}


def linear_betas(start: float, end: float, n: int) -> np.ndarray:
    return np.linspace(start, end, n, dtype=np.float64).astype(np.float32)


def pixel_steps(betas, seq, device) -> list:
    """The pixel DDPM's steps over the ascending grid ``seq``: alpha_bar
    of t and of the next lower grid point (1 past the last)."""
    a = torch.cat([torch.ones(1, device=device),
                   torch.cumprod(1.0 - torch.as_tensor(betas, device=device), 0)])
    nxt = np.concatenate([[-1], seq[:-1]])
    return [(i, a[i + 1], a[j + 1]) for i, j in zip(seq[::-1].tolist(), nxt[::-1].tolist())]


def ldm_steps(n: int, start: float, end: float, steps: int, device) -> list:
    """The latent models' ``linear`` schedule (betas = linspace(sqrt(start),
    sqrt(end))^2) on the uniform DDIM grid offset by 1."""
    betas = (np.linspace(start ** 0.5, end ** 0.5, n, dtype=np.float64) ** 2).astype(np.float32)
    ac = np.cumprod(1.0 - betas.astype(np.float64)).astype(np.float32)
    ts = np.arange(0, n, n // steps) + 1
    prev = np.concatenate([[ac[0]], ac[ts[:-1]]]).astype(np.float32)
    f = lambda v: torch.tensor(float(v), dtype=torch.float32, device=device)
    return [(int(ts[k]), f(ac[ts[k]]), f(prev[k])) for k in reversed(range(len(ts)))]


def guide(e, scale: float):
    """Classifier-free guidance of one call's output on [uncond; cond] rows."""
    e_u, e_c = e.chunk(2)
    return e_u + scale * (e_c - e_u)


def _update(x, e, a, ap, eta, z):
    """x_prev from x and eps at alpha_bar ``a``, to ``ap``, with
    sigma = eta sqrt((1 - ap) / (1 - a) (1 - a / ap)) times ``z``."""
    x0 = (x - torch.sqrt(1.0 - a) * e) / torch.sqrt(a)
    if z is None:
        return torch.sqrt(ap) * x0 + torch.sqrt(1.0 - ap) * e
    sigma = eta * torch.sqrt((1.0 - ap) / (1.0 - a) * (1.0 - a / ap))
    return torch.sqrt(ap) * x0 + torch.sqrt(1.0 - ap - sigma ** 2) * e + sigma * z.to(x.dtype)


def ddim(x, steps, eps, dtype=torch.float32, eta: float = 0.0, noise=None):
    """DDIM from x_T over ``steps``."""
    x = x.to(dtype)
    for k, (t, a, ap) in enumerate(steps):
        e = eps(x, t).to(dtype)
        x = _update(x, e, a.to(dtype), ap.to(dtype), eta, noise[k] if eta else None)
    return x


def plms(x, steps, eps, dtype=torch.float32, eta: float = 0.0, noise=None):
    """PLMS: the pseudo improved-Euler first step (a second call at the
    next timestep, on the update's x, the step's noise shared), then
    Adams-Bashforth of orders 2, 3 and 4."""
    x = x.to(dtype)
    old = []
    for i, (t, a, ap) in enumerate(steps):
        a, ap = a.to(dtype), ap.to(dtype)
        z = noise[i] if eta else None
        e = eps(x, t).to(dtype)
        if i == 0:
            t_next = steps[min(1, len(steps) - 1)][0]
            e_p = (e + eps(_update(x, e, a, ap, eta, z), t_next).to(dtype)) / 2.0
        elif i == 1:
            e_p = (3.0 * e - old[-1]) / 2.0
        elif i == 2:
            e_p = (23.0 * e - 16.0 * old[-1] + 5.0 * old[-2]) / 12.0
        else:
            e_p = (55.0 * e - 59.0 * old[-1] + 37.0 * old[-2] - 9.0 * old[-3]) / 24.0
        x = _update(x, e_p, a, ap, eta, z)
        old = (old + [e])[-3:]
    return x


class Sampler(NamedTuple):
    replay: Callable      # (x_T, steps, eps, dtype, eta, noise) -> x_0
    forwards: Callable    # steps -> the timestep of each UNet forward, in order


SAMPLERS = {
    "ddim": Sampler(ddim, lambda steps: [t for t, _, _ in steps]),
    "plms": Sampler(plms, lambda steps: [steps[0][0], steps[min(1, len(steps) - 1)][0]]
                    + [t for t, _, _ in steps[1:]]),
}
