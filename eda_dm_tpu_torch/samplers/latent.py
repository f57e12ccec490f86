"""Latent-diffusion DDIM and PLMS (port of ``eda_dm_tpu/samplers/latent.py``:
the schedules, classifier-free guidance, the DDIM loop and the PLMS loop).

The JAX ``lax.scan`` is a Python step loop here.  Noise comes from an
explicit ``torch.Generator`` or is passed in per step: JAX's PRNG and
torch's give different numbers from one seed.  A step whose σ is 0 adds no
noise and draws none.  On a batch sharded over ranks (``parallel/dp.py``)
each rank draws the global batch's noise and keeps its rows
(``parallel/rows.py``), as one process would draw it; on a height sharded
over ranks (``parallel/spatial.py``), the global height and its rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..parallel import spatial
from ..utils.run import span
from .ddim import STEP


def make_beta_schedule(n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2) -> np.ndarray:
    """The ``linear`` schedule of ldm/modules/diffusionmodules/util.py:20-43
    (float64 → float32), the one the ported tasks use."""
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                        dtype=np.float64) ** 2
    return betas.astype(np.float32)


@dataclasses.dataclass
class LDMSchedule:
    """DDIM sub-schedule buffers (float32 numpy)."""
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    ddim_timesteps: np.ndarray         # ascending, +1 offset applied
    ddim_alphas: np.ndarray
    ddim_alphas_prev: np.ndarray
    ddim_sigmas: np.ndarray
    ddim_sqrt_one_minus_alphas: np.ndarray

    @property
    def num_steps(self) -> int:
        return len(self.ddim_timesteps)


def make_ldm_schedule(num_timesteps: int = 1000, linear_start: float = 0.0015,
                      linear_end: float = 0.0195, ddim_steps: int = 200,
                      eta: float = 0.0) -> LDMSchedule:
    """make_ddim_timesteps + make_ddim_sampling_parameters
    (ldm/modules/diffusionmodules/util.py:46-75) on the linear schedule
    with the uniform DDIM grid."""
    betas = make_beta_schedule(num_timesteps, linear_start=linear_start,
                               linear_end=linear_end)
    alphas_cumprod = np.cumprod(1.0 - betas.astype(np.float64)).astype(
        np.float32)
    dt = np.arange(0, num_timesteps, num_timesteps // ddim_steps) + 1
    al = alphas_cumprod[dt]
    al_prev = np.concatenate([[alphas_cumprod[0]], alphas_cumprod[dt[:-1]]])
    sigmas = eta * np.sqrt((1 - al_prev) / (1 - al) * (1 - al / al_prev))
    return LDMSchedule(
        betas=betas, alphas_cumprod=alphas_cumprod,
        ddim_timesteps=dt.astype(np.int32),
        ddim_alphas=al.astype(np.float32),
        ddim_alphas_prev=al_prev.astype(np.float32),
        ddim_sigmas=sigmas.astype(np.float32),
        ddim_sqrt_one_minus_alphas=np.sqrt(1.0 - al).astype(np.float32))


def cfg_model_fn(apply_fn: Callable, cond, uncond, scale: float) -> Callable:
    """Classifier-free guidance: one doubled-batch call,
    eps = e_uncond + scale·(e_cond − e_uncond)."""
    if uncond is None or scale == 1.0:
        return lambda x, t: apply_fn(x, t, cond)

    def fn(x, t):
        e = apply_fn(torch.cat([x, x]), torch.cat([t, t]),
                     torch.cat([uncond, cond]))
        e_uncond, e_cond = e.chunk(2)
        return e_uncond + scale * (e_cond - e_uncond)
    return fn


def ddim_update(x, e_t, a_t, a_prev, sigma_t, sqrt_one_minus_at, noise):
    """One p_sample_ddim update; returns (x_prev, pred_x0).  The schedule
    values are float32 0-d tensors; ``noise`` may be None where σ is 0."""
    pred_x0 = (x - sqrt_one_minus_at * e_t) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(1.0 - a_prev - sigma_t ** 2) * e_t
    x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt
    if noise is not None:
        x_prev = x_prev + sigma_t * noise
    return x_prev, pred_x0


def _records(ys: dict, keys) -> dict:
    """The per-step records stacked: tensors along a new first axis, the
    integer timesteps and indices as int32 numpy arrays."""
    out = {k: torch.stack(ys[k]) for k in ("x", "aux") if k in ys}
    out.update({k: np.asarray(ys[k], np.int32) for k in keys if k in ys})
    return out


@torch.no_grad()
def ldm_ddim_sample(x_T: torch.Tensor, sched: LDMSchedule, model_fn: Callable,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[Sequence[torch.Tensor]] = None,
                    device=None, record_xt: bool = False,
                    model_returns_aux: bool = False):
    """The reverse DDIM over the sub-schedule.  ``model_fn(x, t) -> eps``
    with ``t`` float32 of shape (N,); with ``model_returns_aux`` it returns
    (eps, aux) and aux is stacked per step.  ``record_xt`` stacks every
    step's input x_t (``"x"``, the calibration trajectory), its timestep
    (``"t"``) and DDIM index (``"index"``).  The noise of step k (k = 0
    first) is ``noise[k]`` when given, else drawn from ``generator``.
    Returns the final latents, or (latents, records) when either record
    is asked for."""
    device = resolve_device(device)
    x = x_T.to(device)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    al, al_prev = f32(sched.ddim_alphas), f32(sched.ddim_alphas_prev)
    sig, som = f32(sched.ddim_sigmas), f32(sched.ddim_sqrt_one_minus_alphas)
    steps = sched.ddim_timesteps[::-1]
    n = x.shape[0]
    ys: dict = {}
    for k, step in enumerate(steps.tolist()):
        with span(STEP):
            index = len(steps) - 1 - k
            t = torch.full((n,), float(step), dtype=torch.float32, device=device)
            if model_returns_aux:
                e_t, aux = model_fn(x, t)
                ys.setdefault("aux", []).append(aux)
            else:
                e_t = model_fn(x, t)
            if record_xt:
                for key, v in (("x", x), ("t", step), ("index", index)):
                    ys.setdefault(key, []).append(v)
            z = None
            if sched.ddim_sigmas[index] != 0:
                z = (noise[k].to(device) if noise is not None else
                     spatial.draw(torch.randn, x.shape, generator=generator,
                               device=device, dtype=x.dtype))
            x, _ = ddim_update(x, e_t, al[index], al_prev[index], sig[index],
                               som[index], z)
    if not (record_xt or model_returns_aux):
        return x
    return x, _records(ys, ("t", "index"))


@torch.no_grad()
def ldm_plms_sample(x_T: torch.Tensor, sched: LDMSchedule, model_fn: Callable,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[Sequence[torch.Tensor]] = None,
                    device=None, record_xt: bool = False,
                    model_returns_aux: bool = False):
    """PLMS (plms.py:155-280): Adams-Bashforth over ε with a window of the
    last three model outputs; the first step is a pseudo improved Euler,
    which calls the model a second time, at the next timestep, on the
    DDIM update's x.  Orders 1, 2, 3, 4 at steps 0, 1, 2 and later.  The
    noise of step k is ``noise[k]`` when given, else drawn from
    ``generator`` where σ is not 0 (the order-1 step's look-ahead and its
    update share it).  The records are :func:`ldm_ddim_sample`'s, plus
    each step's next timestep (``"t_next"``); a step's aux is that of its
    first model call (the look-ahead's is dropped).  Returns the final
    latents, or (latents, records) when either record is asked for."""
    device = resolve_device(device)
    x = x_T.to(device)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    al, al_prev = f32(sched.ddim_alphas), f32(sched.ddim_alphas_prev)
    sig, som = f32(sched.ddim_sigmas), f32(sched.ddim_sqrt_one_minus_alphas)
    steps = sched.ddim_timesteps[::-1].tolist()
    n, S = x.shape[0], len(steps)
    old_eps = []                                  # newest last
    ys: dict = {}
    eps = (lambda x_, t_: model_fn(x_, t_)[0]) if model_returns_aux else model_fn
    for i, step in enumerate(steps):
        with span(STEP):
            index = S - 1 - i
            t = torch.full((n,), float(step), dtype=torch.float32, device=device)
            if model_returns_aux:
                e_t, aux = model_fn(x, t)
                ys.setdefault("aux", []).append(aux)
            else:
                e_t = model_fn(x, t)
            if record_xt:
                for key, v in (("x", x), ("t", step), ("index", index),
                               ("t_next", steps[min(i + 1, S - 1)])):
                    ys.setdefault(key, []).append(v)
            z = None
            if sched.ddim_sigmas[index] != 0:
                z = (noise[i].to(device) if noise is not None else
                     spatial.draw(torch.randn, x.shape, generator=generator,
                               device=device, dtype=x.dtype))

            def update(e):
                return ddim_update(x, e, al[index], al_prev[index], sig[index],
                                   som[index], z)[0]
            if i == 0:
                t_next = torch.full((n,), float(steps[min(1, S - 1)]),
                                    dtype=torch.float32, device=device)
                e_prime = (e_t + eps(update(e_t), t_next)) / 2.0
            elif i == 1:
                e_prime = (3.0 * e_t - old_eps[-1]) / 2.0
            elif i == 2:
                e_prime = (23.0 * e_t - 16.0 * old_eps[-1] + 5.0 * old_eps[-2]) / 12.0
            else:
                e_prime = (55.0 * e_t - 59.0 * old_eps[-1] + 37.0 * old_eps[-2]
                           - 9.0 * old_eps[-3]) / 24.0
            x = update(e_prime)
            old_eps = (old_eps + [e_t])[-3:]
    if not (record_xt or model_returns_aux):
        return x
    return x, _records(ys, ("t", "index", "t_next"))
