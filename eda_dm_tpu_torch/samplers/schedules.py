"""Diffusion noise schedules and timestep-skip sequences (port of
``eda_dm_tpu/samplers/schedules.py``).  Betas are computed in float64 and
cast, as the reference does through numpy."""

from __future__ import annotations

import numpy as np
import torch


def get_beta_schedule(beta_schedule: str, *, beta_start: float, beta_end: float,
                      num_diffusion_timesteps: int) -> np.ndarray:
    T = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, T,
                            dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(T, dtype=np.float64)
    elif beta_schedule == "jsd":          # 1/T, 1/(T-1), ..., 1
        betas = 1.0 / np.linspace(T, 1, T, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        s = np.linspace(-6, 6, T)
        betas = 1.0 / (1.0 + np.exp(-s)) * (beta_end - beta_start) + beta_start
    else:
        raise NotImplementedError(beta_schedule)
    assert betas.shape == (T,)
    return betas.astype(np.float32)


def skip_sequence(skip_type: str, timesteps: int,
                  num_diffusion_timesteps: int) -> np.ndarray:
    """DDIM timestep subset, ascending."""
    if skip_type == "uniform":
        skip = num_diffusion_timesteps // timesteps
        seq = np.arange(0, num_diffusion_timesteps, skip)
    elif skip_type == "quad":
        seq = (np.linspace(0, np.sqrt(num_diffusion_timesteps * 0.8),
                           timesteps) ** 2)
        seq = np.array([int(s) for s in seq])
    else:
        raise NotImplementedError(skip_type)
    return seq.astype(np.int32)


def alphas_cumprod_padded(betas, device=None) -> torch.Tensor:
    """cumprod(1-beta) with a leading 1 so index t+1 gives alpha-bar(t) and
    index 0 (t = -1) gives 1."""
    a = torch.cumprod(1.0 - torch.as_tensor(np.asarray(betas), dtype=torch.float32,
                                            device=device), dim=0)
    return torch.cat([torch.ones((1,), dtype=torch.float32, device=device), a])
