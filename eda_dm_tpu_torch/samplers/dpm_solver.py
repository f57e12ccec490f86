"""DPM-Solver / DPM-Solver++ (port of ``eda_dm_tpu/samplers/dpm_solver.py``):
multistep (orders 1–3), singlestep and adaptive sampling.

As in the JAX package, the time grid is static: every per-step scalar of
the multistep and singlestep solvers (the schedule's log α, σ, λ and the
φ coefficients) is computed on the host in numpy float64 and cast to
float32 where JAX casts it, so a step is one model evaluation and a linear
combination of float32 tensors, with no readback.  The order of each step
is known on the host, so the loop picks its update in Python where JAX
switches on the device.

Scalar arithmetic follows the JAX expressions operation for operation:
a numpy scalar times a tensor multiplies by the scalar rounded to float32,
in PyTorch as in JAX (which has no float64 here), so the host scalars are
the same numpy expressions and the tensor adds come in JAX's order.

The adaptive solver computes its schedule lookups in float32 tensors as
JAX's ``_jnp_schedule`` does on the device (``interp_f32`` is
``jnp.interp``'s formula), and takes or rejects a step with
``torch.where`` on the device; its stop test (λ_s against λ_0) reads one
scalar back to the host once a step, where JAX's ``lax.while_loop``
decides on the device.  Its error estimate E is the norm of the
difference of two close solutions, so a last-bit difference between
XLA's and PyTorch's ``exp`` / ``expm1`` / ``log`` moves E, and through
the step size every later step, by far more than a bit: a free run is
held against JAX's step by step (``tests/test_torch_dpm_solver.py``).
On a height sharded over ranks (``parallel/spatial.py``) the updates are
elementwise on each rank's rows and E's mean is taken over all of them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..parallel import spatial


class NoiseScheduleVP:
    """The forward SDE's (VP) schedule, host-side numpy: ``'discrete'``
    interpolates log(alpha) over the training grid; ``'linear'`` and
    ``'cosine'`` are closed-form."""

    def __init__(self, schedule: str = "discrete",
                 betas: Optional[np.ndarray] = None,
                 alphas_cumprod: Optional[np.ndarray] = None,
                 continuous_beta_0: float = 0.1,
                 continuous_beta_1: float = 20.0):
        self.schedule = schedule
        if schedule == "discrete":
            if betas is not None:
                log_alphas = 0.5 * np.cumsum(np.log(1.0 - np.asarray(
                    betas, np.float64)))
            else:
                log_alphas = 0.5 * np.log(np.asarray(alphas_cumprod,
                                                     np.float64))
            self.total_N = len(log_alphas)
            self.T = 1.0
            self.t_array = np.linspace(0.0, 1.0, self.total_N + 1)[1:]
            self.log_alpha_array = log_alphas
        elif schedule in ("linear", "cosine"):
            self.total_N = 1000
            self.T = 1.0 if schedule == "linear" else 0.9946
            self.beta_0 = continuous_beta_0
            self.beta_1 = continuous_beta_1
            self.cosine_s = 0.008
            self.cosine_log_alpha_0 = math.log(
                math.cos(self.cosine_s / (1.0 + self.cosine_s) * math.pi / 2))
        else:
            raise ValueError(schedule)

    def marginal_log_mean_coeff(self, t: np.ndarray) -> np.ndarray:
        t = np.asarray(t, np.float64)
        if self.schedule == "discrete":
            return np.interp(t, self.t_array, self.log_alpha_array)
        if self.schedule == "linear":
            return -0.25 * t ** 2 * (self.beta_1 - self.beta_0) \
                - 0.5 * t * self.beta_0
        return np.log(np.cos((t + self.cosine_s) / (1.0 + self.cosine_s)
                             * math.pi / 2)) - self.cosine_log_alpha_0

    def marginal_alpha(self, t):
        return np.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return np.sqrt(1.0 - np.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        log_a = self.marginal_log_mean_coeff(t)
        return log_a - 0.5 * np.log(1.0 - np.exp(2.0 * log_a))

    def inverse_lambda(self, lamb: np.ndarray) -> np.ndarray:
        lamb = np.asarray(lamb, np.float64)
        if self.schedule == "discrete":
            log_alpha = -0.5 * np.logaddexp(0.0, -2.0 * lamb)
            return np.interp(log_alpha, self.log_alpha_array[::-1],
                             self.t_array[::-1])
        if self.schedule == "linear":
            tmp = 2.0 * (self.beta_1 - self.beta_0) * np.logaddexp(
                -2.0 * lamb, 0.0)
            delta = self.beta_0 ** 2 + tmp
            return tmp / (np.sqrt(delta) + self.beta_0) / (self.beta_1
                                                           - self.beta_0)
        log_alpha = -0.5 * np.logaddexp(-2.0 * lamb, 0.0)
        return np.arccos(np.exp(log_alpha + self.cosine_log_alpha_0)) \
            * 2.0 * (1.0 + self.cosine_s) / math.pi - self.cosine_s


def dpm_time_steps(ns: NoiseScheduleVP, skip_type: str, t_T: float,
                   t_0: float, N: int) -> np.ndarray:
    """The intermediate time grid: uniform in logSNR, in time, or in √t."""
    if skip_type == "logSNR":
        lam = np.linspace(ns.marginal_lambda(t_T), ns.marginal_lambda(t_0),
                          N + 1)
        return ns.inverse_lambda(lam)
    if skip_type == "time_uniform":
        return np.linspace(t_T, t_0, N + 1)
    if skip_type == "time_quadratic":
        return np.linspace(t_T ** 0.5, t_0 ** 0.5, N + 1) ** 2
    raise ValueError(skip_type)


def model_input_time(ns: NoiseScheduleVP, t: np.ndarray) -> np.ndarray:
    """Continuous time → the discrete model's input: t in [1/N, 1] →
    1000 · (t − 1/N)."""
    if ns.schedule == "discrete":
        return (t - 1.0 / ns.total_N) * 1000.0
    return t


@dataclasses.dataclass
class _StepCoeffs:
    """The multistep updates' per-step scalars."""
    order: np.ndarray          # (steps,) int32
    t_model: np.ndarray        # (steps,) model-input time at the NEW point
    ratio: np.ndarray          # sigma_t/sigma_prev (++) or exp(dlog_alpha)
    c1: np.ndarray             # first-order coefficient (alpha_t*phi1 or sigma_t*phi1)
    c2: np.ndarray             # second-order D1 coefficient
    c3_1: np.ndarray           # third-order D1 coefficient
    c3_2: np.ndarray           # third-order D2 coefficient
    r0: np.ndarray             # h_0 / h
    r1: np.ndarray             # h_1 / h


def _build_coeffs(ns: NoiseScheduleVP, ts: np.ndarray, order: int,
                  algorithm_type: str, solver_type: str,
                  lower_order_final: bool) -> _StepCoeffs:
    steps = len(ts) - 1
    lam = ns.marginal_lambda(ts)
    log_a = ns.marginal_log_mean_coeff(ts)
    sigma = ns.marginal_std(ts)
    alpha = np.exp(log_a)

    orders = np.zeros(steps, np.int32)
    ratio = np.zeros(steps)
    c1 = np.zeros(steps)
    c2 = np.zeros(steps)
    c31 = np.zeros(steps)
    c32 = np.zeros(steps)
    r0 = np.ones(steps)
    r1 = np.ones(steps)
    for i in range(1, steps + 1):
        # warm-up with increasing order, a lower order at the tail of a
        # short run
        o = min(i, order)
        if lower_order_final and steps < 15:
            o = min(o, steps + 1 - i)
        orders[i - 1] = o
        h = lam[i] - lam[i - 1]
        if i >= 2:
            r0[i - 1] = (lam[i - 1] - lam[i - 2]) / h
        if i >= 3:
            r1[i - 1] = (lam[i - 2] - lam[i - 3]) / h
        if algorithm_type == "dpmsolver++":
            phi1 = np.expm1(-h)
            phi2 = phi1 / h + 1.0
            phi3 = phi2 / h - 0.5
            ratio[i - 1] = sigma[i] / sigma[i - 1]
            c1[i - 1] = -alpha[i] * phi1
            c2[i - 1] = (-0.5 * alpha[i] * phi1 if solver_type == "dpmsolver"
                         else alpha[i] * phi2)
            c31[i - 1] = alpha[i] * phi2
            c32[i - 1] = -alpha[i] * phi3
        else:
            phi1 = np.expm1(h)
            phi2 = phi1 / h - 1.0
            phi3 = phi2 / h - 0.5
            ratio[i - 1] = np.exp(log_a[i] - log_a[i - 1])
            c1[i - 1] = -sigma[i] * phi1
            c2[i - 1] = (-0.5 * sigma[i] * phi1 if solver_type == "dpmsolver"
                         else -sigma[i] * phi2)
            c31[i - 1] = -sigma[i] * phi2
            c32[i - 1] = -sigma[i] * phi3
    t_model = model_input_time(ns, ts)
    f32 = lambda a: np.asarray(a, np.float32)
    return _StepCoeffs(orders, f32(t_model[1:]), f32(ratio), f32(c1),
                       f32(c2), f32(c31), f32(c32), f32(r0), f32(r1))


def _t_rows(x: torch.Tensor, t) -> torch.Tensor:
    """The model's time input: one float32 value a row."""
    return torch.full((x.shape[0],), float(np.float32(t)), dtype=torch.float32,
                      device=x.device)


def dpm_solver_sample(x: torch.Tensor, model_fn: Callable,
                      ns: NoiseScheduleVP, steps: int = 20, order: int = 3,
                      skip_type: str = "time_uniform",
                      algorithm_type: str = "dpmsolver++",
                      solver_type: str = "dpmsolver",
                      lower_order_final: bool = True,
                      t_start: Optional[float] = None,
                      t_end: Optional[float] = None,
                      denoise_to_zero: bool = False) -> torch.Tensor:
    """Multistep DPM-Solver sampling.  ``model_fn(x, t_model_input)`` → eps
    (guidance folded in).  One model evaluation a step (none after the
    last update); the update of each step's order from the host's float32
    coefficients."""
    t_0 = (1.0 / ns.total_N) if t_end is None else t_end
    t_T = ns.T if t_start is None else t_start
    ts = dpm_time_steps(ns, skip_type, t_T, t_0, steps)
    co = _build_coeffs(ns, ts, order, algorithm_type, solver_type,
                       lower_order_final)
    sig = np.asarray(ns.marginal_std(ts), np.float32)
    alp = np.asarray(ns.marginal_alpha(ts), np.float32)

    def F(xv, t_model, sigma_t, alpha_t):
        """The solver's model function: eps (dpmsolver) or x0
        (dpmsolver++)."""
        eps = model_fn(xv, _t_rows(xv, t_model))
        if algorithm_type == "dpmsolver++":
            return (xv - float(sigma_t) * eps) / float(alpha_t)
        return eps

    m_new = F(x, np.float32(model_input_time(ns, ts[0])),
              np.float32(ns.marginal_std(ts[0])),
              np.float32(ns.marginal_alpha(ts[0])))
    buf = [m_new, m_new, m_new]                 # [-3, -2, -1], newest last
    for i in range(steps):
        m2, m1, m0 = buf
        ratio, c1 = float(co.ratio[i]), float(co.c1[i])
        o = int(co.order[i])
        if o == 1:
            x = ratio * x + c1 * m0
        elif o == 2:
            D1_0 = (m0 - m1) / float(co.r0[i])
            x = ratio * x + c1 * m0 + float(co.c2[i]) * D1_0
        else:
            rr0, rr1 = co.r0[i], co.r1[i]       # float32 scalar arithmetic
            D1_0 = (m0 - m1) / float(rr0)
            D1_1 = (m1 - m2) / float(rr1)
            D1 = D1_0 + float(rr0 / (rr0 + rr1)) * (D1_0 - D1_1)
            D2 = (D1_0 - D1_1) / float(rr0 + rr1)
            x = (ratio * x + c1 * m0 + float(co.c3_1[i]) * D1
                 + float(co.c3_2[i]) * D2)
        if i < steps - 1:
            m_new = F(x, co.t_model[i], sig[i + 1], alp[i + 1])
        else:
            m_new = m0
        buf = [m1, m0, m_new]

    if denoise_to_zero:
        # the final x0 projection at t_0
        eps = model_fn(x, _t_rows(x, float(model_input_time(ns, t_0))))
        s = np.float32(ns.marginal_std(t_0))
        a = np.float32(ns.marginal_alpha(t_0))
        x = (x - float(s) * eps) / float(a)
    return x


# --------------------------------------------------------------------------
# singlestep method
# --------------------------------------------------------------------------

def _singlestep_orders(steps: int, order: int):
    """The orders of the singlestep blocks (their sum is ``steps``)."""
    if order == 3:
        k = steps // 3 + 1
        if steps % 3 == 0:
            orders = [3] * (k - 2) + [2, 1]
        elif steps % 3 == 1:
            orders = [3] * (k - 1) + [1]
        else:
            orders = [3] * (k - 1) + [2]
    elif order == 2:
        if steps % 2 == 0:
            orders = [2] * (steps // 2)
        else:
            orders = [2] * (steps // 2) + [1]
    elif order == 1:
        orders = [1] * steps
    else:
        raise ValueError(order)
    return orders


def dpm_solver_sample_singlestep(x: torch.Tensor, model_fn: Callable,
                                 ns: NoiseScheduleVP, steps: int = 20,
                                 order: int = 3,
                                 skip_type: str = "time_uniform",
                                 algorithm_type: str = "dpmsolver++",
                                 solver_type: str = "dpmsolver",
                                 t_start: Optional[float] = None,
                                 t_end: Optional[float] = None) -> torch.Tensor:
    """Singlestep DPM-Solver: the trajectory in blocks of up to ``order``
    model evaluations, each block one order-k update with intermediate
    points at r1 (1/2 or 1/3) and r2 (2/3) of its logSNR span.  Every
    coefficient is a host numpy scalar (the JAX expressions as they are);
    a numpy scalar times a tensor multiplies by its float32 rounding."""
    t_0 = (1.0 / ns.total_N) if t_end is None else t_end
    t_T = ns.T if t_start is None else t_start
    orders = _singlestep_orders(steps, order)
    K = len(orders)
    if skip_type == "logSNR":
        ts_outer = dpm_time_steps(ns, skip_type, t_T, t_0, K)
    else:
        ts_full = dpm_time_steps(ns, skip_type, t_T, t_0, steps)
        ts_outer = ts_full[np.cumsum([0] + orders)]

    f32 = lambda v: float(np.float32(v))
    pp = algorithm_type == "dpmsolver++"

    def eval_model(xv, t_cont):
        t_m = float(model_input_time(ns, np.float64(t_cont)))
        eps = model_fn(xv, _t_rows(xv, t_m))
        if pp:
            return (xv - f32(sig(t_cont)) * eps) / f32(alp(t_cont))
        return eps

    lam = lambda t: float(ns.marginal_lambda(t))
    sig = lambda t: np.float32(ns.marginal_std(t))
    alp = lambda t: np.float32(ns.marginal_alpha(t))
    loga = lambda t: float(ns.marginal_log_mean_coeff(t))
    inv = lambda l: float(ns.inverse_lambda(l))

    for i, o in enumerate(orders):
        s, t = float(ts_outer[i]), float(ts_outer[i + 1])
        h = lam(t) - lam(s)
        m_s = eval_model(x, s)
        if o == 1:
            if pp:
                x = f32(sig(t) / sig(s)) * x - f32(alp(t) * np.expm1(-h)) * m_s
            else:
                x = f32(np.exp(loga(t) - loga(s))) * x \
                    - f32(sig(t) * np.expm1(h)) * m_s
        elif o == 2:
            r1 = 0.5
            s1 = inv(lam(s) + r1 * h)
            if pp:
                x_s1 = f32(sig(s1) / sig(s)) * x \
                    - f32(alp(s1) * np.expm1(-r1 * h)) * m_s
                m_s1 = eval_model(x_s1, s1)
                phi1 = np.expm1(-h)
                base = f32(sig(t) / sig(s)) * x - f32(alp(t) * phi1) * m_s
                if solver_type == "dpmsolver":
                    x = base - f32((0.5 / r1) * alp(t) * phi1) * (m_s1 - m_s)
                else:                          # taylor
                    phi2 = phi1 / h + 1.0
                    x = base + f32((1.0 / r1) * alp(t) * phi2) * (m_s1 - m_s)
            else:
                x_s1 = f32(np.exp(loga(s1) - loga(s))) * x \
                    - f32(sig(s1) * np.expm1(r1 * h)) * m_s
                m_s1 = eval_model(x_s1, s1)
                phi1 = np.expm1(h)
                base = f32(np.exp(loga(t) - loga(s))) * x - f32(sig(t) * phi1) * m_s
                if solver_type == "dpmsolver":
                    x = base - f32((0.5 / r1) * sig(t) * phi1) * (m_s1 - m_s)
                else:
                    phi2 = phi1 / h - 1.0
                    x = base - f32((1.0 / r1) * sig(t) * phi2) * (m_s1 - m_s)
        else:
            r1, r2 = 1.0 / 3.0, 2.0 / 3.0
            s1 = inv(lam(s) + r1 * h)
            s2 = inv(lam(s) + r2 * h)
            if pp:
                phi11 = np.expm1(-r1 * h)
                phi12 = np.expm1(-r2 * h)
                phi1 = np.expm1(-h)
                phi22 = np.expm1(-r2 * h) / (r2 * h) + 1.0
                phi2 = phi1 / h + 1.0
                phi3 = phi2 / h - 0.5
                x_s1 = f32(sig(s1) / sig(s)) * x - f32(alp(s1) * phi11) * m_s
                m_s1 = eval_model(x_s1, s1)
                x_s2 = f32(sig(s2) / sig(s)) * x - f32(alp(s2) * phi12) * m_s \
                    + f32(r2 / r1 * alp(s2) * phi22) * (m_s1 - m_s)
                m_s2 = eval_model(x_s2, s2)
                base = f32(sig(t) / sig(s)) * x - f32(alp(t) * phi1) * m_s
                if solver_type == "dpmsolver":
                    x = base + f32((1.0 / r2) * alp(t) * phi2) * (m_s2 - m_s)
                else:
                    D1_0 = f32(1.0 / r1) * (m_s1 - m_s)
                    D1_1 = f32(1.0 / r2) * (m_s2 - m_s)
                    D1 = (f32(r2) * D1_0 - f32(r1) * D1_1) / f32(r2 - r1)
                    D2 = f32(2.0) * (D1_1 - D1_0) / f32(r2 - r1)
                    x = base + f32(alp(t) * phi2) * D1 - f32(alp(t) * phi3) * D2
            else:
                phi11 = np.expm1(r1 * h)
                phi12 = np.expm1(r2 * h)
                phi1 = np.expm1(h)
                phi22 = np.expm1(r2 * h) / (r2 * h) - 1.0
                phi2 = phi1 / h - 1.0
                phi3 = phi2 / h - 0.5
                x_s1 = f32(np.exp(loga(s1) - loga(s))) * x \
                    - f32(sig(s1) * phi11) * m_s
                m_s1 = eval_model(x_s1, s1)
                x_s2 = f32(np.exp(loga(s2) - loga(s))) * x \
                    - f32(sig(s2) * phi12) * m_s \
                    - f32(r2 / r1 * sig(s2) * phi22) * (m_s1 - m_s)
                m_s2 = eval_model(x_s2, s2)
                base = f32(np.exp(loga(t) - loga(s))) * x - f32(sig(t) * phi1) * m_s
                if solver_type == "dpmsolver":
                    x = base - f32((1.0 / r2) * sig(t) * phi2) * (m_s2 - m_s)
                else:
                    D1_0 = f32(1.0 / r1) * (m_s1 - m_s)
                    D1_1 = f32(1.0 / r2) * (m_s2 - m_s)
                    D1 = (f32(r2) * D1_0 - f32(r1) * D1_1) / f32(r2 - r1)
                    D2 = f32(2.0) * (D1_1 - D1_0) / f32(r2 - r1)
                    x = base - f32(sig(t) * phi2) * D1 - f32(sig(t) * phi3) * D2
    return x


# --------------------------------------------------------------------------
# adaptive method
# --------------------------------------------------------------------------

def interp_f32(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` in float32 tensors: the segment by a right-sided
    search, ``fp[i-1] + (x - xp[i-1]) / dx · df``, clamped to the ends."""
    i = torch.clamp(torch.searchsorted(xp, x.reshape(1), right=True), 1,
                    xp.numel() - 1)[0]
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _torch_schedule(ns: NoiseScheduleVP, device):
    """The schedule's functions on float32 0-d tensors on ``device``, as the
    JAX adaptive solver computes them on its device."""
    if ns.schedule == "discrete":
        t_arr = torch.tensor(ns.t_array, dtype=torch.float32, device=device)
        la_arr = torch.tensor(ns.log_alpha_array, dtype=torch.float32,
                              device=device)
        t_rev, la_rev = t_arr.flip(0), la_arr.flip(0)

        def log_mean(t):
            return interp_f32(t, t_arr, la_arr)

        def inv_lambda(l):
            log_alpha = -0.5 * torch.logaddexp(torch.zeros_like(l), -2.0 * l)
            return interp_f32(log_alpha, la_rev, t_rev)
    elif ns.schedule == "linear":
        b0, b1 = ns.beta_0, ns.beta_1

        def log_mean(t):
            return -0.25 * t ** 2 * (b1 - b0) - 0.5 * t * b0

        def inv_lambda(l):
            tmp = 2.0 * (b1 - b0) * torch.logaddexp(-2.0 * l, torch.zeros_like(l))
            delta = b0 ** 2 + tmp
            return tmp / (torch.sqrt(delta) + b0) / (b1 - b0)
    else:
        raise NotImplementedError("adaptive: cosine schedule")

    def alpha(t):
        return torch.exp(log_mean(t))

    def std(t):
        return torch.sqrt(1.0 - torch.exp(2.0 * log_mean(t)))

    def lam(t):
        la = log_mean(t)
        return la - 0.5 * torch.log(1.0 - torch.exp(2.0 * la))

    return log_mean, alpha, std, lam, inv_lambda


def adaptive_stepper(ns: NoiseScheduleVP, model_fn: Callable, order: int,
                     atol: float, rtol: float, theta: float, device):
    """The adaptive solver's step on float32 tensors on ``device``:
    ``step(x, lam_s, h, x_prev)`` → the next ``(x, lam_s, h, x_prev)``
    (unchanged but for ``h`` where the step is rejected), and ``lam_fn``
    (λ of a float32 time)."""
    log_mean, alpha, std, lam_fn, inv_lambda = _torch_schedule(ns, device)
    total_N = ns.total_N
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)

    def eval_x0(xv, t_cont):
        if ns.schedule == "discrete":
            t_m = (t_cont - 1.0 / total_N) * 1000.0
        else:
            t_m = t_cont
        eps = model_fn(xv, torch.ones(xv.shape[0], dtype=torch.float32,
                                      device=device) * t_m)
        return (xv - std(t_cont) * eps) / alpha(t_cont)

    def update1(xv, s, t, m_s):
        h = lam_fn(t) - lam_fn(s)
        return (std(t) / std(s)) * xv - alpha(t) * torch.expm1(-h) * m_s

    def update2(xv, s, t, m_s):
        r1 = 0.5
        h = lam_fn(t) - lam_fn(s)
        s1 = inv_lambda(lam_fn(s) + r1 * h)
        x_s1 = (std(s1) / std(s)) * xv - alpha(s1) * torch.expm1(-r1 * h) * m_s
        m_s1 = eval_x0(x_s1, s1)
        phi1 = torch.expm1(-h)
        return (std(t) / std(s)) * xv - alpha(t) * phi1 * m_s \
            - (0.5 / r1) * alpha(t) * phi1 * (m_s1 - m_s)

    def update3(xv, s, t, m_s, m_s1):
        r1, r2 = 1.0 / 3.0, 2.0 / 3.0
        h = lam_fn(t) - lam_fn(s)
        s2 = inv_lambda(lam_fn(s) + r2 * h)
        phi12 = torch.expm1(-r2 * h)
        phi22 = torch.expm1(-r2 * h) / (r2 * h) + 1.0
        phi1 = torch.expm1(-h)
        phi2 = phi1 / h + 1.0
        x_s2 = (std(s2) / std(s)) * xv - alpha(s2) * phi12 * m_s \
            + r2 / r1 * alpha(s2) * phi22 * (m_s1 - m_s)
        m_s2 = eval_x0(x_s2, s2)
        return (std(t) / std(s)) * xv - alpha(t) * phi1 * m_s \
            + (1.0 / r2) * alpha(t) * phi2 * (m_s2 - m_s)

    def step(x, lam_s, h, x_prev, lam_0):
        s = inv_lambda(lam_s)
        t = inv_lambda(torch.minimum(lam_s + h, lam_0))
        m_s = eval_x0(x, s)
        if order == 2:
            x_lower = update1(x, s, t, m_s)
            x_higher = update2(x, s, t, m_s)
        else:
            x_lower = update2(x, s, t, m_s)
            # the third-order update takes its own r1 = 1/3 midpoint
            r1 = 1.0 / 3.0
            hh = lam_fn(t) - lam_fn(s)
            s1b = inv_lambda(lam_fn(s) + r1 * hh)
            x_s1b = (std(s1b) / std(s)) * x \
                - alpha(s1b) * torch.expm1(-r1 * hh) * m_s
            m_s1b = eval_x0(x_s1b, s1b)
            x_higher = update3(x, s, t, m_s, m_s1b)
        delta = torch.maximum(f32(atol), rtol * torch.maximum(x_lower.abs(),
                                                              x_prev.abs()))
        E = torch.sqrt(spatial.mean(((x_higher - x_lower) / delta) ** 2))
        accept = E <= 1.0
        x = torch.where(accept, x_higher, x)
        x_prev = torch.where(accept, x_lower, x_prev)
        lam_s = torch.where(accept, lam_fn(t), lam_s)
        h = torch.minimum(theta * h * E ** (-1.0 / order), lam_0 - lam_s)
        return x, lam_s, h, x_prev

    return step, lam_fn


def dpm_solver_sample_adaptive(x: torch.Tensor, model_fn: Callable,
                               ns: NoiseScheduleVP, order: int = 2,
                               h_init: float = 0.05, atol: float = 0.0078,
                               rtol: float = 0.05, theta: float = 0.9,
                               max_steps: int = 200,
                               t_start: Optional[float] = None,
                               t_end: Optional[float] = None) -> torch.Tensor:
    """Adaptive step-size DPM-Solver++ (data prediction): order 2 pairs the
    first- and second-order singlestep updates (lower, higher), order 3 the
    second and third.  A step is accepted where the scaled error E ≤ 1; the
    next step size is θ·h·E^(−1/order), capped at what is left.  The
    schedule's scalars are float32 tensors on ``x``'s device; the stop
    test (λ_s against λ_0, and the step count) is read back once a step,
    where JAX's ``while_loop`` decides on the device."""
    if order not in (2, 3):
        raise ValueError(order)
    t_0 = (1.0 / ns.total_N) if t_end is None else t_end
    t_T = ns.T if t_start is None else t_start
    step, lam_fn = adaptive_stepper(ns, model_fn, order, atol, rtol, theta,
                                    x.device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    lam_0 = lam_fn(f32(t_0))
    lam_s, h, k, x_prev = lam_fn(f32(t_T)), f32(h_init), 0, x
    while bool(lam_s < lam_0 - 1e-5) and k < max_steps:
        x, lam_s, h, x_prev = step(x, lam_s, h, x_prev, lam_0)
        k += 1
    return x
