"""The port's DPM-Solver(++) (``samplers/dpm_solver.py``) against the JAX
package's, on the CPU.

* The schedules (``discrete`` from betas and from alphas_cumprod,
  ``linear``, ``cosine``), their inverse and every ``skip_type``'s time
  grid: numpy on both sides, equal.  The multistep coefficients
  (``_build_coeffs``) and the singlestep orders equal.
* Sampling on a toy model defined by numpy arrays (eps = tanh(x·W) scaled
  by the time, the same W on both sides): multistep at orders 1–3 with
  both algorithms and both solver types, singlestep at orders 1–3 with
  both algorithms (and the logSNR grid), each within rtol = atol = 1e-5 of
  JAX's.  The adaptive solver at orders 2 and 3: step by step on JAX's
  own carry, then run free with the accepted steps' count (the count of
  model calls) equal (``test_adaptive_matches_jax`` states the bounds).
* The tiny latent pipeline's ``sample_batch(sampler="dpm")`` (multistep
  DPM-Solver++ at order 2, 5 steps, under guidance 3.0: the tiny
  class-conditional imagenet model of ``tests/test_torch_latent_pipeline.py``
  with the port's seed-0 weights carried to JAX, class contexts from the
  port's embedder, the KL first stage), in FP from JAX's x_T: the latents
  within rtol = atol = 1e-4 of JAX's (a forward's float32 tolerance), the
  images in [0, 1] within 1e-4 of JAX's.  The quantized forwards the
  sampler calls are held against JAX in ``tests/test_torch_imagenet.py``
  and, through the int8 export, by the imagenet pipeline run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.samplers import dpm_solver as jdpm
from eda_dm_tpu.samplers.schedules import get_beta_schedule
from eda_dm_tpu_torch.samplers import dpm_solver as tdpm

BETAS = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                          num_diffusion_timesteps=100)
SCHEDULES = {
    "discrete": dict(schedule="discrete", betas=BETAS),
    "discrete_ac": dict(schedule="discrete",
                        alphas_cumprod=np.cumprod(1.0 - BETAS)),
    "linear": dict(schedule="linear"),
    "cosine": dict(schedule="cosine"),
}
W = np.random.default_rng(5).standard_normal((8, 8)).astype(np.float32) / 3.0
X = np.random.default_rng(6).standard_normal((2, 3, 8, 8)).astype(np.float32)
H_RTOL = 1e-3


def _pair(name):
    kw = SCHEDULES[name]
    return jdpm.NoiseScheduleVP(**kw), tdpm.NoiseScheduleVP(**kw)


def _jax_model(x, t):
    return jnp.tanh(x @ jnp.asarray(W)) * (1.0 + 0.001 * t.reshape(-1, 1, 1, 1))


def _port_model(x, t):
    return torch.tanh(x @ torch.from_numpy(W)) * (1.0 + 0.001 * t.reshape(-1, 1, 1, 1))


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_equal(name):
    j, p = _pair(name)
    assert (j.total_N, j.T) == (p.total_N, p.T)
    t = np.linspace(0.011, j.T, 37)
    for fn in ("marginal_log_mean_coeff", "marginal_alpha", "marginal_std",
               "marginal_lambda"):
        np.testing.assert_array_equal(getattr(p, fn)(t), getattr(j, fn)(t))
    lam = np.linspace(float(j.marginal_lambda(j.T)) + 1e-3,
                      float(j.marginal_lambda(0.011)) - 1e-3, 11)
    np.testing.assert_array_equal(p.inverse_lambda(lam), j.inverse_lambda(lam))
    np.testing.assert_array_equal(tdpm.model_input_time(p, t),
                                  jdpm.model_input_time(j, t))


@pytest.mark.parametrize("skip", ["logSNR", "time_uniform", "time_quadratic"])
@pytest.mark.parametrize("name", ["discrete", "linear"])
def test_time_steps_and_coeffs_equal(name, skip):
    j, p = _pair(name)
    ts = jdpm.dpm_time_steps(j, skip, j.T, 1.0 / j.total_N, 9)
    np.testing.assert_array_equal(tdpm.dpm_time_steps(p, skip, p.T, 1.0 / p.total_N, 9),
                                  ts)
    for order in (1, 2, 3):
        for algo in ("dpmsolver", "dpmsolver++"):
            for solver in ("dpmsolver", "taylor"):
                a = jdpm._build_coeffs(j, ts, order, algo, solver, True)
                b = tdpm._build_coeffs(p, ts, order, algo, solver, True)
                for f in dataclasses.fields(a):
                    np.testing.assert_array_equal(getattr(b, f.name),
                                                  getattr(a, f.name))
        for steps in (1, 5, 6, 7, 20):
            assert tdpm._singlestep_orders(steps, order) == \
                jdpm._singlestep_orders(steps, order)


@pytest.mark.parametrize("solver", ["dpmsolver", "taylor"])
@pytest.mark.parametrize("algo", ["dpmsolver", "dpmsolver++"])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_multistep_matches_jax(order, algo, solver):
    j, p = _pair("discrete")
    kw = dict(steps=8, order=order, algorithm_type=algo, solver_type=solver)
    ref = np.asarray(jdpm.dpm_solver_sample(jnp.asarray(X), _jax_model, j, **kw))
    out = tdpm.dpm_solver_sample(torch.from_numpy(X), _port_model, p, **kw).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_multistep_denoise_to_zero_and_long_grid():
    """``denoise_to_zero``, and 16 steps (no lower order at the tail) on
    the quadratic grid of the linear schedule."""
    j, p = _pair("linear")
    kw = dict(steps=16, order=3, skip_type="time_quadratic", denoise_to_zero=True)
    ref = np.asarray(jdpm.dpm_solver_sample(jnp.asarray(X), _jax_model, j, **kw))
    out = tdpm.dpm_solver_sample(torch.from_numpy(X), _port_model, p, **kw).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("algo,order,solver,skip", [
    ("dpmsolver++", 1, "dpmsolver", "time_uniform"),
    ("dpmsolver++", 2, "dpmsolver", "time_uniform"),
    ("dpmsolver++", 2, "taylor", "time_uniform"),
    ("dpmsolver++", 3, "dpmsolver", "time_uniform"),
    ("dpmsolver++", 3, "taylor", "logSNR"),
    ("dpmsolver", 1, "dpmsolver", "time_uniform"),
    ("dpmsolver", 2, "taylor", "time_quadratic"),
    ("dpmsolver", 3, "dpmsolver", "logSNR"),
    ("dpmsolver", 3, "taylor", "time_uniform"),
])
def test_singlestep_matches_jax(algo, order, solver, skip):
    j, p = _pair("discrete")
    kw = dict(steps=7, order=order, algorithm_type=algo, solver_type=solver,
              skip_type=skip)
    ref = np.asarray(jdpm.dpm_solver_sample_singlestep(jnp.asarray(X), _jax_model, j,
                                                       **kw))
    out = tdpm.dpm_solver_sample_singlestep(torch.from_numpy(X), _port_model, p,
                                            **kw).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def _jax_adaptive_steps(order, model, monkeypatch):
    """JAX's adaptive solver with its ``lax.while_loop`` run as a Python
    loop (op by op): the output and the carry (x, λ_s, h, step, x_prev)
    before every step."""
    carries = []

    def while_loop(cond, body, carry):
        while bool(cond(carry)):
            carries.append(jax.tree.map(np.asarray, carry))
            carry = body(carry)
        return carry
    with monkeypatch.context() as m:
        m.setattr(jax.lax, "while_loop", while_loop)
        out = jdpm.dpm_solver_sample_adaptive(jnp.asarray(X), model,
                                              _pair("discrete")[0], order=order)
    return np.asarray(out), carries


@pytest.mark.parametrize("order", [2, 3])
def test_adaptive_matches_jax(order, monkeypatch):
    """Step by step on JAX's own carry: the port's step (``adaptive_stepper``)
    from each of JAX's states gives JAX's next x, x_prev and λ_s within
    rtol = atol = 1e-5, and its next step size within rel ``H_RTOL`` =
    1e-3.  The step size is θ·h·E^(−1/order), and E is the norm of the
    difference of the two solutions, here about 1e-4 of their size at
    order 3: one last bit of a schedule scalar (XLA's float32 ``exp``,
    ``expm1`` and ``log`` are not PyTorch's; 10–25 % of their results
    differ in the last bit) moves E by ~1e-4 relative (measured 9.6e-5 at
    order 3, 7e-7 at order 2).  Run free: the model's input times give
    each package's steps, and the counts of model calls are equal (the
    accept decisions agree).  The output is within 1e-5 of JAX's where
    the two runs' times agree within 1e-5; where the step sizes parted,
    within 1e-4 of the output's largest magnitude (order 3 measured
    1.7e-5 of it), with JAX's own drift between its compiled and its
    op-by-op run printed beside it."""
    j, p = _pair("discrete")
    jt, pt = [], []

    def jax_model(x, t):
        jax.debug.callback(lambda v: jt.append(float(v)), t[0], ordered=True)
        return _jax_model(x, t)

    def port_model(x, t):
        pt.append(float(t[0]))
        return _port_model(x, t)

    ref = np.asarray(jdpm.dpm_solver_sample_adaptive(jnp.asarray(X), jax_model, j,
                                                     order=order))
    jax.effects_barrier()
    eager, carries = _jax_adaptive_steps(order, _jax_model, monkeypatch)
    step, lam_fn = tdpm.adaptive_stepper(p, _port_model, order, 0.0078, 0.05, 0.9,
                                         torch.device("cpu"))
    lam_0 = lam_fn(torch.tensor(1.0 / p.total_N))
    T = lambda a: torch.from_numpy(np.array(a))
    dh = 0.0
    for k in range(len(carries) - 1):
        x, lam_s, h, _, x_prev = carries[k]
        got = step(T(x), T(lam_s), T(h), T(x_prev), lam_0)
        want = carries[k + 1]
        for g, w, what in zip(got, (want[0], want[1], want[2], want[4]),
                              ("x", "lam_s", "h", "x_prev")):
            tol = H_RTOL if what == "h" else 1e-5
            np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=1e-5,
                                       err_msg=f"step {k}: {what}")
        dh = max(dh, abs(float(got[2]) - float(want[2])) / abs(float(want[2])))
    out = tdpm.dpm_solver_sample_adaptive(torch.from_numpy(X), port_model, p,
                                          order=order).numpy()
    d, own = np.abs(out - ref), np.abs(eager - ref)
    print(f"\n  adaptive order {order}: {len(carries)} steps, {len(pt)} model calls "
          f"(JAX {len(jt)}); free run max |d| {d.max():.3g} mean {d.mean():.3g}; "
          f"JAX op by op vs compiled: max {own.max():.3g} mean {own.mean():.3g}; "
          f"step size on JAX's carry: rel {dh:.3g}")
    assert len(pt) == len(jt) and len(carries) > 3
    if np.allclose(pt, jt, rtol=1e-5, atol=1e-5):
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    else:
        assert d.max() <= 1e-4 * np.abs(ref).max(), d.max()


def test_interp_f32_matches_jnp():
    xp = np.linspace(0.01, 1.0, 100).astype(np.float32)
    fp = np.cumsum(np.log1p(-BETAS)).astype(np.float32)
    for v in (0.0, 0.01, 0.0137, 0.5, 0.9999, 1.0, 1.5):
        ref = np.asarray(jnp.interp(jnp.float32(v), jnp.asarray(xp), jnp.asarray(fp)))
        got = tdpm.interp_f32(torch.tensor(v, dtype=torch.float32),
                              torch.from_numpy(xp), torch.from_numpy(fp))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_pipeline_sample_batch_dpm_matches_jax():
    from eda_dm_tpu.models import latent_diffusion as jld
    from eda_dm_tpu.models import ldm_unet as jldm
    from eda_dm_tpu.models import vae as jvae
    from eda_dm_tpu.pipelines import latent as jlatent
    from eda_dm_tpu.quant import FP as JFP
    from eda_dm_tpu_torch.models import latent_diffusion as tld
    from eda_dm_tpu_torch.models import ldm_unet as tldm
    from eda_dm_tpu_torch.models import vae as tvae
    from eda_dm_tpu_torch.models.bridge import to_jax_variables
    from eda_dm_tpu_torch.pipelines import latent as tlatent
    from eda_dm_tpu_torch.quant import FP
    from test_torch_latent_pipeline import KL, SCHED, UNET

    knobs = dict(custom_steps=5, sampler="dpm", batch_size=2)
    tpipe = tlatent.LDMPipeline(
        tlatent.task_config("imagenet", **knobs),
        tld.LatentDiffusionConfig(unet=tldm.LDMUNetConfig(**UNET["imagenet"]),
                                  vae=tvae.VAEConfig(**KL), **SCHED["imagenet"]),
        device="cpu")
    jpipe = jlatent.LDMPipeline(
        jlatent.task_config("imagenet", **knobs),
        model_cfg=jld.LatentDiffusionConfig(unet=jldm.LDMUNetConfig(**UNET["imagenet"]),
                                            vae=jvae.VAEConfig(**KL), **SCHED["imagenet"]))
    v = {"unet": to_jax_variables(tpipe.ld.unet),
         "first_stage": to_jax_variables(tpipe.ld.first_stage)}
    labels, uncond = tlatent.imagenet_labels(2, 0)
    ctx, unc = (tpipe.ld.get_learned_conditioning(a) for a in (labels, uncond))
    key = jax.random.PRNGKey(9)
    x_T = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[0],
                                                      (2, 8, 8, 4))))
    out = {}
    for decode in (False, True):
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(jpipe.sample_batch(v, key, context=jnp.asarray(ctx.numpy()),
                                                uncond=jnp.asarray(unc.numpy()),
                                                mode=JFP, decode=decode))
        got = tpipe.sample_batch(FP, x_T=x_T, context=ctx, uncond=unc,
                                 decode=decode).numpy()
        assert got.shape == ref.shape and np.isfinite(got).all()
        out[decode] = (got, ref)
        print(f"\n  dpm sample_batch decode={decode}: max |d| "
              f"{np.abs(got - ref).max():.3g}")
    np.testing.assert_allclose(*out[False], rtol=1e-4, atol=1e-4)
    img, ref = out[True]
    assert img.shape == (2, 16, 16, 3) and img.min() >= 0.0 and img.max() <= 1.0
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-4)
