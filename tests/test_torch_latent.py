"""The port's latent DDIM and ``sample_batch`` vs the JAX package.

* The schedules are numpy on both sides and must be equal.
* ``ldm_ddim_sample`` at eta 1.0, 4 steps, on the tiny JAX-calibrated LDM
  of ``tests/test_torch_ldm.py`` in DEPLOY_INT8, with JAX's noise handed
  to the port (the same key split the same way).  Step by step on JAX's
  own x_t: the forward held as in ``test_torch_ldm.py`` and the DDIM
  update on JAX's (x_t, ε, noise) within rtol = atol = 2e-5.  Run freely,
  a code that flips at a tie spreads (see ``test_torch_ddpm.py``): median
  |Δ| < 2e-4, max < 0.3, and the mean drift no larger than JAX's own
  folded-vs-int8 drift on the same noise.
* The whole tiny ``sample_batch`` (UNet, then the VQ decode, then the clip
  to [0, 1]): the latents under the bounds above; the decode on JAX's own
  latents within rtol = atol = 1e-4; the images of the free run median
  |Δ| < 2e-4 and mean drift no larger than JAX's own folded-vs-int8 drift.
  Their max is not bounded: a latent that drifted by 1e-5 near a tie of
  two codebook entries takes the other code, which moves a patch of the
  image by up to the distance between the codes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.models import vae as jvae
from eda_dm_tpu.models.latent_diffusion import LatentDiffusionConfig as JLDC
from eda_dm_tpu.pipelines import latent as jpipe
from eda_dm_tpu.quant import export as jexport
from eda_dm_tpu.samplers import latent as jlat
from eda_dm_tpu_torch.models.bridge import first_stage_from_jax, load_jax_variables
from eda_dm_tpu_torch.models.latent_diffusion import LatentDiffusionConfig
from eda_dm_tpu_torch.models.vae import VAEConfig
from eda_dm_tpu_torch.pipelines.latent import LDMPipeline, task_config
from eda_dm_tpu_torch.quant import DEPLOY_INT8
from eda_dm_tpu_torch.samplers import latent as tlat

from test_torch_ddpm import _against_jax, _np
from test_torch_ldm import CFG, JCFG, JQC_, calibrated  # noqa: F401 (fixture)
from test_torch_ldm import _port

STEPS = 4
VAE = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
           attn_resolutions=(), in_channels=3, resolution=32, z_channels=3,
           double_z=False, embed_dim=3, n_embed=64)


@pytest.mark.parametrize("n,start,end", [(1000, 1e-4, 2e-2), (1000, 0.0015, 0.0195),
                                         (100, 0.0015, 0.0195), (10, 0.0015, 0.0195)])
def test_beta_schedules_equal(n, start, end):
    np.testing.assert_array_equal(
        tlat.make_beta_schedule(n, linear_start=start, linear_end=end),
        jlat.make_beta_schedule("linear", n, linear_start=start, linear_end=end))


@pytest.mark.parametrize("steps,eta", [(50, 0.0), (50, 1.0), (200, 1.0)])
def test_ldm_schedule_equal(steps, eta):
    a = tlat.make_ldm_schedule(ddim_steps=steps, eta=eta)
    b = jlat.make_ldm_schedule(ddim_steps=steps, eta=eta)
    for field in ("betas", "alphas_cumprod", "ddim_timesteps", "ddim_alphas",
                  "ddim_alphas_prev", "ddim_sigmas",
                  "ddim_sqrt_one_minus_alphas"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_cfg_model_fn_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    t = np.full((2,), 10.0, np.float32)
    cond, unc = (rng.standard_normal((2, 5)).astype(np.float32) for _ in range(2))

    def apply(xp):
        return lambda xx, tt, c: xx * xp.sum(c) + tt[:, None, None, None]
    ref = jlat.cfg_model_fn(apply(jnp), jnp.asarray(cond), jnp.asarray(unc),
                            3.0)(jnp.asarray(x), jnp.asarray(t))
    T = torch.from_numpy
    out = tlat.cfg_model_fn(apply(torch), T(cond), T(unc), 3.0)(T(x), T(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def _jax_noise(key, shape, steps):
    """The per-step noise of JAX's ``ldm_ddim_sample`` scan."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.normal(sub, shape, jnp.float32)))
    return out


def _drift(out, ref, other, max_abs=0.3):
    d, dj = np.abs(out - ref), np.abs(other - ref)
    print(f"\n  free run: median {np.median(d):.3g} max {d.max():.3g} mean "
          f"{d.mean():.3g} share<2e-4 {(d < 2e-4).mean():.4f}; JAX folded vs "
          f"int8: mean {dj.mean():.3g}")
    assert np.isfinite(out).all()
    assert np.median(d) < 2e-4 and d.max() < max_abs
    assert d.mean() <= dj.mean()


def test_ldm_ddim_sample_eta1(calibrated):
    c = calibrated
    model, sched = c["model"], jlat.make_ldm_schedule(ddim_steps=STEPS, eta=1.0)
    key = jax.random.PRNGKey(7)
    x_T = np.random.default_rng(8).standard_normal((2, 16, 16, 3)).astype(np.float32)

    def jax_run(tree, mode, record=False):
        out, aux = jlat.ldm_ddim_sample(
            jnp.asarray(x_T), sched,
            lambda xx, tt: model.apply(tree, xx, tt, mode=mode), key=key,
            record_xt=record)
        return np.asarray(out), aux

    ref, steps = jax_run(c["int8"], jexport.DEPLOY_INT8, record=True)
    folded, _ = jax_run(jexport.export_serving(c["v"], JQC_, dtype=jnp.float32),
                        jexport.DEPLOY)
    noise = _jax_noise(key, x_T.shape, STEPS)
    port = _port(c["int8"])
    f32 = lambda a: torch.tensor(float(a), dtype=torch.float32)
    for k in range(STEPS):
        index = STEPS - 1 - k
        xk = np.array(steps["x"][k])
        t = np.full((2,), float(steps["t"][k]), np.float32)
        assert int(steps["index"][k]) == index
        eps, _, _ = _against_jax(model, c["int8"], port, xk, t,
                                 jexport.DEPLOY_INT8, DEPLOY_INT8,
                                 attn_code_flips=True, jit=True)
        nxt, _ = jlat.ddim_update(
            jnp.asarray(xk), jnp.asarray(eps), sched.ddim_alphas[index],
            sched.ddim_alphas_prev[index], sched.ddim_sigmas[index],
            sched.ddim_sqrt_one_minus_alphas[index], jnp.asarray(noise[k]))
        nxt_port, _ = tlat.ddim_update(
            torch.from_numpy(xk), torch.from_numpy(np.array(eps)),
            f32(sched.ddim_alphas[index]), f32(sched.ddim_alphas_prev[index]),
            f32(sched.ddim_sigmas[index]),
            f32(sched.ddim_sqrt_one_minus_alphas[index]),
            torch.from_numpy(noise[k]))
        np.testing.assert_allclose(nxt_port.numpy(), np.asarray(nxt),
                                   rtol=2e-5, atol=2e-5)
    out = tlat.ldm_ddim_sample(
        torch.from_numpy(x_T), tlat.make_ldm_schedule(ddim_steps=STEPS, eta=1.0),
        lambda xx, tt: port(xx, tt, mode=DEPLOY_INT8),
        noise=[torch.from_numpy(n) for n in noise], device="cpu").numpy()
    _drift(out, ref, folded)


def test_sample_batch(calibrated):
    """x_T and the sampler keys as JAX's ``sample_batch`` splits them.  A
    100-step schedule keeps ᾱ above ~0.4 over the 4 DDIM steps, so the x0
    estimate (x − √(1−ᾱ)·ε)/√ᾱ does not amplify a flipped code's drift
    tenfold and more, as the first steps of the 1000-step one do on a
    random-weight model."""
    c = calibrated
    mc = JLDC(unet=JCFG, vae=jvae.VAEConfig(**VAE), timesteps=100)
    pipe = jpipe.LDMPipeline(jpipe.task_config("bedroom", custom_steps=STEPS),
                             model_cfg=mc)
    fs = pipe.ld.first_stage
    vae = fs.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)))
    key = jax.random.PRNGKey(11)

    def jax_run(unet_tree, mode, decode=True):
        with jax.default_matmul_precision("highest"):
            return np.array(pipe.sample_batch(
                {"unet": unet_tree, "first_stage": vae}, key, batch_size=2,
                mode=mode, decode=decode))

    folded_tree = jexport.export_serving(c["v"], JQC_, dtype=jnp.float32)
    k_noise, k_samp = jax.random.split(key)
    x_T = np.array(jax.random.normal(k_noise, (2, 16, 16, 3)))
    noise = [torch.from_numpy(n) for n in _jax_noise(k_samp, x_T.shape, STEPS)]

    port = LDMPipeline(task_config("bedroom", custom_steps=STEPS),
                       LatentDiffusionConfig(unet=CFG, vae=VAEConfig(**VAE),
                                             timesteps=100),
                       device="cpu")
    load_jax_variables(port.ld.unet, _np(c["int8"]))
    port.ld.first_stage = first_stage_from_jax(_np(vae), VAEConfig(**VAE), "cpu")
    run = lambda decode: port.sample_batch(
        DEPLOY_INT8, x_T=torch.from_numpy(x_T), noise=noise,
        decode=decode).numpy()

    z_ref = jax_run(c["int8"], jexport.DEPLOY_INT8, decode=False)
    _drift(run(False), z_ref,
           jax_run(folded_tree, jexport.DEPLOY, decode=False))
    with jax.default_matmul_precision("highest"):
        img = pipe.ld.decode_first_stage(vae, jnp.asarray(z_ref))
        ref = np.asarray(jnp.clip((img + 1.0) / 2.0, 0.0, 1.0))
    with torch.no_grad():
        img = port.ld.decode_first_stage(torch.from_numpy(z_ref))
    np.testing.assert_allclose(torch.clamp((img + 1.0) / 2.0, 0.0, 1.0).numpy(),
                               ref, rtol=1e-4, atol=1e-4)
    out = run(True)
    assert out.shape == ref.shape == (2, 32, 32, 3)
    assert out.min() >= 0.0 and out.max() <= 1.0
    _drift(out, jax_run(c["int8"], jexport.DEPLOY_INT8),
           jax_run(folded_tree, jexport.DEPLOY), max_abs=1.0)
