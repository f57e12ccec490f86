"""The port's TDAC selection and pixel samplers against the JAX package, on
the CPU.

* ``_pair_scores`` within rel 1e-5 (atol 1e-5 for the MSE's cancellation
  near the diagonal); ``timestep_counts`` equal (counts, density,
  diversity), in both branches of the exact-sum repair.
* ``select_calib_set`` with JAX's permutation injected: equal
  ``calib_x``, ``calib_t`` and time codes.
* ``generalized_steps(record_xt=True, model_returns_aux=True)`` and
  ``capture_fn``, at eta 0 and at eta 0.5 with JAX's noise injected, and
  ``ddpm_steps`` with JAX's noise: within 1e-5, the per-step records
  included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.calib import tdac as jtdac
from eda_dm_tpu.samplers import ddim as jddim
from eda_dm_tpu.samplers.schedules import get_beta_schedule, skip_sequence
from eda_dm_tpu_torch.calib import tdac as ttdac
from eda_dm_tpu_torch.samplers import ddim as tddim


def _feats(seed=0, T=7):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((1, 3, 4, 4, 16)).astype(np.float32)
    drift = rng.standard_normal((T, 3, 4, 4, 16)).astype(np.float32)
    return base + 0.3 * np.cumsum(drift, axis=0)


def test_pair_scores_match_jax():
    f = _feats()
    mse, cos = ttdac._pair_scores(torch.from_numpy(f))
    jm, jc = jtdac._pair_scores(jnp.asarray(f))
    np.testing.assert_allclose(mse.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)


def test_timestep_counts_match_jax():
    """Every N from 5 to 80 at two radii, which takes both branches of the
    repair: rounding short of N (add to the largest counts) and past it
    (take from the tail)."""
    f = _feats(1)
    jm, jc = map(np.asarray, jtdac._pair_scores(jnp.asarray(f)))
    P = int(np.prod(f.shape[1:-1]))
    branches = set()
    for n in range(5, 81):
        for dense_r in (0.5, 3.0):
            want = jtdac.timestep_counts(jm, jc, P, 1.2, n, dense_r)
            got = ttdac.timestep_counts(jm, jc, P, 1.2, n, dense_r)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            w = jtdac._normalize(want[1]) + 1.2 * jtdac._normalize(want[2])
            branches.add(np.sign(n - np.round(w / w.sum() * n).sum()))
    assert branches == {-1.0, 0.0, 1.0}


def test_select_calib_set_with_jax_permutation():
    rng = np.random.default_rng(2)
    T, B = 7, 3
    traj = rng.standard_normal((T, B, 8, 8, 3)).astype(np.float32)
    f = _feats(3, T)
    seq = skip_sequence("quad", T, 100)
    key = jax.random.PRNGKey(5)
    want = jtdac.select_calib_set(jnp.asarray(traj), jnp.asarray(f), seq, 1.2, 16,
                                  3.0, key)
    perm = np.asarray(jax.random.permutation(key, 16))
    got = ttdac.select_calib_set(torch.from_numpy(traj), torch.from_numpy(f), seq, 1.2,
                                 16, 3.0, perm=perm)
    np.testing.assert_array_equal(got.time_codes, want.time_codes)
    np.testing.assert_array_equal(got.t_num, want.t_num)
    np.testing.assert_array_equal(got.calib_x.numpy(), np.asarray(want.calib_x))
    np.testing.assert_array_equal(got.calib_t.numpy(), np.asarray(want.calib_t))
    # a generator's draw is a permutation of the same counts
    drawn = ttdac.select_calib_set(torch.from_numpy(traj), torch.from_numpy(f), seq, 1.2,
                                   16, 3.0, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(np.sort(drawn.time_codes), np.sort(want.time_codes))


def _toy(xp):
    """A model function both packages compute alike, with an aux output."""
    def fn(x, t):
        eps = xp.sin(x) * 0.3 + x * (t[:, None, None, None] / 500.0)
        return eps, x.mean(axis=(1, 2)) if xp is jnp else x.mean(dim=(1, 2))
    return fn


def _jax_noise(key, steps, shape):
    """The per-step draws of JAX's sampler scans."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.normal(sub, shape)))
    return out


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_generalized_steps_records_match_jax(eta):
    betas = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                              num_diffusion_timesteps=100)
    seq = skip_sequence("quad", 6, 100)
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jout, jys = jddim.generalized_steps(
        jnp.asarray(x), seq, _toy(jnp), betas, eta=eta, key=key, record_xt=True,
        model_returns_aux=True, capture_fn=lambda a, t: a[:, 0, 0, 0] * 2.0)
    noise = [torch.from_numpy(n) for n in _jax_noise(key, len(seq), x.shape)]
    out, ys = tddim.generalized_steps(
        torch.from_numpy(x), seq, _toy(torch), betas, eta=eta, noise=noise,
        device="cpu", record_xt=True, model_returns_aux=True,
        capture_fn=lambda a, t: a[:, 0, 0, 0] * 2.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    assert set(ys) == set(jys) == {"x", "t", "aux", "extra"}
    np.testing.assert_array_equal(ys["t"].numpy(), np.asarray(jys["t"]))
    for k in ("x", "aux"):
        np.testing.assert_allclose(ys[k].numpy(), np.asarray(jys[k]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.stack(ys["extra"]).numpy(), np.asarray(jys["extra"]),
                               rtol=1e-5, atol=1e-5)
    # with nothing to record, the sampler returns x_0 alone, as before
    plain = tddim.generalized_steps(torch.from_numpy(x), seq,
                                    lambda a, t: _toy(torch)(a, t)[0], betas, eta=eta,
                                    noise=noise, device="cpu")
    assert torch.equal(plain, out)


def test_ddpm_steps_match_jax():
    betas = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                              num_diffusion_timesteps=100)
    seq = skip_sequence("uniform", 5, 100)
    x = np.random.default_rng(5).standard_normal((2, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = jddim.ddpm_steps(jnp.asarray(x), seq, lambda a, t: _toy(jnp)(a, t)[0], betas,
                            key=key)
    noise = [torch.from_numpy(n) for n in _jax_noise(key, len(seq), x.shape)]
    got = tddim.ddpm_steps(torch.from_numpy(x), seq, lambda a, t: _toy(torch)(a, t)[0],
                           betas, noise=noise, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
