"""Port quantizer primitives vs the JAX package on shared random tensors.

Integer results (zero-points, codes) must be equal; floats agree to f32
rounding (rtol 1e-6: one or two ulps from transcendental implementations).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.quant import adaround as jad
from eda_dm_tpu.quant import affine as jaf
from eda_dm_tpu_torch.quant import adaround as tad
from eda_dm_tpu_torch.quant import affine as taf


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ranges(kind, rng, n=512):
    if kind == "symmetric":                       # exactly symmetric ranges
        hi = rng.uniform(0.01, 5.0, n).astype(np.float32)
        return -hi, hi
    if kind == "positive":
        lo = rng.uniform(0.0, 1.0, n).astype(np.float32)
        return lo, lo + rng.uniform(0.01, 3.0, n).astype(np.float32)
    lo = rng.uniform(-4.0, 0.5, n).astype(np.float32)
    return lo, lo + rng.uniform(0.0, 6.0, n).astype(np.float32)


@pytest.mark.parametrize("kind", ["mixed", "symmetric", "positive"])
@pytest.mark.parametrize("n_levels", [16, 256])
@pytest.mark.parametrize("always_zero", [False, True])
def test_calculate_qparams(kind, n_levels, always_zero):
    rng = np.random.default_rng(
        ["mixed", "symmetric", "positive"].index(kind) * 1000 + n_levels)
    lo, hi = _ranges(kind, rng)
    js, jz = jaf.calculate_qparams(jnp.asarray(lo), jnp.asarray(hi), n_levels,
                                   always_zero)
    ts, tz = taf.calculate_qparams(_t(lo), _t(hi), n_levels, always_zero)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    if kind == "symmetric" and not always_zero:
        assert (tz.numpy() == n_levels // 2).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_levels", [16, 256])
def test_fake_quant(dtype, n_levels):
    rng = np.random.default_rng(n_levels)
    x = (3.0 * rng.standard_normal((64, 48))).astype(np.float32)
    delta = rng.uniform(0.01, 0.2, (1, 48)).astype(np.float32)
    zp = rng.integers(0, n_levels, (1, 48)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = _t(x).to(getattr(torch, dtype))
    jo = jaf.fake_quant(jx, jnp.asarray(delta), jnp.asarray(zp), n_levels)
    to = taf.fake_quant(tx, _t(delta), _t(zp), n_levels)
    assert to.dtype == tx.dtype
    np.testing.assert_array_equal(to.float().numpy(),
                                  np.asarray(jo, np.float32))


def _weights(seed):
    rng = np.random.default_rng(seed)
    w = (0.2 * rng.standard_normal((32, 16, 3, 3))).astype(np.float32)
    delta = rng.uniform(0.005, 0.05, (32, 1, 1, 1)).astype(np.float32)
    zp = rng.integers(4, 12, (32, 1, 1, 1)).astype(np.float32)
    return w, delta, zp


@pytest.mark.parametrize("seed", [0, 1])
def test_init_alpha(seed):
    w, delta, _ = _weights(seed)
    ja = np.asarray(jad.init_alpha(jnp.asarray(w), jnp.asarray(delta)))
    ta = tad.init_alpha(_t(w), _t(delta)).numpy()
    # XLA's f32 division on the CPU may land one ulp off the correctly
    # rounded w/Δ (seen under the multi-worker suite run); alpha's slope in
    # the residue is at most 1.2 / (0.1 · 1.1) ≈ 11, so allow two ulps of
    # the largest |w/Δ| through that slope
    atol = 11.0 * 2 * float(np.spacing(np.abs(w / delta).max()))
    np.testing.assert_allclose(ta, ja, rtol=0, atol=atol)
    # hard rounding from either alpha is round-to-nearest
    clear = np.abs(ja) > atol
    np.testing.assert_array_equal(ta[clear] >= 0, ja[clear] >= 0)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_levels", [16, 256])
def test_adaround_hard(seed, n_levels):
    w, delta, zp = _weights(seed)
    rng = np.random.default_rng(seed + 10)
    alpha = rng.standard_normal(w.shape).astype(np.float32)
    jq = jad.adaround_int(jnp.asarray(w), jnp.asarray(delta), jnp.asarray(zp),
                          jnp.asarray(alpha), n_levels)
    tq = tad.adaround_int(_t(w), _t(delta), _t(zp), _t(alpha), n_levels)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    jf = jad.adaround_fake_quant(jnp.asarray(w), jnp.asarray(delta),
                                 jnp.asarray(zp), jnp.asarray(alpha), n_levels,
                                 soft=False)
    tf = tad.adaround_fake_quant(_t(w), _t(delta), _t(zp), _t(alpha), n_levels)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6, atol=0)
