"""The port's first-stage decode vs the JAX package's ``FirstStage``.

Tiny VQ and KL configs (32 channels, ch_mult (1, 2), attention at 8×8 so
the decoder's attention block runs), random weights perturbed away from
flax's initial values so every bias and norm parameter matters.  JAX runs
with ``jax_default_matmul_precision="highest"``: both sides compute in
full float32, so the decode agrees within rtol = atol = 1e-4 (sum order
only).  The VQ lookup agrees index for index, except where the two nearest
codebook distances tie within 1e-5 relative (float64 distances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.models import vae as jvae
from eda_dm_tpu_torch.models import vae as tvae
from eda_dm_tpu_torch.models.bridge import first_stage_from_jax, to_jax_variables

TINY = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
            attn_resolutions=(8,), in_channels=3, resolution=16)
CONFIGS = {
    "vq": dict(z_channels=3, double_z=False, embed_dim=3, n_embed=64),
    "kl": dict(z_channels=4, double_z=True, embed_dim=4, n_embed=None),
}


def _jax_first_stage(kind, latent_hw=8, n_embed=None):
    kw = dict(CONFIGS[kind])
    if n_embed is not None:
        kw["n_embed"] = n_embed
    jcfg = jvae.VAEConfig(**TINY, **kw)
    fs = jvae.FirstStage(cfg=jcfg)
    z0 = jnp.zeros((1, latent_hw, latent_hw, jcfg.embed_dim))
    params = fs.init(jax.random.PRNGKey(0), z0)["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a if jax.tree_util.keystr(p).endswith("'codebook']")
        else a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    return fs, jcfg, {"params": params}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("kind", ["vq", "kl"])
def test_decode_matches_jax(kind):
    fs, jcfg, v = _jax_first_stage(kind)
    z = np.random.default_rng(2).standard_normal(
        (2, 8, 8, jcfg.embed_dim)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(fs.apply(v, jnp.asarray(z), method=fs.decode))
    port = first_stage_from_jax(_np(v), tvae.VAEConfig(**TINY, **CONFIGS[kind]),
                                device="cpu")
    out = port.decode(torch.from_numpy(z)).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    if kind == "vq":                  # the forced path skips the codebook
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(fs.apply(v, jnp.asarray(z), True, method=fs.decode))
        out = port.decode(torch.from_numpy(z), force_not_quantize=True).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_vq_lookup_matches_jax_across_chunks():
    """32 × 32 × 12 latents = 12,288 rows: two row chunks of 8192 on both
    sides; 512 codes drawn close to the latents, so near-ties occur."""
    fs, jcfg, v = _jax_first_stage("vq", latent_hw=32, n_embed=512)
    rng = np.random.default_rng(3)
    z = rng.uniform(0.0, 1.0, (12, 32, 32, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(fs.apply(v, jnp.asarray(z), method=fs.quantize))
    port = first_stage_from_jax(
        _np(v), tvae.VAEConfig(**TINY, **{**CONFIGS["vq"], "n_embed": 512}),
        device="cpu")
    out = port.quantize(torch.from_numpy(z)).numpy()
    cb = np.asarray(v["params"]["codebook"], np.float64)
    flat = z.reshape(-1, 3).astype(np.float64)
    d = ((flat[:, None, :] - cb[None]) ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    tie = (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 1]
    differ = (out.reshape(-1, 3) != ref.reshape(-1, 3)).any(-1)
    assert not (differ & ~tie).any(), np.flatnonzero(differ & ~tie)[:5]
    assert differ.mean() < 1e-3


def test_bridge_round_trip():
    fs, jcfg, v = _jax_first_stage("vq")
    port = first_stage_from_jax(_np(v), tvae.VAEConfig(**TINY, **CONFIGS["vq"]),
                                device="cpu")
    got = to_jax_variables(port)["params"]
    ref = _np(v)["params"]
    assert set(got) == set(ref) - {"encoder", "quant_conv"}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            {k: ref[k] for k in got})[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf, err_msg=str(path))

