"""The port's first-stage encoder (``FirstStage.encode``: ``VAEEncoder``
with the (0, 1) pad before each stride-2 downsample, then ``quant_conv``)
against the JAX package's, and the reference-layout round trip with the
encoder.

Tiny VQ and KL configs (``tests/test_torch_vae.py``'s: 32 channels,
ch_mult (1, 2), attention at 8×8 so the encoder's attention block runs),
flax's initial weights perturbed so that every bias and norm parameter
matters.  JAX runs with ``jax_default_matmul_precision="highest"``; both
sides compute in float32, so the latents agree within rtol = atol = 1e-5
(sum order only).  The converters are exact: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.models import vae as jvae
from eda_dm_tpu_torch import reference_layout as rl
from eda_dm_tpu_torch.models import vae as tvae
from eda_dm_tpu_torch.models.bridge import first_stage_from_jax, to_jax_variables

TINY = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
            attn_resolutions=(8,), in_channels=3, resolution=16)
CONFIGS = {
    "vq": dict(z_channels=3, double_z=False, embed_dim=3, n_embed=64),
    "kl": dict(z_channels=4, double_z=True, embed_dim=4, n_embed=None),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb), sorted(set(fa) ^ set(fb))[:8]
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def first_stage(request):
    """JAX's FirstStage with its encoder (an init through ``encode`` and
    ``decode``), perturbed; and a batch of images."""
    kind = request.param
    jcfg = jvae.VAEConfig(**TINY, **CONFIGS[kind])
    fs = jvae.FirstStage(cfg=jcfg)
    z0 = jnp.zeros((1, 8, 8, jcfg.embed_dim))
    v = fs.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                method=lambda m, im: (m.encode(im), m.decode(z0)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        a.shape).astype(np.float32), v["params"])
    x = np.random.default_rng(2).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(fs.apply({"params": params}, jnp.asarray(x), method=fs.encode))
    return dict(kind=kind, params=_np(params), x=x, ref=ref,
                cfg=tvae.VAEConfig(**TINY, **CONFIGS[kind]))


def test_encode_matches_jax(first_stage):
    c = first_stage
    port = first_stage_from_jax({"params": c["params"]}, c["cfg"], device="cpu")
    out = port.encode(torch.from_numpy(c["x"])).numpy()
    z = 2 * CONFIGS[c["kind"]]["embed_dim"] if c["kind"] == "kl" else 3
    assert out.shape == c["ref"].shape == (2, 8, 8, z)
    np.testing.assert_allclose(out, c["ref"], rtol=1e-5, atol=1e-5)


def test_converter_round_trip_with_the_encoder(first_stage):
    """The tree (encoder and ``quant_conv`` included) → a reference
    autoencoder state dict → the port's converter gives it back bit for
    bit, the port's ``FirstStage`` loads all of it and gives it back, and
    encodes as JAX does."""
    c = first_stage
    sd = rl.vae_state_dict(c["params"])
    assert any(k.startswith("encoder.down.0.block.0.") for k in sd)
    assert "quant_conv.weight" in sd
    tree = tvae.vae_state_dict_to_params(sd)
    _assert_trees_equal(tree, c["params"])
    port = first_stage_from_jax({"params": tree}, c["cfg"], device="cpu")
    _assert_trees_equal(to_jax_variables(port)["params"], c["params"])
    np.testing.assert_allclose(port.encode(torch.from_numpy(c["x"])).numpy(), c["ref"],
                               rtol=1e-5, atol=1e-5)


def test_decode_only_load(first_stage):
    """``encoder=False`` reads the decode part alone, as before the encoder
    was ported; its random decoder equals the full first stage's."""
    c = first_stage
    port = first_stage_from_jax({"params": c["params"]}, c["cfg"], device="cpu",
                                encoder=False)
    got = to_jax_variables(port)["params"]
    assert "encoder" not in got and "quant_conv" not in got
    with pytest.raises(RuntimeError, match="decode-only"):
        port.encode(torch.from_numpy(c["x"]))
    full = tvae.FirstStage(c["cfg"], device="cpu", seed=3)
    lean = tvae.FirstStage(c["cfg"], device="cpu", seed=3, encoder=False)
    for (n, a), (_, b) in zip(lean.named_parameters(), full.named_parameters()):
        assert torch.equal(a, b), n
