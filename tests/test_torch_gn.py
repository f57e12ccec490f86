"""The port's fused GroupNorm (kernel K6, ``ops/gn_int8.py``) vs the JAX
package's Pallas kernel (``eda_dm_tpu/ops/pallas_gn.py``, interpret mode).

* ``gn_swish_int8``'s plain version against JAX's kernel, at the shapes
  and pads of ``tests/test_pallas_gn.py``, a 224-channel width (7 channels
  a group) and a bf16 input: the same offset ``c``; codes within ±1 on
  < 0.1 % of the elements (the port adds the statistics in float64, JAX
  in float32 in XLA's order, so a code on a rounding tie may flip); the
  rim holds −c.
* ``gn_norm`` against JAX, with and without swish: float32 within
  rtol = atol = 2e-5, bf16 within one bf16 step.
* The gate: ``fused_gn_applicable`` and ``use_fused_gn`` equal to JAX's
  over a table of shapes and ``EDM_FUSED_GN`` / ``EDM_FUSED_GN_NARROW``
  settings.
* With ``EDM_FUSED_GN=1``, blocks calibrated by JAX on their own, in
  DEPLOY_INT8: ``ResBlockL`` at 128 and 224 channels (the latter behind
  ``EDM_FUSED_GN_NARROW=1``), ``AttentionBlockL`` and a tiny
  ``SpatialTransformerL`` (GroupNorm fused into ``proj_in``), each module
  on JAX's input within rtol = atol = 2e-5 (``_against_jax_args``) and
  the output within rtol = atol = 2e-5.
* A spy on both packages (``k6_spy``) holds that every GroupNorm site of
  a block took the fused kernel in both.  The whole tiny DDPM with fused
  GroupNorm is held in ``tests/test_torch_ddpm.py``, beside its
  JAX-calibrated fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.models import ldm_unet as jldm
from eda_dm_tpu.ops import pallas_gn as jgn
from eda_dm_tpu.ops import serving_policy as jpolicy
from eda_dm_tpu.quant import export as jexport
from eda_dm_tpu_torch.models import ldm_unet as tldm
from eda_dm_tpu_torch.models.bridge import load_jax_variables
from eda_dm_tpu_torch.nn import layers as tlayers
from eda_dm_tpu_torch.nn.layers import GNorm
from eda_dm_tpu_torch.ops import gn_int8, serving_policy as tpolicy
from eda_dm_tpu_torch.quant import DEPLOY_INT8

from test_torch_ddpm import (JQC_, QC, _against_jax_args, _np, _torch,
                             k6_spy)  # noqa: F401
from test_torch_sd import CTX_DIM, _calibrate

PADS = [((0, 0), (0, 0)), ((1, 1), (1, 1)), ((0, 1), (0, 1))]


def _gn_inputs(c, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((2, 8, 8, c)) * 2.1 + 0.3, dtype)
    scale = jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)
    bias = jnp.asarray(rng.standard_normal(c) * 0.1, jnp.float32)
    return x, scale, bias


def _bf16_steps(a, b):
    """|a − b| in units of one bf16 step at the larger magnitude."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    _, e = np.frexp(np.maximum(np.abs(a), np.abs(b)))
    return np.abs(a - b) / np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("c,pads,dtype", [(128, p, "float32") for p in PADS]
                         + [(224, ((1, 1), (1, 1)), "float32"),
                            (128, ((0, 1), (0, 1)), "bfloat16")])
@pytest.mark.parametrize("swish", [True, False])
def test_gn_swish_int8_matches_jax(c, pads, dtype, swish):
    x, scale, bias = _gn_inputs(c, 4, dtype)
    d, zp = 0.043, 57.0
    jcodes, jc = jgn.gn_swish_int8(x, scale, bias, jnp.asarray(d),
                                   jnp.asarray(zp), 256, pads, swish=swish,
                                   interpret=True)
    codes, cc = gn_int8.gn_swish_int8(
        _torch(x), _torch(scale), _torch(bias), torch.tensor(d),
        torch.tensor(zp), 256, pads, swish=swish)
    assert float(cc) == float(jc)
    assert codes.dtype == torch.int8 and codes.shape == jcodes.shape
    diff = np.abs(codes.numpy().astype(np.int32) - np.asarray(jcodes, np.int32))
    print(f"\n  {c} ch {dtype} pads {pads}: {int((diff != 0).sum())} of "
          f"{diff.size} codes differ")
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-3
    (pt, pb), (pl, pr) = pads
    rim = np.ones(codes.shape[1:3], bool)
    rim[pt:pt + 8, pl:pl + 8] = False
    assert (codes.numpy()[:, rim] == int(-float(cc))).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("swish", [False, True])
def test_gn_norm_matches_jax(dtype, swish):
    x, scale, bias = _gn_inputs(256, 7, dtype)
    ref = jgn.gn_norm(x, scale, bias, swish=swish, interpret=True)
    out = gn_int8.gn_norm(_torch(x), _torch(scale), _torch(bias), swish=swish)
    assert out.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)
    else:
        assert _bf16_steps(out.float().numpy(), ref).max() <= 1.0


def test_gn_norm_matches_gnorm():
    """Without quantization K6 computes the port's GroupNorm (+ swish) up
    to float32 rounding: it folds the scale into the reciprocal deviation
    before the product, GNorm multiplies after."""
    x, scale, bias = (_torch(a) for a in _gn_inputs(96, 8))
    gn = GNorm(96)
    gn.scale.data, gn.bias.data = scale, bias
    torch.testing.assert_close(gn_int8.gn_norm(x, scale, bias), gn(x),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(gn_int8.gn_norm(x, scale, bias, swish=True),
                               tlayers.swish(gn(x)), rtol=2e-5, atol=2e-5)


SHAPES = [(32, 32, 128), (32, 32, 384), (32, 32, 448), (32, 32, 512),
          (16, 16, 672), (16, 16, 1280), (16, 16, 1344), (16, 16, 1920),
          (8, 8, 96), (8, 8, 100), (3, 3, 128), (64, 64, 128), (16, 16, 320),
          (8, 8, 2560), (4, 4, 40)]


@pytest.mark.parametrize("fused", [None, "0", "1"])
@pytest.mark.parametrize("narrow", [None, "0", "1"])
def test_gate_matches_jax(monkeypatch, fused, narrow):
    for name, value in (("EDM_FUSED_GN", fused), ("EDM_FUSED_GN_NARROW", narrow)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    for shape in SHAPES:
        assert tpolicy.fused_gn_applicable(*shape) == jgn.fused_gn_applicable(*shape)
        assert tpolicy.use_fused_gn(*shape) == jpolicy.use_fused_gn(*shape), shape
    assert any(map(tpolicy.use_fused_gn, *zip(*SHAPES))) == (fused == "1")


def _ldm_blocks():
    wq, aq, aq_w = JQC_.wq, JQC_.aq, JQC_.aq_softmax(always_zero=True)
    pw, pa, pw_ = QC.wq, QC.aq, QC.aq_softmax(always_zero=True)
    rng = np.random.default_rng(13)
    x128 = rng.standard_normal((2, 8, 8, 128)).astype(np.float32)
    x4 = rng.standard_normal((2, 4, 4, 128)).astype(np.float32)
    x224 = rng.standard_normal((2, 8, 8, 224)).astype(np.float32)
    emb = rng.standard_normal((2, 64)).astype(np.float32)
    ctx = rng.standard_normal((2, 6, CTX_DIM)).astype(np.float32)
    return {
        "resblock_128": (jldm.ResBlockL(128, wq, aq),
                         lambda: tldm.ResBlockL(128, 128, 64, pw, pa), (x128, emb)),
        "resblock_224": (jldm.ResBlockL(224, wq, aq),
                         lambda: tldm.ResBlockL(224, 224, 64, pw, pa), (x224, emb)),
        "attention_block": (jldm.AttentionBlockL(4, wq, aq, aq_w),
                            lambda: tldm.AttentionBlockL(128, 4, pw, pa, pw_),
                            (x128,)),
        "spatial_transformer": (jldm.SpatialTransformerL(2, 16, 1, wq, aq, aq_w),
                                lambda: tldm.SpatialTransformerL(
                                    128, 2, 16, 1, CTX_DIM, pw, pa, pw_),
                                (x4, ctx)),
    }


LDM_BLOCKS = _ldm_blocks()


@pytest.mark.parametrize("block", list(LDM_BLOCKS))
def test_ldm_block_fused_gn_matches_jax(block, k6_spy, monkeypatch):
    jblk, make, args = LDM_BLOCKS[block]
    if block == "resblock_224":
        monkeypatch.setenv("EDM_FUSED_GN_NARROW", "1")
    jargs = [jnp.asarray(a) for a in args]
    tree = jexport.export_serving_int8(_calibrate(jblk, *jargs), JQC_,
                                       dtype=jnp.float32)
    blk = make()
    load_jax_variables(blk, _np(tree))
    ref, out, flips = _against_jax_args(jblk, tree, blk, jargs,
                                        jexport.DEPLOY_INT8, DEPLOY_INT8,
                                        attn_code_flips=True, tag=block)
    sites = {"resblock_128": 2, "resblock_224": 2, "attention_block": 1,
             "spatial_transformer": 1}[block]
    # the forced and the free port run, one JAX run
    assert k6_spy["jax"] == sites and k6_spy["port"] == 2 * sites, k6_spy
    assert k6_spy["port_gate"] == 2 * k6_spy["jax_gate"]
    assert all(fused for _, fused in k6_spy["jax_gate"])
    assert flips == 0
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
