"""The tensor-core rate probe's plain chains (P1,
``eda_dm_tpu_torch/probes/mma_int8.py``) against the JAX probe
``scripts/probes/mosaic_int8.py``, on the CPU.

``pallas_chain`` has no interpret flag (on the CPU it raises), so the JAX
side runs ``pl.pallas_call`` on the probe's own ``chain_kernel_s8`` /
``chain_kernel_bf16`` with ``pallas_chain``'s BlockSpecs and
``interpret=True``, and also runs ``xla_chain_s8`` / ``xla_chain_bf16``.

* int8: the port's plain chain equals both bit for bit after 40 steps
  (exact int32 sums, an arithmetic ``>> 8``, a wrapping cast).
* bf16, on the scaled B that keeps the chain finite: within the probe's
  stated tolerance (relative L2 ≤ BF16_REL_L2, max |Δ| ≤ BF16_REL_MAX of
  max |ref|): the float32 sums go in another order, which moves bf16
  roundings that 40 products spread.
* ``one_mm``: the int32 product exact, against the Pallas ``one_mm``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from scripts.probes import mosaic_int8 as jprobe
from eda_dm_tpu_torch.probes import mma_int8 as probe


def _pallas_chain(a, b, kernel, out_dtype, bm):
    m, k = a.shape
    n = b.shape[1]
    return pl.pallas_call(
        kernel, grid=(m // bm,),
        in_specs=[pl.BlockSpec((bm, k), lambda i: (i, 0)),
                  pl.BlockSpec((k, n), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((bm, n), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((m, n), out_dtype), interpret=True)(a, b)


def _inputs(m, k, seed):
    x = probe.probe_inputs(m, k, torch.Generator().manual_seed(seed), "cpu")
    to_jax = lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.int8 if t.dtype == torch.int8 else jnp.bfloat16)
    return x, {name: to_jax(t) for name, t in x.items()}


def test_probe_constants_match_the_jax_probe():
    assert probe.CHAIN == jprobe.CHAIN
    assert [probe.bf16_b_range(k) for k in (128, 256, 512)] == [15, 11, 8]


@pytest.mark.parametrize("m,k,bm", [(256, 128, 128), (64, 256, 32), (32, 512, 32)])
def test_int8_chain_matches_the_jax_probe(m, k, bm):
    x, j = _inputs(m, k, seed=k)
    got = probe.mma_chain_plain(x["a8"], x["b8"]).numpy()
    pallas = np.asarray(_pallas_chain(j["a8"], j["b8"], jprobe.chain_kernel_s8, jnp.int8, bm))
    xla = np.asarray(jax.jit(jprobe.xla_chain_s8)(j["a8"], j["b8"]))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    # on the CPU the wrapper is the plain chain
    assert torch.equal(probe.mma_chain(x["a8"], x["b8"]), torch.from_numpy(got))


@pytest.mark.parametrize("m,k,bm", [(256, 128, 128), (64, 256, 32), (32, 512, 32)])
def test_bf16_chain_matches_the_jax_probe(m, k, bm):
    x, j = _inputs(m, k, seed=k + 1)
    got = probe.mma_chain_plain(x["a16"], x["b16"])
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    for name, ref in (
            ("pallas", _pallas_chain(j["a16"], j["b16"], jprobe.chain_kernel_bf16,
                                     jnp.bfloat16, bm)),
            ("xla", jax.jit(jprobe.xla_chain_bf16)(j["a16"], j["b16"]))):
        ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
        rel_l2, rel_max = probe.bf16_errors(got, ref)
        print(f"[P1 bf16 ({m}, {k}) vs {name}] rel L2 {rel_l2:.3g}, max {rel_max:.3g}")
        assert rel_l2 <= probe.BF16_REL_L2 and rel_max <= probe.BF16_REL_MAX


def test_one_mm_is_exact():
    x, j = _inputs(512, 128, seed=3)

    def one_mm(a_ref, b_ref, o_ref):
        o_ref[...] = jax.lax.dot_general(a_ref[...], b_ref[...], (((1,), (0,)), ((), ())),
                                         preferred_element_type=jnp.int32)
    want = pl.pallas_call(
        one_mm, grid=(1,), in_specs=[pl.BlockSpec((512, 128), lambda i: (0, 0)),
                                     pl.BlockSpec((128, 128), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((512, 128), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((512, 128), jnp.int32), interpret=True)(j["a8"], j["b8"])
    got = probe.one_mm(x["a8"], x["b8"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), x["a8"].numpy().astype(np.int64) @ x["b8"].numpy().astype(np.int64))


def test_probe_main_on_the_host():
    """The probe's entry point with ``device="cpu"``: its checks pass on
    the plain chains and no rate is reported."""
    res = probe.main(device="cpu", shapes=((256, 128),), steps=3)
    assert res[0]["int8_equal"] and res[0]["bf16_ok"] and "int8" not in res[0]
    assert res[-1] == {"one_mm_exact": True}
