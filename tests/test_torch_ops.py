"""Plain versions of the port's kernels vs the JAX package on the CPU.

* act codes of ``quantize_act_int8``: equal;
* int8 bmm (kernel K2's plain version) vs ``int8_code_einsum``: int32
  accumulators equal, outputs rtol 1e-6 (f32 epilogue in the same order);
* softmax codes (K3's plain version) vs the Pallas kernel in interpret
  mode: every code within ±1, ≥ 99.9 % equal (reduction order may differ);
* int8 conv (K1's plain version) inside the port's QConv vs a JAX QConv
  in DEPLOY_INT8 on a shared input and a shared exported state:
  rtol = atol = 2e-5 (the bound of tests/test_export.py's exact-codes test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.nn.layers import QConv as JQConv, QDense as JQDense
from eda_dm_tpu.ops import int8_einsum as jein
from eda_dm_tpu.ops.pallas_softmax import softmax_int8_codes as j_softmax_codes
from eda_dm_tpu.quant import CALIB_A, CALIB_W, FP, QuantConfig
from eda_dm_tpu.quant.export import DEPLOY_INT8 as J_DEPLOY_INT8
from eda_dm_tpu.quant.export import export_serving_int8 as j_export_int8
from eda_dm_tpu_torch.models.bridge import load_jax_variables, to_jax_variables
from eda_dm_tpu_torch.nn.layers import QConv, QDense
from eda_dm_tpu_torch.ops import int8_einsum as tein
from eda_dm_tpu_torch.ops.int8_conv import border_map, int8_conv
from eda_dm_tpu_torch.ops.softmax_codes import softmax_int8_codes
from eda_dm_tpu_torch.quant import DEPLOY_INT8

QC = QuantConfig(weight_bit=4, act_bit=8)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("zp", [0.0, 77.0, 128.0])
def test_quantize_act_int8_codes_equal(dtype, zp):
    rng = np.random.default_rng(int(zp))
    x = (2.0 * rng.standard_normal((8, 33, 40))).astype(np.float32)
    delta = np.float32(0.021)
    jc, jcc = jein.quantize_act_int8(jnp.asarray(x, getattr(jnp, dtype)),
                                     jnp.float32(delta), jnp.float32(zp), 256)
    tc, tcc = tein.quantize_act_int8(_t(x).to(getattr(torch, dtype)),
                                     torch.tensor(delta), torch.tensor(zp), 256)
    assert tc.dtype == torch.int8
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert float(tcc) == float(jcc)


def _codes(rng, shape, lo=-128, hi=127):
    return rng.integers(lo, hi + 1, shape).astype(np.int8)


@pytest.mark.parametrize("eq,sa,sb", [
    ("nic,njc->nij", (3, 64, 32), (3, 48, 32)),
    ("nij,njc->nic", (3, 64, 48), (3, 48, 32)),
    ("nic,njc->nij", (2, 16, 256), (2, 16, 256)),
])
def test_int8_code_einsum(eq, sa, sb):
    rng = np.random.default_rng(sum(sa))
    A, B = _codes(rng, sa), _codes(rng, sb)
    ca, cb, da, db = 11.0, -3.0, 0.013, 0.0071
    ref = np.asarray(jein.int8_code_einsum(
        eq, jnp.asarray(A), jnp.float32(ca), jnp.float32(da),
        jnp.asarray(B), jnp.float32(cb), jnp.float32(db)))
    out = tein.int8_code_einsum(eq, _t(A), torch.tensor(ca), torch.tensor(da),
                                _t(B), torch.tensor(cb), torch.tensor(db))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    # the plain K2 accumulators are the exact int32 einsum
    j_acc = np.asarray(jnp.einsum(eq, jnp.asarray(A), jnp.asarray(B),
                                  preferred_element_type=jnp.int32))
    Bt = _t(B) if eq.startswith("nic") else _t(B).transpose(1, 2).contiguous()
    acc = tein.int8_bmm_acc_plain(_t(A), Bt)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), j_acc)


@pytest.mark.parametrize("s", [256, 64, 16])
def test_softmax_codes(s):
    rng = np.random.default_rng(s)
    logits = (6.0 * rng.standard_normal((96, s))).astype(np.float32)
    for delta, zp in ((1.0 / 255.0, 0.0), (0.004, 7.0)):
        jc, jcc = j_softmax_codes(jnp.asarray(logits), delta, zp, 256,
                                  interpret=True)
        tc, tcc = softmax_int8_codes(_t(logits), torch.tensor(delta),
                                     torch.tensor(zp), 256)
        assert tc.dtype == torch.int8 and float(tcc) == float(jcc)
        diff = np.abs(tc.numpy().astype(np.int32) - np.asarray(jc, np.int32))
        assert diff.max() <= 1
        assert (diff == 0).mean() >= 0.999


def _jax_int8_layer(module, x):
    """Calibrate a JAX layer on ``x`` (CALIB_W → CALIB_A) and export it for
    DEPLOY_INT8 with the f32 carrier; returns (exported tree, output)."""
    key = jax.random.PRNGKey(0)
    v = module.init(key, x, FP)
    _, upd = module.apply(v, x, CALIB_W, mutable=["quant"])
    v = {**v, "quant": upd["quant"]}
    _, upd = module.apply(v, x, CALIB_A, mutable=["quant"])
    v = {**v, "quant": upd["quant"]}
    tree = j_export_int8(v, QC, dtype=jnp.float32)
    out = module.apply(tree, x, J_DEPLOY_INT8)
    return jax.tree.map(np.asarray, tree), np.asarray(out)


CONV_CASES = {
    "3x3_same": dict(hw=12, cin=32, cout=64, k=(3, 3), s=(1, 1), pad="SAME"),
    "3x3_s2_downsample": dict(hw=12, cin=32, cout=32, k=(3, 3), s=(2, 2),
                              pad=((0, 1), (0, 1))),
    "1x1": dict(hw=8, cin=64, cout=32, k=(1, 1), s=(1, 1), pad="VALID"),
    "conv_in_cin3": dict(hw=16, cin=3, cout=32, k=(3, 3), s=(1, 1), pad="SAME"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_int8_conv_matches_jax_qconv(case):
    p = CONV_CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal((2, p["hw"], p["hw"], p["cin"])).astype(np.float32)
    jconv = JQConv(p["cout"], p["k"], strides=p["s"], padding=p["pad"],
                   wq=QC.wq, aq=QC.aq)
    tree, ref = _jax_int8_layer(jconv, jnp.asarray(x))
    conv = QConv(p["cin"], p["cout"], p["k"], strides=p["s"], padding=p["pad"],
                 wq=QC.wq, aq=QC.aq)
    load_jax_variables(conv, tree)
    with torch.no_grad():
        out = conv(_t(x), DEPLOY_INT8)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    # the bridge round-trips every leaf the serving path reads
    back = to_jax_variables(conv)
    np.testing.assert_array_equal(back["quant"]["w0_int"], tree["quant"]["w0_int"])
    np.testing.assert_array_equal(back["params"]["kernel"], tree["params"]["kernel"])


@pytest.mark.parametrize("case", ["3x3_same", "3x3_s2_downsample"])
def test_border_map_is_indicator_conv(case):
    """border == the JAX package's VALID int32 conv of the pad indicator."""
    p = CONV_CASES[case]
    rng = np.random.default_rng(5)
    kh, kw = p["k"]
    w = _codes(rng, (kh, kw, p["cin"], p["cout"]), -8, 7)          # HWIO
    pads = (((1, 1), (1, 1)) if p["pad"] == "SAME" else p["pad"])
    h = p["hw"]
    ind = jnp.pad(jnp.zeros((1, h, h, p["cin"]), jnp.int8),
                  ((0, 0), pads[0], pads[1], (0, 0)), constant_values=1)
    ref = jax.lax.conv_general_dilated(
        ind, jnp.asarray(w), window_strides=p["s"], padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)[0]
    got = border_map(_t(w).permute(3, 0, 1, 2).contiguous(), h, h, p["s"], pads)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_int8_dense_matches_jax_qdense():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    tree, ref = _jax_int8_layer(JQDense(48, wq=QC.wq, aq=QC.aq), jnp.asarray(x))
    dense = QDense(64, 48, wq=QC.wq, aq=QC.aq)
    load_jax_variables(dense, tree)
    with torch.no_grad():
        out = dense(_t(x), DEPLOY_INT8)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_cpu_dispatch_runs_plain_and_bf16_carrier():
    """On CPU tensors the wrappers run their plain versions; a bf16 carrier
    gets a bf16 output from the same f32 epilogue."""
    rng = np.random.default_rng(3)
    codes = _t(_codes(rng, (2, 6, 6, 32)))
    w = _t(_codes(rng, (16, 3, 3, 32), -8, 7))
    isum = w.float().sum((1, 2, 3))
    pads = ((1, 1), (1, 1))
    border = border_map(w, 6, 6, (1, 1), pads)
    args = (codes, w, isum, torch.tensor(3.0), torch.full((16,), 0.01),
            torch.zeros(16), (1, 1), pads, border)
    f32 = int8_conv(*args, torch.float32)
    bf16 = int8_conv(*args, torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16.float().numpy(),
                                  f32.to(torch.bfloat16).float().numpy())
