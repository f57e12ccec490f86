"""The port's int8 quantized matmul (kernel K8, ``ops/quant_matmul.py``)
and its weight packing, on the CPU.

* The two tests of ``tests/test_pallas_quant.py``, on the port alone: the
  quantized matmul against its fake-quant reference (both operands
  fake-quantized, a float32 product) and the weight pack round trip.
* The port's plain version against the JAX package's Pallas kernel run
  as its own test runs it (``interpret=True``), with that test's block
  sizes and with the defaults, at ragged M, N and K tails, float32 and
  bf16 x, on the same packed weights and quantizers: the int32
  accumulators equal, the outputs within 1e-6·|ref| + 1e-6.  JAX's
  accumulators come out of its kernel with s_x a power of two, s_w = 1
  and no corrections, where ``out / s_x`` is the int32 sum exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.ops import pallas_quant as jpq
from eda_dm_tpu.quant import calculate_qparams as jax_qparams
from eda_dm_tpu.quant import weight_qparams as jax_weight_qparams
from eda_dm_tpu_torch.ops.quant_matmul import (pack_dense_weights, quantize_weights_int8,
                                               quantized_matmul, quantized_matmul_acc)
from eda_dm_tpu_torch.quant import calculate_qparams, fake_quant_nograd, weight_qparams


def _t(a):
    """A JAX array as a torch tensor of the same type (bf16 through float32)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("m,k,n", [(16, 32, 64), (8, 128, 128)])
def test_quantized_matmul_matches_fakequant(m, k, n):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    w = torch.from_numpy(rng.randn(k, n).astype(np.float32) * 0.1)
    bias = torch.from_numpy(rng.randn(n).astype(np.float32))
    s_x, z_x = calculate_qparams(x.min(), x.max(), 256)          # per tensor, 8 bit
    d_w, z_w = weight_qparams(w, 256, symmetric=True, channel_axis=1)
    ref = fake_quant_nograd(x, s_x, z_x, 256) @ fake_quant_nograd(w, d_w, z_w, 256) + bias
    pk = pack_dense_weights(w, d_w, z_w)
    out = quantized_matmul(x, pk["w_q"], s_x, z_x, pk["s_w"], pk["w_colsum"],
                           pk["w_deq_off"], bias=bias)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


def test_int8_weight_pack_roundtrip():
    rng = np.random.RandomState(1)
    w = torch.from_numpy(rng.randn(64, 32).astype(np.float32))
    d_w, z_w = weight_qparams(w, 256, symmetric=True, channel_axis=1)
    w_q, off = quantize_weights_int8(w, d_w.reshape(1, -1), z_w.reshape(1, -1))
    assert w_q.dtype == torch.int8
    deq = w_q.float() * d_w.reshape(1, -1) + off
    np.testing.assert_allclose(deq.numpy(), fake_quant_nograd(w, d_w, z_w, 256).numpy(),
                               rtol=1e-5, atol=1e-6)


# (m, k, n), the JAX kernel's block sizes: its test's, ragged K, M and N
# tails against the blocks, and the defaults
CASES = [((16, 32, 64), dict(block_m=8, block_n=64, block_k=32)),
         ((8, 128, 128), {}),
         ((16, 48, 64), dict(block_k=32)),
         ((20, 32, 64), dict(block_m=8)),
         ((16, 32, 96), dict(block_n=64)),
         ((37, 130, 300), {})]


def _setup(m, k, n, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(m, k).astype(np.float32) * 1.3 + 0.2, dtype)
    w = jnp.asarray(rng.randn(k, n).astype(np.float32) * 0.1)
    bias = jnp.asarray(rng.randn(n).astype(np.float32))
    s_x, z_x = jax_qparams(jnp.min(x).astype(jnp.float32), jnp.max(x).astype(jnp.float32), 256)
    d_w, z_w = jax_weight_qparams(w, 256, symmetric=True, channel_axis=1)
    return x, w, bias, s_x, z_x, d_w, z_w


@pytest.mark.parametrize("case,blocks", CASES, ids=lambda c: "x".join(map(str, c))
                         if isinstance(c, tuple) else ",".join(f"{v}" for v in c.values()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_matmul_matches_jax(case, blocks, dtype):
    x, w, bias, s_x, z_x, d_w, z_w = _setup(*case, dtype)
    pk = jpq.pack_dense_weights(w, d_w, z_w)
    ref = jpq.quantized_matmul(x, pk["w_q"], s_x, z_x, pk["s_w"], pk["w_colsum"],
                               pk["w_deq_off"], bias=bias, interpret=True, **blocks)
    tpk = pack_dense_weights(_t(w), _t(d_w), _t(z_w))
    for key in pk:                                   # the packing itself is exact
        np.testing.assert_array_equal(tpk[key].numpy(), np.asarray(pk[key]))
    out = quantized_matmul(_t(x), tpk["w_q"], _t(s_x), _t(z_x), tpk["s_w"],
                           tpk["w_colsum"], tpk["w_deq_off"], _t(bias))
    assert out.dtype == getattr(torch, dtype) and out.shape == case[::2]
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(out.float().numpy() - ref)
    print(f"[K8 {case} {dtype}] max |d| {err.max():.3g}")
    assert np.all(err <= 1e-6 * np.abs(ref) + 1e-6)


@pytest.mark.parametrize("case,blocks", CASES, ids=lambda c: "x".join(map(str, c))
                         if isinstance(c, tuple) else ",".join(f"{v}" for v in c.values()))
def test_quantized_matmul_accumulators_match_jax(case, blocks):
    m, k, n = case
    x, w, _, _, _, d_w, z_w = _setup(m, k, n, "float32", seed=1)
    pk = jpq.pack_dense_weights(w, d_w, z_w)
    s_x, z_x = np.float32(2.0 ** -5), np.float32(131.0)
    ones, zeros = jnp.ones((n,), jnp.float32), jnp.zeros((n,), jnp.float32)
    scaled = jpq.quantized_matmul(x, pk["w_q"], jnp.float32(s_x), jnp.float32(z_x), ones,
                                  zeros, zeros, interpret=True, **blocks)
    want = np.asarray(scaled) / s_x
    got = quantized_matmul_acc(_t(x), _t(pk["w_q"]), torch.tensor(s_x), torch.tensor(z_x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("per_channel", [True, False])
def test_pack_dense_weights_matches_jax(per_channel):
    """Codes, scales, float32 column sums and offsets equal, per output
    channel and for a scalar quantizer."""
    rng = np.random.RandomState(2)
    w = jnp.asarray(rng.randn(40, 24).astype(np.float32) * 0.3)
    d_w, z_w = jax_weight_qparams(w, 16, symmetric=False,
                                  channel_axis=1 if per_channel else None)
    want = jpq.pack_dense_weights(w, d_w, z_w, 16)
    got = pack_dense_weights(_t(w), _t(d_w), _t(z_w), 16)
    assert got["w_colsum"].dtype == torch.float32 and got["w_deq_off"].shape == (24,)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
