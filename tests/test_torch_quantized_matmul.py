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
* A bf16 x with a Python-float s_x, where the JAX package's row-sum pass
  divides in bf16 (weak typing) and its kernel in float32: the port's
  output equals JAX's bit for bit (tolerance 0), on an input where
  hundreds of codes differ between the two divisions.
* The kernel's plan, which the CPU reaches only as arithmetic: the
  resident stripe up to K = 512, the streamed path beyond, the load route
  of the K-major weight copy by K and alignment, and that copy itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.ops import pallas_quant as jpq
from eda_dm_tpu.quant import calculate_qparams as jax_qparams
from eda_dm_tpu.quant import weight_qparams as jax_weight_qparams
from eda_dm_tpu_torch.ops.quant_matmul import (jax_row_term, pack_dense_weights, qm_plan,
                                               quantize_weights_int8, quantize_x_int8,
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


@pytest.mark.parametrize("z_kind", ["python", "array"])
def test_bf16_row_term_follows_jax(z_kind):
    """bf16 x, s_x a Python float: JAX's kernel quantizes in float32, its
    row-sum pass outside the kernel divides in bf16 (and with a Python z_x
    also rounds the row sum and s_x·row to bf16).  The port reproduces that
    pass (``jax_row_term``); its output equals JAX's exactly."""
    rng = np.random.RandomState(3)
    m, k, n = 48, 160, 96
    x = jnp.asarray(rng.randn(m, k).astype(np.float32) * 1.9 + 0.3, jnp.bfloat16)
    w = jnp.asarray(rng.randn(k, n).astype(np.float32) * 0.1)
    bias = jnp.asarray(rng.randn(n).astype(np.float32))
    d_w, z_w = jax_weight_qparams(w, 256, symmetric=True, channel_axis=1)
    pk = jpq.pack_dense_weights(w, d_w, z_w)
    s_x = 0.0371
    z_x = 117.0 if z_kind == "python" else jnp.float32(117.0)
    ref = jpq.quantized_matmul(x, pk["w_q"], s_x, z_x, pk["s_w"], pk["w_colsum"],
                               pk["w_deq_off"], bias=bias, interpret=True)
    tx = _t(x)
    tz = z_x if z_kind == "python" else _t(z_x)
    tpk = pack_dense_weights(_t(w), _t(d_w), _t(z_w))
    out = quantized_matmul(tx, tpk["w_q"], s_x, tz, tpk["s_w"], tpk["w_colsum"],
                           tpk["w_deq_off"], _t(bias))
    f32_codes = quantize_x_int8(tx, s_x, 117.0)
    bf16_codes = torch.clamp(torch.round(
        (tx.float() / torch.tensor(s_x, dtype=torch.bfloat16).float()).to(torch.bfloat16)
        .float()) + 117.0, 0.0, 255.0) - 128.0
    flips = int((f32_codes != bf16_codes).sum())
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(out.float().numpy() - ref)
    print(f"[K8 bf16 x, Python s_x, {z_kind} z_x] {flips} of {m * k} codes differ "
          f"between the float32 and the bf16 division; max |d| from JAX {err.max():.3g}")
    assert flips > 0 and jax_row_term(tx, s_x, tz) is not None
    assert err.max() == 0.0


def test_row_term_is_the_kernels_where_jax_stays_float32():
    """No departure where every step of JAX's outside pass is float32: an
    f32 x, or array-typed s_x and z_x."""
    x = torch.randn(4, 8)
    assert jax_row_term(x, 0.1, 3.0) is None
    assert jax_row_term(x.to(torch.bfloat16), torch.tensor(0.1), torch.tensor(3.0)) is None
    assert jax_row_term(x.to(torch.bfloat16), 0.1, 3.0) is not None


@pytest.mark.parametrize("k,ptr,plan", [
    (320, 0, (0, 16)),          # SD's GEGLU dense: resident stripe, 16-byte copies
    (512, 256, (0, 16)),        # the largest resident stripe
    (513, 0, (1, 1)),           # beyond: streamed, byte gather
    (640, 8, (1, 8)),           # streamed, 8-byte copies (base 8-aligned)
    (200, 0, (0, 8)),           # K % 16 == 8
    (130, 0, (0, 1)),           # the JAX test's ragged K
])
def test_kernel_plan(k, ptr, plan):
    assert qm_plan(k, ptr) == plan


def test_pack_has_the_k_major_copy():
    w = torch.randn(40, 24)
    pk = pack_dense_weights(w, torch.full((24,), 0.02), torch.full((24,), 128.0))
    assert pk["w_qt"].shape == (24, 40) and pk["w_qt"].is_contiguous()
    assert torch.equal(pk["w_qt"], pk["w_q"].t())
