"""The port's fused fake-quant matmul (kernel K7, ``ops/quant_matmul.py``)
vs the JAX package's Pallas kernel (``eda_dm_tpu/ops/pallas_quant.py::
fakequant_matmul``, interpret mode).

* The plain version against JAX's kernel: float32 and bf16 operands,
  per-tensor rows and a split layer's two channel ranges, with and without
  a bias, at ragged M, K, N.  The quantized operand is the same in both;
  only the order of the float32 sums differs, so float32 within
  rtol = atol = 1e-5 and a bf16 output within one bf16 step.
* The weights reach the kernel in the JAX layout (K, N) as the port's
  transposed ``[out, in]`` view, without a copy.
* ``QConv`` (1×1, split) and ``QDense`` in DEPLOY_FUSED against the same
  layers in DEPLOY: equal on the CPU, where both run the same float32
  product.

The tiny DDPM in DEPLOY_FUSED against JAX is held in
``tests/test_torch_ddpm.py``, beside its JAX-calibrated fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.ops import pallas_quant as jpq
from eda_dm_tpu_torch.nn.layers import QConv, QDense
from eda_dm_tpu_torch.ops.quant_matmul import fakequant_matmul
from eda_dm_tpu_torch.quant import DEPLOY, DEPLOY_FUSED, QuantizerSpec

from test_torch_gn import _bf16_steps
from test_torch_ddpm import _torch


def _case(m, k, n, split, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 1.7 + 0.2).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    d = np.where(np.arange(k) < (split or k), 0.031, 0.017).astype(np.float32)
    zp = np.where(np.arange(k) < (split or k), 121.0, 64.0).astype(np.float32)
    bias = (rng.standard_normal(n) * 0.5).astype(np.float32)
    return x, w, d, zp, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", [0, 40])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fakequant_matmul_matches_jax(dtype, split, with_bias):
    x, w, d, zp, bias = _case(70, 96, 45, split)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    ref = jpq.fakequant_matmul(jx, jw, jnp.asarray(d), jnp.asarray(zp), 256,
                               jnp.asarray(bias) if with_bias else None,
                               interpret=True)
    # the port's [out, in] storage, passed as its (K, N) view
    wt = _torch(jw.T).t()
    out = fakequant_matmul(_torch(jx), wt, torch.from_numpy(d),
                           torch.from_numpy(zp), 256,
                           torch.from_numpy(bias) if with_bias else None)
    assert out.dtype == getattr(torch, dtype) and not wt.is_contiguous()
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert _bf16_steps(out.float().numpy(), ref).max() <= 1.0


def test_identity_weight_gives_the_fake_quant():
    """With an identity w the product is the fake-quant of x itself."""
    from eda_dm_tpu_torch.quant.affine import fake_quant
    x, _, d, zp, _ = _case(33, 64, 64, 0)
    x = torch.from_numpy(x)
    out = fakequant_matmul(x, torch.eye(64), torch.from_numpy(d),
                           torch.from_numpy(zp), 256)
    assert torch.equal(out, fake_quant(x, torch.tensor(d[0]),
                                       torch.tensor(zp[0]), 256))


def _set_quantizers(layer, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        layer.weight.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(seed))
        if getattr(layer, "bias", None) is not None:
            layer.bias.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(seed + 1))
        for i, q in enumerate(m for m in layer.modules() if hasattr(m, "zero_point")):
            q.delta.fill_(float(rng.uniform(0.01, 0.05)))
            q.zero_point.fill_(float(100 + 20 * i))


@pytest.mark.parametrize("layer", ["conv_1x1_split", "conv_1x1", "dense"])
def test_fused_layers_match_deploy(layer):
    wq, aq = QuantizerSpec(4), QuantizerSpec(8)
    if layer == "dense":
        m = QDense(48, 24, wq=wq, aq=aq)
        x = torch.randn(5, 7, 48, generator=torch.Generator().manual_seed(2))
    else:
        m = QConv(48, 24, (1, 1), padding="VALID", wq=wq, aq=aq,
                  split=32 if layer.endswith("split") else 0)
        x = torch.randn(2, 6, 5, 48, generator=torch.Generator().manual_seed(2))
    _set_quantizers(m, 7)
    with torch.no_grad():
        fused, ref = m(x, DEPLOY_FUSED), m(x, DEPLOY)
    assert fused.shape == ref.shape
    torch.testing.assert_close(fused, ref, rtol=0, atol=0)


# K7's calls in a DEPLOY_FUSED CIFAR forward at batch 500, (M, K, N): the
# attention 1x1s at 16x16, nin_shortcuts at each resolution (the up path's
# concatenated inputs), the timestep denses; and the card tests' ragged ones
FQ_SITES = [(500 * 256, 256, 256), (500 * 1024, 384, 128), (500 * 256, 128, 256),
            (500 * 256, 512, 256), (500 * 64, 512, 256), (500 * 16, 512, 256),
            (500, 128, 512), (500, 512, 512), (500, 512, 256), (37, 70, 45), (200, 33, 7)]


@pytest.mark.parametrize("m,k,n", FQ_SITES, ids=lambda v: str(v))
def test_fq_plan_at_the_cifar_sites(m, k, n):
    """``fq_plan``'s columns a block: all of N (N ≤ 256; tiles of 256
    past it), so x is fake-quantized once a tile of 256 columns, where the
    rows give the card at least one row tile an SM; else 64-column tiles,
    so the few row tiles still spread over the SMs."""
    from eda_dm_tpu_torch.ops.quant_matmul import FQ_BM, FQ_BNS, FQ_SMS, fq_plan
    bn = fq_plan(m, n)
    assert bn in FQ_BNS
    row_tiles = -(-m // FQ_BM)
    if row_tiles < FQ_SMS:
        assert bn == 64 and row_tiles * -(-n // bn) >= min(FQ_SMS, row_tiles * -(-n // 64))
    else:
        assert bn >= min(n, 256) and (bn == 64 or bn // 2 < n)


def test_k7_constants_match_the_source():
    """The plan's copy of K7's tensor-core tile (rows a block, the columns
    a block may take) equals ``csrc/fakequant_matmul.cu``'s, its entry
    point takes the plan's columns, and each instance's shared memory
    lets two blocks share an SM (its launch bounds' two)."""
    import re
    from pathlib import Path
    from eda_dm_tpu_torch.ops import quant_matmul as qm
    src = (Path(qm.__file__).parent.parent / "csrc" / "fakequant_matmul.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const["TC_BM"] == qm.FQ_BM
    bns = [int(v) for v in re.findall(r"launch_tc<(\d+), KMAJOR>", src)]
    assert tuple(sorted(set(bns))) == qm.FQ_BNS
    assert "__launch_bounds__(TC_THREADS, 2)" in src
    a_ld = const["TC_BK"] + 8
    for bn in qm.FQ_BNS:
        for kmajor in (True, False):
            stage = bn * a_ld * 2 if kmajor else const["TC_BK"] * (bn + 8) * 2
            smem = (const["TC_STAGES"] * stage + 2 * const["TC_BM"] * a_ld * 2
                    + 3 * const["TC_BK"] * 16 + bn * 4)
            assert 2 * (smem + 1024) <= 228 * 1024, (bn, kmajor)
            assert const["TC_STAGES"] * stage >= const["TC_BM"] * (bn + 8) * 2  # the output tile
    entry = src[src.index('extern "C" int edm_fakequant_matmul('):]
    assert re.search(r"int n_levels,\s*int bn, void\* stream\)", entry[:entry.index("{")])
