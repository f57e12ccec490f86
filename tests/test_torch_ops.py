"""Plain versions of the port's kernels vs the JAX package on the CPU.

* act codes of ``quantize_act_int8``: equal;
* int8 bmm (kernel K2's plain version) vs ``int8_code_einsum``: int32
  accumulators equal, outputs rtol 1e-6 (f32 epilogue in the same order);
* softmax codes (K3's plain version) vs the Pallas kernel in interpret
  mode: every code within ±1, ≥ 99.9 % equal (reduction order may differ),
  at rows of 16, 64, 256 and the ragged 77 (SD's text context) and 300;
* K3's plan (``softmax_plan``) at the widths the model zoos hand it: every
  element of every row taken once by a model of the kernel's loops, within
  the H100's shared memory, the constants read from the kernel's source;
* int8 conv (K1's plain version) inside the port's QConv vs a JAX QConv
  in DEPLOY_INT8 on a shared input and a shared exported state:
  rtol = atol = 2e-5 (the bound of tests/test_export.py's exact-codes test);
* K2's plan (``bmm_plan``): the tile by the number of columns, the load
  route by K and the operands' alignment, at the serving shapes the card
  runs;
* K1's plan (``conv_plan``) at every conv of the full CIFAR, bedroom, SD
  and ImageNet UNets (built on the meta device): the 16-byte route wherever
  Cin % 16 == 0, the byte gather at the ``conv_in``s, the 128 x 64 tile
  only where Cout ≤ 64; each tile's ring (step and slots fixed per route in
  ``csrc/int8_conv.cu``) within the card's 227 KB of shared memory a
  block.
"""

import re
from pathlib import Path

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
from eda_dm_tpu_torch.ops.int8_conv import border_map, conv_plan, int8_conv
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


@pytest.mark.parametrize("s", [256, 64, 16, 77, 300])
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


@pytest.mark.parametrize("m,n,k,ptrs,plan", [
    (256, 256, 256, (0, 0), (tein.TILE_LARGE, tein.ROUTE_16)),    # CIFAR q·k
    (16, 16, 256, (0, 0), (tein.TILE_SMALL, tein.ROUTE_16)),      # CIFAR mid block
    (16, 256, 16, (0, 0), (tein.TILE_LARGE, tein.ROUTE_16)),      # its W·V
    (4096, 77, 40, (0, 0), (tein.TILE_SMALL, tein.ROUTE_8)),      # SD cross q·k
    (4096, 40, 77, (0, 0), (tein.TILE_SMALL, tein.ROUTE_GATHER)), # SD cross W·V
    (4096, 160, 80, (0, 0), (tein.TILE_LARGE, tein.ROUTE_16)),    # 80 % 16 == 0
    (32768, 2560, 320, (0, 0), (tein.TILE_LARGE, tein.ROUTE_16)), # SD GEGLU dense
    (500, 512, 512, (0, 8), (tein.TILE_LARGE, tein.ROUTE_8)),     # an 8-aligned operand
    (500, 512, 512, (4, 0), (tein.TILE_LARGE, tein.ROUTE_GATHER)),
    (81, 81, 20, (0, 0), (tein.TILE_LARGE, tein.ROUTE_GATHER)),
])
def test_bmm_plan(m, n, k, ptrs, plan):
    assert tein.bmm_plan(n, k, *ptrs) == plan


def _conv_shapes(which):
    """(Cin, Cout, kernel, strides) of every QConv of a full UNet."""
    from unittest import mock
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
    from eda_dm_tpu_torch.models.latent_diffusion import (bedroom_config, imagenet_config,
                                                          sd_v1_config)
    from eda_dm_tpu_torch.models.ldm_unet import LDMUNet
    from eda_dm_tpu_torch.quant import QuantConfig as TQC
    qc = TQC(weight_bit=4, act_bit=8)
    build = {"cifar": lambda: DDPMUNet(DDPMConfig(), qc, device="meta"),
             "bedroom": lambda: LDMUNet(bedroom_config().unet, qc, device="meta"),
             "sd": lambda: LDMUNet(sd_v1_config().unet, qc, device="meta"),
             "imagenet": lambda: LDMUNet(imagenet_config().unet, qc, device="meta")}[which]
    with mock.patch.object(DDPMUNet, "init_weights", lambda *a: None), \
            mock.patch.object(LDMUNet, "init_weights", lambda *a: None):
        model = build()
    return sorted({(m.weight.shape[1], m.weight.shape[0], m.kernel_size, m.strides)
                   for m in model.modules() if isinstance(m, QConv)})


@pytest.mark.parametrize("which,n_shapes,conv_in", [("cifar", 17, 3), ("bedroom", 35, 3),
                                                   ("sd", 29, 4), ("imagenet", 38, 3)])
def test_conv_plan_every_unet_conv(which, n_shapes, conv_in):
    shapes = _conv_shapes(which)
    assert len(shapes) == n_shapes
    assert sum(cin % 16 != 0 for cin, *_ in shapes) == 1
    for cin, cout, k, stride in shapes:
        route = tein.ROUTE_GATHER if cin == conv_in else tein.ROUTE_16
        tile = tein.TILE_SMALL if cout <= 64 else tein.TILE_LARGE
        assert conv_plan(cin, cout, 0, 256) == (tile, route), (cin, cout, k, stride)
    assert sum(cout <= 64 for _, cout, *_ in shapes) == 1      # conv_out


@pytest.mark.parametrize("cin,ptrs,route", [
    (224, (0, 0), tein.ROUTE_16), (24, (0, 0), tein.ROUTE_8),
    (128, (8, 0), tein.ROUTE_8), (128, (0, 4), tein.ROUTE_GATHER),
    (3, (0, 0), tein.ROUTE_GATHER), (4, (0, 0), tein.ROUTE_GATHER)])
def test_conv_plan_route(cin, ptrs, route):
    """The route by Cin and both operands' alignment, at either tile."""
    assert conv_plan(cin, 128, *ptrs) == (tein.TILE_LARGE, route)
    assert conv_plan(cin, 64, *ptrs) == (tein.TILE_SMALL, route)


@pytest.mark.parametrize("tile_n", [128, 64])
def test_conv_ring_fits_shared_memory(tile_n):
    """K1's 16-byte ring as ``csrc/int8_conv.cu`` fixes it, and the narrow
    routes' 64-byte steps in 4 slots, fit the H100's 227 KB of shared
    memory a block at either tile (128 pixels by ``tile_n`` channels)."""
    src = (Path(tein.__file__).parent.parent / "csrc" / "int8_conv.cu").read_text()
    k1 = {name: int(v) for name, v in re.findall(r"#define (K1_\w+) (\d+)", src)}
    for kstep, stages in ((k1["K1_KSTEP"], k1["K1_STAGES"]), (64, 4)):
        assert stages * (128 + tile_n) * (kstep + 16) <= 227 * 1024


# K3's rows as the model zoos hand them (rows, S): CIFAR's 16x16 and 4x4
# sites at batch 500, bedroom's 8x8 at batch 50 (28 heads), SD's
# cross-attentions at 8 rows (8 heads of 4096 to 64 queries over 77 text
# tokens), and the self-attention widths the einsum branch takes where the
# fused kernels are switched off (EDM_FUSED_ATTN=0): 1024 and 4096
K3_ZOO = [(500 * 256, 256), (500 * 16, 16), (50 * 28 * 64, 64), (64 * 4096, 77),
          (64 * 1024, 77), (64 * 256, 77), (64 * 64, 77), (8 * 1024, 1024),
          (64 * 4096, 4096), (333, 300), (7, 1), (5, 33), (2, 5000), (2, 8193),
          (2, 32768)]


def _k3_cover(r, s, plan):
    """How many times the kernel's loops take each element of each row:
    tile b holds rows b·rows …, thread (group, t) takes row group + k·rpi
    of a tile and its elements t + i·tpr, i < nmax (the blocks of the
    persistent grid walk whole tiles)."""
    tpr, nmax, rows, threads = (plan[k] for k in ("tpr", "nmax", "rows", "threads"))
    rpi = threads // tpr
    counts = np.zeros((r, s), np.int64)
    for row0 in range(0, r, rows):
        nrows = min(rows, r - row0)
        for grp in range(rpi):
            for rr in range(grp, grp + rows, rpi):
                if rr - grp >= rows or rr >= nrows:
                    continue
                for t in range(tpr):
                    j = np.arange(nmax) * tpr + t
                    np.add.at(counts[row0 + rr], j[j < s], 1)
    return counts


@pytest.mark.parametrize("r,s", K3_ZOO, ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_softmax_plan_covers_every_element_once(r, s, dtype):
    """``softmax_plan`` at the zoos' widths: a thread count the kernel
    takes, tpr·nmax ≥ S with nmax a template constant, the tile and codes
    within the H100's shared memory, enough blocks to fill the card where
    the rows allow, and (on a cut of the rows) every element of every row
    taken exactly once by a model of the kernel's loops."""
    from eda_dm_tpu_torch.ops.softmax_codes import (K3_MAX_THREADS, K3_MIN_BLOCKS, K3_NMAX,
                                                    K3_WIDE_THREADS, k3_smem_bytes,
                                                    k3_stride, softmax_plan)
    esz = torch.empty((), dtype=dtype).element_size()
    plan = softmax_plan(r, s, dtype)
    tpr, nmax, rows, threads = (plan[k] for k in ("tpr", "nmax", "rows", "threads"))
    assert tpr & (tpr - 1) == 0 and (tpr <= 32 or tpr % 32 == 0)
    assert threads % 32 == 0 and threads % tpr == 0 and threads <= K3_MAX_THREADS
    assert threads <= K3_WIDE_THREADS or nmax == K3_NMAX[-1]
    assert nmax in K3_NMAX and tpr * nmax >= s and (nmax == 1 or tpr * nmax < 2 * s)
    assert rows % (threads // tpr) == 0
    assert plan["smem"] == k3_smem_bytes(rows, s, esz, tpr, plan["buffers"]) <= 232_448
    assert plan["buffers"] == 2 or k3_smem_bytes(rows, s, esz, tpr, 2) > 232_448
    stride = k3_stride(s, esz, tpr)              # the rows of a warp in distinct banks
    if stride != s:
        banks = {(rr * stride + t) % 32 for rr in range(32 // tpr) for t in range(tpr)}
        assert stride * esz % 16 == 0 and len(banks) == 32
    if r >= K3_MIN_BLOCKS * (threads // tpr):     # rows enough for whole iterations
        assert -(-r // rows) >= K3_MIN_BLOCKS // 2
    cut = min(r, 2 * rows + 3)                    # two whole blocks and a ragged one
    assert (_k3_cover(cut, s, plan) == 1).all()


def test_k3_constants_match_the_source():
    """The plan's copy of K3's fixed sizes (threads a block, the elements a
    thread may hold) equals ``csrc/softmax_codes.cu``'s, the source's
    layout is the one ``k3_smem_bytes`` computes, and its entry point takes
    the plan's entries in ``K3_PLAN_ARGS``'s order."""
    from eda_dm_tpu_torch.ops.softmax_codes import (K3_MAX_THREADS, K3_NMAX, K3_PLAN_ARGS,
                                                    K3_WIDE_THREADS)
    src = (Path(tein.__file__).parent.parent / "csrc" / "softmax_codes.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["MAX_THREADS"], const["WIDE_THREADS"], const["NMAX_MAX"]) == (
        K3_MAX_THREADS, K3_WIDE_THREADS, K3_NMAX[-1])
    cases = [int(v) for v in re.findall(r"case (\d+): return launch<\1, InT>", src)]
    assert tuple(cases) + (const["NMAX_MAX"],) == K3_NMAX
    layout = src[src.index("inline Layout k3_layout("):]
    layout = layout[:layout.index("return l;")]
    for part in ("l.tile = (rows * P * esz + 16 + 15) / 16 * 16", "l.codes = buffers * l.tile",
                 "l.rmax = l.codes + (rows * S + 16 + 15) / 16 * 16",
                 "l.rsum = l.rmax + WARPS_MAX * 4", "l.dump = l.rsum + WARPS_MAX * 8",
                 "l.total = l.dump + 16"):
        assert part in layout, part
    assert "return esz == 4 && S % 4 == 0 && tpr < 32 ? S + ((tpr - S) & 31) : S;" in src
    entry = src[src.index('extern "C" int edm_softmax_codes('):]
    entry = entry[:entry.index("{")]
    assert re.findall(r"int (tpr|nmax|rows|buffers|threads|smem)\b", entry) == list(K3_PLAN_ARGS)
