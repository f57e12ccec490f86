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
* ``gn_plan`` (K6's launch plan): within the H100's shared memory, at most
  8 blocks a cluster, and, replayed through a model of the kernel's loops,
  every pixel, group and rim byte taken exactly once, at every shape the
  gate admits over a grid; its fixed sizes and layout those of
  ``csrc/gn_int8.cu``.
"""

import collections
import pathlib
import re

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


# --------------------------------------------------------------------------
# K6's plan, replayed through a model of the kernel's loops


def _shuffle_holders(v):
    """The in-warp tree of ``publish`` (V ≤ 32): lane l adds lane l + d for
    d = V, 2V, 4V, … < 32.  Returns, for each holder lane l < V, the lanes
    whose values it ends with (each counted)."""
    held = [[lane] for lane in range(32)]
    d = v
    while d < 32:
        held = [held[lane] + held[lane + d] if lane + d < 32 else held[lane]
                for lane in range(32)]
        d *= 2
    return held[:min(v, 32)]


def _k6_model(h, w, c, esz, plan, pads, num_groups=32):
    """One batch element through K6's loops under ``plan``: the writes of
    every padded output byte, and, per group, the input slots its sum
    gathers (through the fold, the holders and the group stage)."""
    from eda_dm_tpu_torch.ops.gn_int8 import K6_MAX_THREADS, K6_SHFL_MAX_V, gn_partials
    (pt, pb), (pl, pr) = pads
    hp_, wp_ = h + pt + pb, w + pl + pr
    npix, g, e = h * w, c // num_groups, 16 // esz
    span, r, pix, lanes, threads = (plan[k] for k in ("span", "r", "pix", "lanes", "threads"))
    v_, k = span // e, span // g
    vc = min(v_, K6_MAX_THREADS)
    ng = gn_partials(span, g, esz)
    hv = threads // 32 if v_ <= K6_SHFL_MAX_V else lanes
    writes = np.zeros((hp_, wp_, c), np.int64)
    # the partials a (vector, index) holds: its slots' channels
    part_slots = {}
    for v in range(v_):
        js = ((v * e) // g + 1) * g - v * e
        for j in range(e):
            i = j if ng == e else int(j >= js)
            part_slots.setdefault((v, i), []).append(v * e + j)
    # the group stage: group q reads (v, i) for v in its vectors
    read = {}
    for q in range(k):
        for v in range(q * g // e, ((q + 1) * g - 1) // e + 1):
            for i in (range(e) if ng == e else (q - (v * e) // g,)):
                if ng == e and (v * e + i) // g != q:
                    continue
                read.setdefault((v, i), []).append(q)
    # the holders: which threads' sums of a vector reach red[v][h]
    holders = {}
    for t in range(threads):
        v0, pl0 = t % vc, t // vc
        for v in range(v0, v_, vc):
            if v_ <= K6_SHFL_MAX_V:
                warp, lane = divmod(t, 32)
                for hl, lanes_held in enumerate(_shuffle_holders(v_)):
                    if lane in lanes_held:
                        assert (32 * warp + hl) % v_ == v
                        holders.setdefault((v, warp), []).append(t)
            elif pl0 < lanes:
                holders.setdefault((v, pl0), []).append(t)
    for rank in range(r):
        p_lo = rank * pix
        np_ = min(pix, npix - p_lo)
        for t in range(threads):
            v0, pl0 = t % vc, t // vc
            if pl0 >= lanes:
                continue
            # the kernel's incremental (h, w) walk
            hh, ww = divmod(p_lo + pl0, w)
            dh, dw = divmod(lanes, w)
            for p in range(pl0, np_, lanes):
                assert (hh, ww) == divmod(p_lo + p, w)
                for v in range(v0, v_, vc):
                    for s0 in range(0, c, span):
                        cv = s0 + v * e
                        writes[hh + pt, ww + pl, cv:cv + e] += 1
                        if pads != ((0, 0), (0, 0)) and (hh in (0, h - 1) or ww in (0, w - 1)):
                            h0 = 0 if hh == 0 else hh + pt
                            h1 = hp_ - 1 if hh == h - 1 else hh + pt
                            w0 = 0 if ww == 0 else ww + pl
                            w1 = wp_ - 1 if ww == w - 1 else ww + pl
                            for a in range(h0, h1 + 1):
                                for bb in range(w0, w1 + 1):
                                    if (a, bb) != (hh + pt, ww + pl):
                                        writes[a, bb, cv:cv + e] += 1
                ww += dw
                hh += dh
                if ww >= w:
                    ww -= w
                    hh += 1
    gathered = {q: [] for q in range(k)}
    for (v, i), chans in part_slots.items():
        for q in read.get((v, i), []):
            gathered[q] += chans
    return writes, gathered, holders, (v_, hv, vc)


# (h, w) pairs the gate admits (h·w a multiple of 8), widths by family
GN_PLAN_HW = [(1, 8), (2, 4), (3, 8), (4, 4), (8, 8), (7, 8), (16, 16), (32, 32)]
GN_PLAN_WIDTHS = {
    "cifar": (128, 256, 384, 512),
    "ldm": (224, 448, 672, 896),
    "sd": (320, 640, 960, 1280, 1920, 2560),
    "narrow": (32, 64, 96, 160, 192),
}


@pytest.mark.parametrize("family", list(GN_PLAN_WIDTHS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_gn_plan_covers_every_byte_once(family, dtype, monkeypatch):
    """Every (h, w, c) of the grid that ``fused_gn_applicable`` admits
    (``EDM_FUSED_GN_NARROW=1``) gets a plan within 232,448 B of shared
    memory, at most 8 blocks a cluster and 512 threads; replayed through a
    model of the kernel's loops, every pixel and channel of the padded
    output is written exactly once (the rim by its clamped owner), each
    group's sum gathers each of its slots exactly once, and each thread's
    partials reach exactly one holder."""
    from eda_dm_tpu_torch.ops.gn_int8 import BLOCK_SMEM_MAX, K6_R_MAX, gn_plan
    monkeypatch.setenv("EDM_FUSED_GN_NARROW", "1")
    esz = 2 if dtype == torch.bfloat16 else 4
    n = 0
    for h, w in GN_PLAN_HW:
        for c in GN_PLAN_WIDTHS[family]:
            if not tpolicy.fused_gn_applicable(h, w, c):
                continue
            for b in (1, 8, 50):
                plan = gn_plan(b, h, w, c, dtype)
                assert plan["smem"] <= BLOCK_SMEM_MAX and 1 <= plan["r"] <= K6_R_MAX
                assert plan["threads"] <= 512 and plan["threads"] % 32 == 0
                assert plan["r"] * plan["pix"] >= h * w > (plan["r"] - 1) * plan["pix"]
            pads = ((1, 1), (1, 1)) if (h + w) % 2 else ((0, 1), (0, 1))
            writes, gathered, holders, (v, hv, vc) = _k6_model(h, w, c, esz, plan, pads)
            assert (writes == 1).all(), (h, w, c, plan)
            span, g = plan["span"], c // 32
            assert span * esz % 16 == 0 and span % g == 0 and c % span == 0
            for q, chans in gathered.items():
                assert sorted(chans) == list(range(q * g, (q + 1) * g)), (q, plan)
            # each thread's sums of each of its vector columns reach one holder
            held = collections.Counter(t for ts in holders.values() for t in ts)
            if v <= 32:
                assert held == collections.Counter(range(plan["threads"]))
            else:
                assert held == collections.Counter(
                    {t: len(range(t % vc, v, vc)) for t in range(plan["threads"])
                     if t // vc < plan["lanes"]})
            assert all(key[1] < hv <= 32 for key in holders)
            n += 1
    assert n >= 8


def test_gn_plan_reaches_the_gates_widest_slices(monkeypatch):
    """The gate's widest slices fit: 13,648 pixels of 32 channels (one
    channel a group: 13,648 elements a group, 873 KB a span in bf16) split
    over 8 blocks, and 8 pixels of 54,560 channels (a span of 1,705 vectors
    walked in columns of 512 threads)."""
    from eda_dm_tpu_torch.ops.gn_int8 import BLOCK_SMEM_MAX, gn_plan
    monkeypatch.setenv("EDM_FUSED_GN_NARROW", "1")
    for h, w, c in ((853, 16, 32), (2, 4, 54_560), (2, 4, 54_592)):
        assert tpolicy.fused_gn_applicable(h, w, c)
        assert not tpolicy.fused_gn_applicable(h, 2 * w, c)
        for dtype in (torch.bfloat16, torch.float32):
            plan = gn_plan(1, h, w, c, dtype)
            assert plan["smem"] <= BLOCK_SMEM_MAX
    assert gn_plan(1, 853, 16, 32, torch.bfloat16)["r"] == 8
    wide = gn_plan(1, 2, 4, 54_560, torch.bfloat16)
    assert wide["span"] // 8 > 512 and wide["lanes"] == 1 and wide["threads"] == 512
    writes, gathered, _, _ = _k6_model(2, 4, 54_560, 2, wide, ((1, 1), (1, 1)))
    assert (writes == 1).all()
    g = 54_560 // 32
    assert all(sorted(ch) == list(range(q * g, (q + 1) * g)) for q, ch in gathered.items())


def test_k6_constants_match_the_source():
    """The plan's copy of K6's fixed sizes (threads a block, the largest
    cluster, a vector's bytes, the widest span that reduces in-warp) equals
    the constants of ``csrc/gn_int8.cu``, and the source's layout, partials
    and thread count are those ``gn_smem_bytes``, ``gn_partials`` and
    ``gn_launch_plan`` compute."""
    from eda_dm_tpu_torch.ops.gn_int8 import (K6_MAX_THREADS, K6_PLAN_ARGS, K6_R_MAX,
                                              K6_SHFL_MAX_V, K6_VEC)
    src = (pathlib.Path(gn_int8.__file__).parent.parent / "csrc" / "gn_int8.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["MAX_THREADS"], const["R_MAX"], const["VEC_BYTES"], const["SHFL_MAX_V"]) == (
        K6_MAX_THREADS, K6_R_MAX, K6_VEC, K6_SHFL_MAX_V)
    layout = src[src.index("inline Layout gn_layout("):]
    layout = layout[:layout.index("return l;")]
    for part in ("((long long)pix * span * esz + 15) / 16 * 16", "(long long)V * hv * ng * 8",
                 "l.gp2 = l.gp1 + round_up(k * 8, 16)", "l.mean = l.gp2 + round_up(k * 8, 16)",
                 "l.inv = l.mean + round_up(k * 4, 16)", "l.total = l.inv + round_up(k * 4, 16)"):
        assert part in layout, part
    for part in ("const int hv = V <= SHFL_MAX_V ? threads / 32 : lanes;",
                 "const int ng = groups_a_vector(g, E, V) <= 2 ? 2 : E;",
                 "threads != round_up(lanes * VC, 32)", "(V > MAX_THREADS && lanes != 1)",
                 "const int V = span / E, VC = V < MAX_THREADS ? V : MAX_THREADS;"):
        assert part in src, part
    entry = src[src.index('extern "C" int edm_gn_int8('):]
    entry = entry[:entry.index("{")]
    assert re.findall(r"int (span|r|pix|lanes|threads|smem)\b", entry) == list(K6_PLAN_ARGS)
