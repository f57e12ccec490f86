"""The port's attention dispatch and fused int8 attention (K4's plain
version) against the JAX package on the CPU.

* ``attention_impl``: the same branch as JAX's at every shape of the grid
  (the three LSUN-Bedroom sites at batch 50, the CIFAR sites at batch 8 to
  500, SD's 4096 tokens, where ``'flash'`` (K5, held in
  ``tests/test_torch_flash.py``) serves).
* ``int8_fused_attention`` against the Pallas kernel in interpret mode:
  the softmax codes within ±1 and ≥ 99.9 % identical (the exponentials and
  the row sums may round differently in the last bit), the output within
  rtol = atol = 1e-5 on every row whose codes agree.  JAX's codes are its
  kernel body's arithmetic replayed with ``jnp``.
* ``attention_plan`` (K4's launch plan): 16 warps a block within the
  H100's shared memory at every shape the gate admits, its fixed sizes
  and layout those of ``csrc/int8_attention.cu``.
* ``flash_plan`` (K5's launch plan): within the H100's shared memory, at
  most 8 blocks a cluster whose key slices cover every key once, the
  one-pass route at SD's shape and up to what 8 blocks hold, its
  one-buffer instance where two W·V buffers do not fit (ImageNet's
  (1024, 1024, 384)), the sweep route past both, its fixed sizes and
  layout those of
  ``csrc/int8_flash_attention.cu`` and ``csrc/int8_flash_sweep.cu``.
* the heads layout (``int8_fused_attention_heads``) and the heads-layout
  einsums of the LDM einsum branch (``bthc,bshc->bhts``,
  ``bhts,bshc->bthc``): the int8 products are exact, the epilogues run in
  the JAX order (rtol = atol = 1e-6).
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.ops import int8_einsum as jein
from eda_dm_tpu.ops import pallas_attention as jpa
from eda_dm_tpu.ops import serving_policy as jpolicy
from eda_dm_tpu_torch.ops import int8_einsum as tein
from eda_dm_tpu_torch.ops.int8_attention import (BLOCK_SMEM_MAX, FLASH_MAX_C, K4_CB, K4_HDR,
                                                 K4_NI_MAX, K4_STAGES, K4_TILE_KEYS, K4_TQ,
                                                 K4_WARPS, K5_CLUSTERS, K5_ENTRY, K5_HDR,
                                                 K5_KB_STEP, K5_MAX_C, K5_R_MAX, K5_ROUTES,
                                                 K5_TQS, K5_WARPS_MAX,
                                                 SWEEP_FCC, SWEEP_FCH, SWEEP_FJ, SWEEP_FPAD,
                                                 SWEEP_FQ, SWEEP_THREADS, attention_plan,
                                                 flash_attention_applicable, flash_plan,
                                                 flash_shape_check,
                                                 fused_attention_applicable,
                                                 int8_fused_attention,
                                                 int8_fused_attention_heads, k4_smem_bytes,
                                                 k5_plan, k5_smem_bytes, sweep_smem_bytes)
from eda_dm_tpu_torch.ops.serving_policy import attention_impl

GRID = [  # batch, heads, S, C
    (50, 14, 1024, 32), (50, 21, 256, 32), (50, 28, 64, 32),   # bedroom
    (8, 1, 256, 256), (8, 1, 16, 256), (64, 1, 256, 256),       # CIFAR
    (128, 1, 256, 256), (500, 1, 256, 256), (500, 1, 16, 256),
    (4, 8, 4096, 40), (2, 8, 4096, 160), (2, 8, 1024, 80),      # SD
    (1, 1, 1240, 8), (1, 1, 1248, 8), (3, 3, 72, 24), (2, 2, 77, 64),
    (64, 2, 64, 64), (63, 2, 64, 64), (1, 1, 8, 4)]


@pytest.mark.parametrize("site", GRID, ids=lambda s: "x".join(map(str, s)))
def test_attention_impl_matches_jax(site, monkeypatch):
    for var in ("EDM_FUSED_ATTN", "EDM_FUSED_ATTN_NARROW"):
        monkeypatch.delenv(var, raising=False)
    b, h, s, c = site
    assert attention_impl(b, h, s, s, c) == jpolicy.attention_impl(b, h, s, s, c)


def test_bedroom_sites_and_cifar_branches():
    """Pinned: the 16×16 site's logits are 2.5 % above the einsum cap."""
    assert attention_impl(50, 14, 1024, 1024, 32) == "fused"
    assert attention_impl(50, 21, 256, 256, 32) == "fused"
    assert attention_impl(50, 28, 64, 64, 32) == "einsum"
    assert attention_impl(8, 1, 256, 256, 256) == "fused"
    assert attention_impl(500, 1, 256, 256, 256) == "einsum"
    assert attention_impl(4, 8, 4096, 4096, 40) == "flash"


def _inputs(seed, n, s, c):
    rng = np.random.default_rng(seed)
    f = lambda scale: (rng.standard_normal((n, s, c)) * scale).astype(np.float32)
    q, k, v = f(1.0), f(0.8), f(1.2)
    scal = dict(dq=0.021, zq=130.0, dk=0.017, zk=122.0, dv=0.025, zv=127.0,
                dw=1.0 / 255.0, zw=0.0)
    return q, k, v, {key: np.float32(x) for key, x in scal.items()}


def _jax_codes(Q, cq, dq, K, ck, dk, attn_scale, dw, zw, n_lv):
    """``_kernel``'s arithmetic up to the codes, with jnp."""
    c = Q.shape[-1]
    lsc = jnp.asarray(dq, jnp.float32) * jnp.asarray(dk, jnp.float32) * attn_scale
    q, k = Q.astype(jnp.float32), K.astype(jnp.float32)
    acc = jnp.einsum("nic,njc->nij", q, k)
    sum_q = jnp.sum(q, axis=2, keepdims=True)
    sum_k = jnp.sum(k, axis=2)[:, None, :]
    logits = (acc + ck * sum_q + cq * sum_k + cq * ck * float(c)) * lsc
    e = jnp.exp(logits - jnp.max(logits, axis=2, keepdims=True))
    w = e / jnp.sum(e, axis=2, keepdims=True)
    cw = n_lv / 2 - zw
    return np.asarray(jnp.clip(jnp.round(w / dw), -zw, float(n_lv - 1) - zw) - cw)


@pytest.mark.parametrize("s", [16, 64, 72])
@pytest.mark.parametrize("c", [8, 32, 128])
@pytest.mark.parametrize("scale_form", ["c^-1/2", "1.0"])
def test_fused_attention_matches_the_pallas_kernel(s, c, scale_form):
    q, k, v, p = _inputs(s * c, 3, s, c)
    attn_scale = float(c) ** -0.5 if scale_form == "c^-1/2" else 1.0
    jq = [jein.quantize_act_int8(jnp.asarray(x), p["d" + n], p["z" + n], 256)
          for x, n in ((q, "q"), (k, "k"), (v, "v"))]
    (Qj, cq), (Kj, ck), (Vj, cv) = jq
    ref = np.asarray(jpa.int8_fused_attention(
        Qj, cq, p["dq"], Kj, ck, p["dk"], Vj, cv, p["dv"], attn_scale,
        p["dw"], p["zw"], 256, interpret=True))
    ref_codes = _jax_codes(Qj, cq, p["dq"], Kj, ck, p["dk"], attn_scale,
                           p["dw"], p["zw"], 256)
    T = lambda a: torch.from_numpy(np.array(a))
    out, codes = int8_fused_attention(
        T(Qj), T(cq), T(p["dq"]), T(Kj), T(ck), T(p["dk"]), T(Vj), T(cv),
        T(p["dv"]), attn_scale, T(p["dw"]), T(p["zw"]), 256, return_codes=True)
    diff = np.abs(codes.numpy().astype(np.int32) - ref_codes.astype(np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    rows = (diff == 0).all(-1)
    assert rows.mean() > 0.9
    np.testing.assert_allclose(out.numpy()[rows], ref[rows], rtol=1e-5, atol=1e-5)


def test_heads_layout_matches_jax():
    b, s, h, c = 2, 64, 3, 32
    q, k, v, p = _inputs(5, b, s, h * c)
    jq = [jein.quantize_act_int8(jnp.asarray(x.reshape(b, s, h, c)), p["d" + n],
                                 p["z" + n], 256)
          for x, n in ((q, "q"), (k, "k"), (v, "v"))]
    (Qj, cq), (Kj, ck), (Vj, cv) = jq
    ref = np.asarray(jpa.int8_fused_attention_heads(
        Qj, cq, p["dq"], Kj, ck, p["dk"], Vj, cv, p["dv"], 1.0, p["dw"],
        p["zw"], 256, interpret=True))
    T = lambda a: torch.from_numpy(np.array(a))
    out = int8_fused_attention_heads(
        T(Qj), T(cq), T(p["dq"]), T(Kj), T(ck), T(p["dk"]), T(Vj), T(cv),
        T(p["dv"]), 1.0, T(p["dw"]), T(p["zw"]), 256)
    assert out.shape == (b, s, h, c)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("eq", ["bthc,bshc->bhts", "bhts,bshc->bthc"])
def test_heads_layout_einsums_match_jax(eq):
    b, s, h, c = 2, 16, 3, 8
    rng = np.random.default_rng(7)
    shape_a = (b, s, h, c) if eq.startswith("bthc") else (b, h, s, s)
    A = rng.integers(-128, 128, shape_a).astype(np.int8)
    B = rng.integers(-128, 128, (b, s, h, c)).astype(np.int8)
    ca, da, cb, db = (np.float32(x) for x in (3.0, 0.013, -2.0, 0.0071))
    ref = np.asarray(jein.int8_code_einsum(eq, jnp.asarray(A), ca, da,
                                           jnp.asarray(B), cb, db))
    T = lambda a: torch.from_numpy(np.array(a))
    out = tein.int8_code_einsum(eq, T(A), T(ca), T(da), T(B), T(cb), T(db))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def _widest_c(s):
    """The widest head the gate admits at S (3SC + 4S² + 4SC ≤ 6 MiB)."""
    return (6 * 1024 * 1024 - 4 * s * s) // (7 * s) // 8 * 8


@pytest.mark.parametrize("cs", [(8, 24, 32, 40), (80, 128, 160, 256),
                                (264, 384, 1024, 4096), ("widest",)],
                         ids=["narrow", "sd-cifar", "wide", "widest"])
def test_attention_plan_fits_the_card(cs):
    """Every (S, C) the gate admits (S = 8 … 1240) gets a plan of 32 query
    rows in one block of 512 threads (16 warps), at most 232,448 B of
    dynamic shared memory (the H100's opt-in maximum), and K and V tiles
    that split evenly over the warps; the bedroom's (1024, 32) takes the
    fewest steps, a 512-key K tile and one 1024-key V tile."""
    n = 0
    for s in range(8, 1249, 8):
        for c in (_widest_c(s),) if cs == ("widest",) else cs:
            if not fused_attention_applicable(s, c, narrow_lanes=True):
                continue
            plan = attention_plan(s, c)
            assert (plan["tq"], plan["threads"]) == (32, 512)
            assert plan["smem"] <= BLOCK_SMEM_MAX
            assert plan["smem"] == k4_smem_bytes(s, c, plan["tj"], plan["tv"])
            assert plan["cq"] % 32 == 0 and plan["cq"] <= 256
            assert plan["tj"] in K4_TILE_KEYS and plan["tv"] in K4_TILE_KEYS
            assert plan["tj"] % (8 * 8) == 0       # 8 warps along the keys
            n += 1
    assert n > 100
    bedroom = attention_plan(1024, 32)
    assert (bedroom["tj"], bedroom["tv"]) == (512, 1024)


def test_k4_constants_match_the_source():
    """The plan's copy of K4's fixed sizes (rows and warps a block, ring
    slots, phase-3 columns, n8 tiles a warp, header bytes) equals the
    constants of ``csrc/int8_attention.cu``, and the source's layout adds
    the same parts as ``k4_smem_bytes``."""
    src = (pathlib.Path(tein.__file__).parent.parent / "csrc"
           / "int8_attention.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["TQ"], const["NW"], const["STAGES"], const["CB_MAX"], const["NI_MAX"],
            const["HDR_BYTES"]) == (K4_TQ, K4_WARPS, K4_STAGES, K4_CB, K4_NI_MAX, K4_HDR)
    layout = src[src.index("inline Layout k4_layout("):]
    layout = layout[:layout.index("return l;")]
    for part in ("l.logits = HDR_BYTES;", "TQ * 4 * (S + 4)", "TQ * 4 * cb0",
                 "QBUF * TQ * (cq + 16)", "STAGES * l.slot", "tv * v_row_bytes(cb0)",
                 "(tj + (C > cq ? TQ : 0)) * (cq + 16)"):
        assert part in layout, part
    assert "constexpr int QBUF = LOAD_V ? 1 : 2;" in src
    assert "constexpr int v_row_bytes(int cb) { return round_up(cb, 32) + 8; }" in src


# K5's routes at C = 40 (SD's head) on each side of the plan's cluster
# sizes: Skv → blocks a cluster, or the sweep route past what 8 hold
K5_R_BOUNDARIES = ((832, 1), (833, 2), (1664, 2), (1665, 4), (3328, 4), (3329, 8),
                   (6656, 8), (6657, "sweep"))
FLASH_PLAN_GRID = [  # sq, skv, c: the card tests' FLASH shapes, SD's, the corners
    (64, 64, 40), (100, 77, 40), (256, 512, 32), (33, 300, 8), (130, 4096, 40),
    (64, 128, 160), (40, 200, 384), (1, 1, 4), (8, 8, 8), (4096, 4096, 40),
    (4096, 4096, 80), (1024, 4096, 160), (64, 4096, 1024), (1, 100_000, 4),
    (7, 1, K5_MAX_C), (7, 1, K5_MAX_C + 4), (7, 2048, K5_MAX_C), (3, 9, 1024),
    (64, 2048, 40), (64, 4097, 40)] + [(40, skv, 40) for skv, _ in K5_R_BOUNDARIES] + [
    (1024, 1024, 1088), (256, 512, 1280), (64, 128, 4096), (8, 128, 17_856),
    (3, 9, FLASH_MAX_C),   # heads past one resident chunk of the sweep route
    # wide heads on one W·V buffer: ImageNet's 32×32 site, more queries,
    # other key lengths (ragged slices of 192 keys, C = K5_MAX_C)
    (1024, 1024, 384), (4096, 1024, 384), (64, 2048, 256), (33, 1280, 320),
    (64, 512, K5_MAX_C), (64, 1088, 384)]


@pytest.mark.parametrize("sq, skv, c", FLASH_PLAN_GRID,
                         ids=lambda v: str(v))
def test_flash_plan_fits_the_card(sq, skv, c):
    """K5's plan fits a block of the H100 (at most 232,448 B of dynamic
    shared memory) with at most 8 blocks a cluster whose key slices cover
    every key exactly once.  The one-pass route takes the smallest cluster
    that holds the keys with two W·V buffers (SD's (4096, 4096, 40): 8
    blocks of 512 keys); where none does, the one-pass-wide route the
    smallest with one (ImageNet's (1024, 1024, 384): 8 blocks of 128
    keys); where neither does, the sweep route takes one block."""
    plan = flash_plan(sq, skv, c)
    assert plan["smem"] <= BLOCK_SMEM_MAX and 1 <= plan["r"] <= K5_R_MAX
    cover = np.zeros(skv, dtype=np.int64)
    for rank in range(plan["r"]):
        cover[rank * plan["kb"]:(rank + 1) * plan["kb"]] += 1
    assert (cover == 1).all() and plan["r"] * plan["kb"] >= skv
    fits = {nbuf: [(r, tq) for r in K5_CLUSTERS for tq in K5_TQS
                   if (tq == 32 or sq > 32) and k5_plan(r, tq, skv, c, nbuf) is not None]
            for nbuf in K5_ROUTES}
    nbuf = {route: nb for nb, route in K5_ROUTES.items()}.get(plan["route"])
    if nbuf is not None:
        assert nbuf == 2 or not fits[2]
        assert (plan["r"], plan["tq"]) == fits[nbuf][0] and plan["r"] in K5_CLUSTERS
        assert plan["tq"] in (32, 64) and plan["threads"] == 16 * plan["tq"]
        assert plan["kb"] % K5_KB_STEP == 0 and plan["kb"] - K5_KB_STEP < -(-skv // plan["r"])
        assert plan["smem"] == k5_smem_bytes(plan["tq"], c, plan["kb"], nbuf)
    else:
        assert plan["route"] == "sweep" and not fits[2] and not fits[1]
        assert (plan["tq"], plan["threads"]) == (SWEEP_FQ, SWEEP_THREADS)
        assert plan["smem"] == sweep_smem_bytes(c)
    if (sq, skv, c) == (4096, 4096, 40):
        assert plan == dict(route="one_pass", tq=64, threads=1024, r=8, kb=512, smem=225_792)
    if (sq, skv, c) == (1024, 1024, 384):     # two W·V buffers 12,032 B over a block, one fits
        assert plan == dict(route="one_pass_wide", tq=32, threads=512, r=8, kb=128,
                            smem=196_352)
        assert k5_smem_bytes(32, c, 128) is None and k5_smem_bytes(32, c, 128, 1) < BLOCK_SMEM_MAX
    expected = dict(K5_R_BOUNDARIES).get(skv) if c == 40 else None
    if expected == "sweep":
        assert plan["route"] == "sweep"
    elif expected:
        assert (plan["route"], plan["r"]) == ("one_pass", expected)


def test_k5_constants_match_the_source():
    """The plan's copy of K5's fixed sizes (warps, the largest cluster, the
    step of a block's keys, the widest one-pass head, header bytes) equals
    the constants of ``csrc/int8_flash_attention.cu``, the header's parts
    fit its bytes, the source's layout adds the same parts as
    ``k5_smem_bytes`` (W·V buffers by route, each route's entry point
    launching its instance); the sweep route's sizes are those of
    ``csrc/int8_flash_sweep.cu``."""
    csrc = pathlib.Path(tein.__file__).parent.parent / "csrc"
    src = (csrc / "int8_flash_attention.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["NW_MAX"], const["R_MAX"], const["KB_STEP"], const["MAX_C"],
            const["HDR_BYTES"]) == (K5_WARPS_MAX, K5_R_MAX, K5_KB_STEP, K5_MAX_C, K5_HDR)
    assert "constexpr int k5_warps(int tq) { return tq / 2; }" in src
    hdr = {k: int(v) for k, v in re.findall(r"(H_\w+) = (\d+)", src)}
    tq_max, nw = 64, const["NW_MAX"]
    assert nw * 16 * 4 <= hdr["H_PMAX"]                  # maxima by warp [NW·16 / TQ][TQ]
    assert hdr["H_PMAX"] + 4 * tq_max <= hdr["H_PSUM"] and hdr["H_PSUM"] % 8 == 0
    assert hdr["H_PSUM"] + 8 * tq_max <= hdr["H_SW"]
    assert hdr["H_SW"] + 2 * 4 * tq_max <= const["HDR_BYTES"] and const["HDR_BYTES"] % 16 == 0
    layout = src[src.index("inline Layout k5_layout("):]
    layout = layout[:layout.index("return l;")]
    for part in ("l.logits = HDR_BYTES;", "tq * 4 * (kb + 4)", "nbuf * tq * 4 * red_ld(c8, nbuf)",
                 "4 * 4 * c8", "4 * kb", "tq * (cp + 16)", "kb * (cp + 16)",
                 "c8 * (kb + 16)", "round_up(C, 32)", "round_up(C, 8)"):
        assert part in layout, part
    assert "(tq != 32 && tq != 64)" in src and set(K5_TQS) == {32, 64}
    for nbuf, route in K5_ROUTES.items():    # each route's entry point, its W·V buffers
        entry = src[src.index(f'extern "C" int {K5_ENTRY[route]}('):]
        assert f"return entry({nbuf}, " in entry[:entry.index("}")]
    assert "const int n = item / tiles, i0 = (item - n * tiles) * TQ, h = item & (NBUF - 1);" in src
    assert ("constexpr int red_ld(int c8, int nbuf) { return nbuf == 1 ? c8 + 8 : c8; }"
            in src)
    sweep = (csrc / "int8_flash_sweep.cu").read_text()
    defs = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)", sweep)}
    assert (defs["FQ"], defs["FJ"], defs["FCH"], defs["FA_THREADS"], defs["FPAD"],
            defs["FCC"]) == (SWEEP_FQ, SWEEP_FJ, SWEEP_FCH, SWEEP_THREADS, SWEEP_FPAD,
                             SWEEP_FCC)
    assert "const int Cw = (C < FCC ? C : FCC) / 4;" in sweep
    assert ("4 * ((size_t)Cw * (FQ + FPAD) + (size_t)Cw * (FJ + FPAD)\n"
            "                           + (FJ / 4) * (FCH + FPAD) + FQ * WROW + FQ + FJ + FCH)"
            ) in sweep
    assert "(C + FCH - 1) / FCH > 65535" in sweep and FLASH_MAX_C == SWEEP_FCH * 65535


@pytest.mark.parametrize("cs", [(8, 32, 40, 64), (128, 384, 512, 1024),
                                (1088, 1280, 2048, 4096)],
                         ids=["narrow", "mid", "past-a-chunk"])
def test_every_admitted_flash_shape_has_a_plan(cs):
    """Every (Sq, Skv, C) that ``flash_attention_applicable`` admits (narrow
    lanes on) over Sq, Skv in 64 … 8192 gets a ``flash_plan`` within the
    H100's shared memory and passes the wrapper's shape check: no admitted
    head is refused on the card (heads past ``SWEEP_FCC`` columns take the
    sweep route chunk by chunk)."""
    n = wide = 0
    lengths = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
    for sq in lengths:
        for skv in lengths:
            for c in cs:
                if not flash_attention_applicable(sq, skv, c, narrow_lanes=True):
                    continue
                plan = flash_plan(sq, skv, c)
                assert plan["smem"] <= BLOCK_SMEM_MAX
                flash_shape_check(1, sq, skv, c)
                n += 1
                wide += c > SWEEP_FCC
    assert n > 20 and (wide > 20) == (cs[-1] > SWEEP_FCC)
