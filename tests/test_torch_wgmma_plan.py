"""P1's wgmma route (``csrc/wgmma_chain.cu``) on the CPU: its launch plan
(``probes/mma_int8.py::chain_plan``), the 128-byte swizzle its operands
live in, and a model of its epilogue's stores; and the probe's routes,
which on a CPU tensor both run the plain chain.

The kernel itself runs only on the card (``tests/test_torch_cuda.py::
test_mma_chain_kernel``).  Here every plan the wrapper can launch is held
to the H100's shared memory, to ``wgmma``'s shapes and alignment, and to
the instances the kernel's entry point compiles (read from its source).
"""

import re
from pathlib import Path

import pytest
import torch

from eda_dm_tpu_torch.probes import mma_int8 as probe

CSRC = Path(probe.__file__).resolve().parent.parent / "csrc"
KS = (128, 256, 384, 512)
DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16}
CASES = [(k, name) for k in KS for name in DTYPES]
# wgmma's N for 8-bit operands (bf16 takes every multiple of 8 up to 256)
S8_N = {8, 16, 24, 32, 48, 64, 80, 96, 112, 128, 144, 160, 176, 192, 208, 224, 240, 256}


def _esize(name):
    return 1 if name == "int8" else 2


@pytest.mark.parametrize("k,name", CASES)
def test_chain_plan_fits_the_card(k, name):
    plan = probe.chain_plan(k, DTYPES[name])
    assert plan["smem_bytes"] <= 232448
    assert plan["rows"] % 64 == 0 and plan["rows"] == 64 * plan["wgs"]
    assert plan["threads"] == 128 * plan["wgs"] + (0 if plan["resident"] else 32)
    # the regions as the kernel lays them out after its 1024-byte pad
    row = k * _esize(name)
    slabs = plan["wgs"] * (1 if plan["in_place"] else 2) * 64 * row
    b = k * row if plan["resident"] else plan["stages"] * plan["pass_cols"] * 128
    assert plan["smem_bytes"] == 1024 + slabs + b + 16 * plan["stages"]


@pytest.mark.parametrize("k,name", CASES)
def test_chain_plan_swizzle_atoms_are_aligned(k, name):
    """Every panel wgmma reads (A's slabs, B's panels or ring slots) starts
    on a 1024-byte boundary of the aligned base, so each 8-row swizzle
    atom does; the mbarriers sit on 8 bytes past the last slot."""
    plan = probe.chain_plan(k, DTYPES[name])
    lay = plan["layout"]
    panels = k * _esize(name) // 128
    starts = [s + p * lay["panel_bytes"] for s in lay["slabs"] for p in range(panels)]
    starts += lay["b_panels"] + lay["stages"]
    assert starts and all(s % 1024 == 0 for s in starts)
    assert lay["panel_bytes"] == 64 * 128
    if plan["resident"]:
        assert len(lay["b_panels"]) == panels and not lay["stages"]
        assert lay["barriers"] is None
    else:
        assert len(lay["stages"]) == plan["stages"] and not lay["b_panels"]
        assert lay["barriers"] % 8 == 0
        assert lay["barriers"] + 16 * plan["stages"] == plan["smem_bytes"] - 1024


@pytest.mark.parametrize("k,name", CASES)
def test_chain_plan_passes(k, name):
    """At most 256 accumulator columns a pass, in wgmma's widths; the
    passes cover K; the slab is rewritten in place only where one pass
    covers every column; a streamed B has a ring of at least 3 slots (one
    under the products in flight, one landing, one refilling)."""
    plan = probe.chain_plan(k, DTYPES[name])
    cols = plan["pass_cols"]
    assert cols <= 256 and cols % 8 == 0 and plan["passes"] * cols == k
    if name == "int8":
        assert cols in S8_N
    assert plan["in_place"] == (plan["passes"] == 1)
    assert (plan["stages"] >= 3) if not plan["resident"] else plan["stages"] == 0


def _instances():
    src = (CSRC / "wgmma_chain.cu").read_text()
    table = src[src.index("#define WGC_INSTANCES(X)"):src.index("extern \"C\"")]
    rows = re.findall(r"X\((int8_t|__nv_bfloat16), (\d+), (\d+), (\d+), (true|false), (\d+)\)",
                      table)
    return {("int8" if t == "int8_t" else "bf16", int(k), int(w), int(n), r == "true", int(s))
            for t, k, w, n, r, s in rows}


def test_every_plan_is_a_kernel_instance():
    """The plans the wrapper can launch are exactly the instances the
    kernel's entry point compiles (any other plan it refuses)."""
    instances = _instances()
    plans = {(name, k, p["wgs"], p["pass_cols"], p["resident"], p["stages"])
             for k, name in CASES for p in [probe.chain_plan(k, DTYPES[name])]}
    assert len(instances) == 8 and plans == instances


@pytest.mark.parametrize("row0", range(0, 64, 8))
def test_swizzle_is_a_bijection_on_each_atom(row0):
    """The 128-byte swizzle maps each 8-row x 128-byte atom onto its own
    1024 bytes, one byte each, and keeps every 16-byte chunk whole."""
    offsets = [probe.swz128(r, b) for r in range(row0, row0 + 8) for b in range(128)]
    assert sorted(offsets) == list(range(row0 * 128, row0 * 128 + 1024))
    for r in range(row0, row0 + 8):
        for c in range(8):
            chunk = {probe.swz128(r, 16 * c + i) // 16 for i in range(16)}
            assert len(chunk) == 1 and (chunk.pop() % 8) == c ^ (r % 8)


def test_swizzle_model_is_the_kernels():
    """The Python model is the header's function: its return expression,
    read from ``csrc/sm90_wgmma.cuh``, gives the same offsets."""
    src = (CSRC / "sm90_wgmma.cuh").read_text()
    expr = re.search(r"uint32_t swz128\(uint32_t r, uint32_t b\) \{\s*return ([^;]+);",
                     src).group(1)
    expr = re.sub(r"(\d+)u\b", r"\1", expr)
    for r in range(0, 512, 3):
        for b in range(128):
            assert eval(expr, {}, {"r": r, "b": b}) == probe.swz128(r, b)


@pytest.mark.parametrize("k,name", CASES)
def test_epilogue_writes_every_code_once(k, name):
    """A model of the epilogue's loops (warp wl, lane 4g + t, column chunk
    j, half h, pass p): each warpgroup stores every (row, column) of its 64
    rows exactly once, at the address the next step's descriptor reads it
    from (panel col·size / 128, swizzled row), so the stores tile the slab."""
    plan = probe.chain_plan(k, DTYPES[name])
    es, cols = _esize(name), plan["pass_cols"]
    seen, addrs = set(), set()
    for wl in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for p in range(plan["passes"]):
                for j in range(cols // 8):
                    for h in range(2):
                        r, col = 16 * wl + g + 8 * h, p * cols + 8 * j + 2 * t
                        for c in (col, col + 1):
                            seen.add((r, c))
                            byte = c * es
                            addrs.add((byte >> 7) * 8192 + probe.swz128(r, byte & 127))
    assert len(seen) == 64 * k
    assert len(addrs) == 64 * k and max(addrs) < 64 * k * es
    assert all(a % es == 0 for a in addrs)


@pytest.mark.parametrize("route", probe.ROUTES)
def test_routes_on_the_cpu_run_the_plain_chain(route):
    x = probe.probe_inputs(96, 256, torch.Generator().manual_seed(7), "cpu")
    assert torch.equal(probe.mma_chain(x["a8"], x["b8"], 5, route),
                       probe.mma_chain_plain(x["a8"], x["b8"], 5))
    assert torch.equal(probe.mma_chain(x["a16"], x["b16"], 5, route=route),
                       probe.mma_chain_plain(x["a16"], x["b16"], 5))
    got = probe.one_mm(x["a8"], x["b8"], route=route)
    assert got.dtype == torch.int32
    assert torch.equal(got, x["a8"].long() @ x["b8"].long())


def test_unknown_route_raises():
    x = probe.probe_inputs(8, 128, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="route"):
        probe.mma_chain(x["a8"], x["b8"], 1, "wmma")
    with pytest.raises(ValueError, match="route"):
        probe.one_mm(x["a8"], x["b8"], route="cublas")


@pytest.mark.parametrize("k", [64, 192, 640])
def test_inadmissible_k_raises(k):
    a = torch.zeros(8, k, dtype=torch.int8)
    for route in probe.ROUTES:
        with pytest.raises(ValueError, match="multiple of 128"):
            probe.mma_chain(a, torch.zeros(k, k, dtype=torch.int8), 1, route)
        with pytest.raises(ValueError, match="multiple of 128"):
            probe.one_mm(a, torch.zeros(k, k, dtype=torch.int8), route)
    with pytest.raises(ValueError, match="multiple of 128"):
        probe.chain_plan(k, torch.int8)
