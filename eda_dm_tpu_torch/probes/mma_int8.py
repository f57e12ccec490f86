"""Tensor-core rate probe (P1): how close does a hand-written kernel come
to the H100's int8 and bf16 matrix rates?

Port of ``scripts/probes/mosaic_int8.py``.  A kernel that keeps a chain of
``CHAIN`` dependent products on chip is timed on two routes:
``"wgmma"`` (``csrc/wgmma_chain.cu``: warpgroup products from swizzled
shared memory, each warpgroup's 64 rows stepping on their own, B resident
or streamed through an mbarrier ring, as :func:`chain_plan` says) and
``"mma_sync"`` (``csrc/mma_chain.cu``: warp products through registers, a
block barrier a step).  Both stand beside the data-sheet peaks and the
same chain through PyTorch's library products (``torch._int_mm`` for int8,
``torch.matmul`` for bf16, each step's requantize as separate element-wise
passes), the counterparts of the TPU probe's XLA arms:

    int8:  a ← int8(wrap)((a·B) >> 8)       int32 sums, arithmetic shift
    bf16:  a ← bf16((a·B) · 0.01)           float32 sums

plus one exact int8 product (``one_mm``).  Rates are ``2·m·k²·CHAIN / t``.
Inputs are seeded: a and the int8 B full-range int8; the bf16 B uniform
integers in ±round(100·√3/√k), so that the bf16 chain stays finite for
all 40 steps (full-range B overflows it to inf).

    python -m eda_dm_tpu_torch.probes.mma_int8 [--diag]   # on one CUDA card

``--diag`` also times the wgmma route rebuilt without its warpgroups'
turns (``WGC_PINGPONG=0``) and without its epilogue stores
(``WGC_DIAG=1``, a timing-only build whose output is wrong).

On a CUDA tensor :func:`mma_chain` and :func:`one_mm` launch the route's
kernel (``"wgmma"`` by default) or raise; on a CPU tensor they run their
plain versions under either route.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import statistics
import subprocess
from typing import Dict, List, Sequence, Tuple

import torch

from ..device import resolve_device
from ..ops._build import (BUILD_DIR, CSRC, check_launch, cuda_lib, launch_counts, ptr,
                          stream_ptr)
from ..ops.int8_einsum import int8_matmul_acc_plain, tf32_off

CHAIN = 40
PROBE_SHAPES = ((65536, 128), (65536, 256), (16384, 512))   # (m, k): a·B is m×k×k
PEAKS = {"int8": 1979e12, "bf16": 989e12}   # H100 SXM data sheet, dense, 700 W
# the bf16 chain against its plain version: float32 sums in another order
# move bf16 roundings, which 40 chained products spread; on an H100 the
# kernel's chains stay within 2.8e-3 relative L2 and 1.0e-2 of max|ref| at
# the probe's shapes (chip_smoke.py), a quarter and a fifth of these bounds
BF16_REL_L2, BF16_REL_MAX = 1e-2, 5e-2
LIBRARY_N = 8192          # the library's own rate: one 8192³ product

ROUTES = ("wgmma", "mma_sync")
LAUNCH_COUNTER = {"wgmma": "mma_chain_wgmma", "mma_sync": "mma_chain"}
KERNEL_NAME = {"wgmma": "wgmma_chain_kernel", "mma_sync": "mma_chain_kernel"}
SMEM_LIMIT = 232448       # shared bytes a block may use on the H100

# the wgmma route's (warpgroups, B resident, stages), in order of preference:
# two warpgroups (one's epilogue under the other's products) before one, B
# resident before streamed, a deeper ring before a shallower one (at least
# 3: one slot under the products in flight, one landing, one refilling)
PLAN_ORDER = ((2, True, 0), (2, False, 4), (2, False, 3),
              (1, True, 0), (1, False, 4), (1, False, 3))

_SIG = {"edm_mma_chain": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_void_p]}
_WGMMA_SIG = {"edm_wgmma_chain": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
              + [ctypes.c_longlong, ctypes.c_void_p]}


def swz128(row: int, byte: int) -> int:
    """Offset of (row, byte of the row's 128-byte panel) in a panel of the
    128-byte-swizzled K-major layout that ``wgmma`` reads (``swz128`` of
    ``csrc/sm90_wgmma.cuh``): the 16-byte chunk c of row r sits at chunk
    c ^ (r % 8)."""
    return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15)


def chain_plan(k: int, dtype: torch.dtype) -> dict:
    """The wgmma route's launch plan for K and the operand type: 64 rows a
    consumer warpgroup, every column in passes of at most 256 (``passes``
    of ``pass_cols``); one slab a warpgroup rewritten in place where one
    pass covers K, else two; B resident where it fits beside the slabs,
    else streamed through a ring of ``stages`` (≥ 3) tiles of
    ``pass_cols`` rows x 128 bytes.  Two warpgroups a block where their
    slabs fit, else one.  ``layout`` gives each region's byte offset from
    the 1024-aligned base (``smem_bytes`` includes the 1024-byte pad);
    ``csrc/wgmma_chain.cu`` computes the same bytes and refuses a plan
    that is not one of its instances."""
    if dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"mma_chain takes int8 or bf16 operands, not {dtype}")
    if k % 128 or not 128 <= k <= 512:
        raise ValueError(f"mma_chain takes K a multiple of 128 up to 512, not {k}")
    row = k * (1 if dtype == torch.int8 else 2)           # bytes a row
    passes = -(-k // 256)
    cols = k // passes
    in_place = passes == 1
    slab = 64 * row
    slabs_a_wg = 1 if in_place else 2
    for wgs, resident, stages in PLAN_ORDER:
        b_bytes = k * row if resident else stages * cols * 128
        smem = 1024 + wgs * slabs_a_wg * slab + b_bytes + 16 * stages
        if smem <= SMEM_LIMIT:
            break
    else:
        raise ValueError(f"no wgmma chain plan fits K = {k}, {dtype}")
    b0 = wgs * slabs_a_wg * slab
    layout = {"slabs": [slab * i for i in range(wgs * slabs_a_wg)], "panel_bytes": 64 * 128,
              "b_panels": [b0 + p * k * 128 for p in range(row // 128)] if resident else [],
              "stages": [b0 + st * cols * 128 for st in range(stages)],
              "barriers": b0 + b_bytes if stages else None}
    return {"rows": 64 * wgs, "wgs": wgs, "passes": passes,
            "pass_cols": cols, "in_place": in_place, "resident": resident, "stages": stages,
            "threads": 128 * wgs + (0 if resident else 32), "smem_bytes": smem,
            "layout": layout}


def bf16_b_range(k: int) -> int:
    """Half-width of the bf16 arm's B entries: round(100·√3/√k)."""
    return round(100 * math.sqrt(3) / math.sqrt(k))


def probe_inputs(m: int, k: int, generator: torch.Generator,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """a8 (m, k), b8 (k, k) uniform int8 in [-127, 126]; a16 = a8 as bf16;
    b16 uniform integers in ±bf16_b_range(k) as bf16."""
    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=generator, device=device,
                             dtype=torch.int32)
    a8 = ints(-127, 127, (m, k)).to(torch.int8)
    b8 = ints(-127, 127, (k, k)).to(torch.int8)
    r = bf16_b_range(k)
    return {"a8": a8, "b8": b8, "a16": a8.to(torch.bfloat16),
            "b16": ints(-r, r + 1, (k, k)).to(torch.bfloat16)}


def _wrap_int8(v: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of integers into int8 (no saturation)."""
    return (v & 0xFF).to(torch.uint8).view(torch.int8)


def mma_chain_plain(a: torch.Tensor, b: torch.Tensor, steps: int = CHAIN) -> torch.Tensor:
    """The chain in plain PyTorch: int8 with exact sums, ``>> 8`` and a
    wrapping cast; bf16 with a float32 product (TF32 off), ``× 0.01`` and
    a round-to-nearest-even cast."""
    if a.dtype == torch.int8:
        for _ in range(steps):
            a = _wrap_int8(int8_matmul_acc_plain(a, b) >> 8)
        return a
    bf = b.float()
    with tf32_off():
        for _ in range(steps):
            a = ((a.float() @ bf) * 0.01).to(torch.bfloat16)
    return a


def _check(a, b, route):
    """Raise unless the route is known and a (M ≥ 1, K), B (K, K) are
    operands of one admitted type and K (either device)."""
    if route not in ROUTES:
        raise ValueError(f"mma_chain route must be one of {ROUTES}, not {route!r}")
    if a.dtype not in (torch.int8, torch.bfloat16) or b.dtype != a.dtype:
        raise ValueError(f"mma_chain takes int8 or bf16 operands of one type, not "
                         f"{a.dtype} and {b.dtype}")
    m, k = a.shape if a.dim() == 2 else (0, 0)
    if a.dim() != 2 or m < 1 or tuple(b.shape) != (k, k) or b.device != a.device:
        raise ValueError(f"mma_chain takes a (M, K) and B (K, K) on one device, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if k % 128 or k > 512:
        raise ValueError(f"mma_chain takes K a multiple of 128 up to 512, not {k}")


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_wgmma(lib, a, b, out, acc, steps, plan) -> None:
    """One launch of a built ``wgmma_chain`` library under ``plan``: B
    (contiguous) packed into scratch, then the chain."""
    m, k = a.shape
    bp = torch.empty(k * k * a.element_size(), dtype=torch.uint8, device=a.device)
    err = lib.edm_wgmma_chain(ptr(a), ptr(b), ptr(bp), ptr(out), ptr(acc), m, k, steps,
                              int(a.dtype == torch.bfloat16), plan["wgs"], plan["pass_cols"],
                              int(plan["resident"]), plan["stages"], plan["smem_bytes"],
                              stream_ptr(a.device))
    check_launch(lib, err, "mma_chain (wgmma)")


def _mma_chain_cuda(a, b, steps, acc_out=False, route="wgmma"):
    m, k = a.shape
    if acc_out and (a.dtype != torch.int8 or steps != 1):
        raise ValueError("int32 sums come from one int8 step")
    a = _aligned16(a)
    out = torch.empty((m, k), dtype=torch.int32 if acc_out else a.dtype, device=a.device)
    o, acc = (None, out) if acc_out else (out, None)
    if route == "wgmma":
        launch_wgmma(cuda_lib("wgmma_chain", _WGMMA_SIG), a, b.contiguous(), o, acc, steps,
                     chain_plan(k, a.dtype))
    else:
        bt = _aligned16(b.t())                      # B's columns as rows
        lib = cuda_lib("mma_chain", _SIG)
        err = lib.edm_mma_chain(ptr(a), ptr(bt), ptr(o), ptr(acc), m, k, steps,
                                int(a.dtype == torch.bfloat16), stream_ptr(a.device))
        check_launch(lib, err, "mma_chain")
    launch_counts[LAUNCH_COUNTER[route]] += 1
    return out


def mma_chain(a: torch.Tensor, b: torch.Tensor, steps: int = CHAIN,
              route: str = "wgmma") -> torch.Tensor:
    """``steps`` chained products of a (M, K) with B (K, K), int8 or bf16,
    requantized after each (module docstring); returns the last a.  On a
    card ``route`` picks the kernel (``ROUTES``)."""
    _check(a, b, route)
    if a.is_cuda:
        return _mma_chain_cuda(a, b, steps, route=route)
    if a.device.type != "cpu":
        raise ValueError(f"mma_chain: unsupported device {a.device}")
    return mma_chain_plain(a, b, steps)


def one_mm(a: torch.Tensor, b: torch.Tensor, route: str = "wgmma") -> torch.Tensor:
    """The int32 product of int8 a (M, K) and B (K, K): the route's
    kernel's single step with its sums stored, on a CUDA tensor."""
    _check(a, b, route)
    if a.is_cuda:
        return _mma_chain_cuda(a, b, 1, acc_out=True, route=route)
    if a.device.type != "cpu":
        raise ValueError(f"one_mm: unsupported device {a.device}")
    return int8_matmul_acc_plain(a, b)


def library_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One library product, the yardstick of the rates and never the
    kernel: ``torch._int_mm`` (int32 sums) or bf16 ``torch.matmul``."""
    return torch._int_mm(a, b) if a.dtype == torch.int8 else torch.matmul(a, b)


def library_chain(a: torch.Tensor, b: torch.Tensor, steps: int = CHAIN) -> torch.Tensor:
    """The chain through :func:`library_product`, each step's requantize
    as separate passes.  The bf16 product rounds to bf16 before the
    ``× 0.01`` (torch.matmul's output type)."""
    for _ in range(steps):
        if a.dtype == torch.int8:
            a = (library_product(a, b) >> 8).to(torch.int8)
        else:
            a = (library_product(a, b).float() * 0.01).to(torch.bfloat16)
    return a


def bf16_errors(out: torch.Tensor, ref: torch.Tensor) -> Tuple[float, float]:
    """(relative L2, max |Δ| / max |ref|) of a bf16 chain against another."""
    d = (out.float() - ref.float()).abs()
    r = ref.float()
    return float(d.norm() / r.norm()), float(d.max() / r.abs().max())


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Device time of one call's kernels whose names hold ``kernel``, by the
    profiler (the mean over ``reps`` calls): at small shapes a call's
    CUDA-event time is the host's launch path, not the kernel's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and kernel in e.key]
    n = sum(e.count for e in ev)
    return sum(e.self_device_time_total for e in ev) / 1e3 / n if n else float("nan")


def sm_clock() -> str:
    """The SM clock ``nvidia-smi`` reads now (e.g. ``"1980 MHz"``)."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def probe_shape(m: int, k: int, generator: torch.Generator, device,
                steps: int = CHAIN) -> dict:
    """Both arms at one shape under every route: the kernel's chain
    against its plain version (int8 bit-equal, bf16 within BF16_REL_L2 /
    BF16_REL_MAX), and on a card each route's kernel time by the profiler
    (``ms``, ``mma_sync_ms``; ``ms`` and ``rate`` are the wgmma route's)
    and the call's by CUDA events (``event_ms``, ``mma_sync_event_ms``:
    with the wrapper's B layout pass and its host path), the library
    chain's and one library product's times and rates, then the SM clock
    right after the timed chains."""
    x = probe_inputs(m, k, generator, device)
    res = {"m": m, "k": k, "steps": steps, "ops": 2 * m * k * k * steps, "routes": {}}
    ref8 = mma_chain_plain(x["a8"], x["b8"], steps)
    ref16 = mma_chain_plain(x["a16"], x["b16"], steps)
    for route in ROUTES:
        out8 = mma_chain(x["a8"], x["b8"], steps, route)
        out16 = mma_chain(x["a16"], x["b16"], steps, route)
        rel_l2, rel_max = bf16_errors(out16, ref16)
        res["routes"][route] = dict(
            int8_equal=bool(torch.equal(out8, ref8)), int8_differ=int((out8 != ref8).sum()),
            bf16_rel_l2=rel_l2, bf16_rel_max=rel_max,
            bf16_ok=bool(torch.isfinite(out16.float()).all()) and rel_l2 <= BF16_REL_L2
            and rel_max <= BF16_REL_MAX)
    res["int8_equal"] = all(r["int8_equal"] for r in res["routes"].values())
    res["bf16_ok"] = all(r["bf16_ok"] for r in res["routes"].values())
    if x["a8"].is_cuda:
        for arm, a, b in (("int8", x["a8"], x["b8"]), ("bf16", x["a16"], x["b16"])):
            ms = {r: device_ms(lambda r=r: mma_chain(a, b, steps, r), KERNEL_NAME[r])
                  for r in ROUTES}
            ev = {r: cuda_ms(lambda r=r: mma_chain(a, b, steps, r)) for r in ROUTES}
            lib_ms = cuda_ms(lambda: library_chain(a, b, steps))
            mm_ms = cuda_ms(lambda: library_product(a, b))
            res[arm] = {"ms": ms["wgmma"], "rate": res["ops"] / ms["wgmma"] * 1e3,
                        "event_ms": ev["wgmma"], "mma_sync_ms": ms["mma_sync"],
                        "mma_sync_rate": res["ops"] / ms["mma_sync"] * 1e3,
                        "mma_sync_event_ms": ev["mma_sync"],
                        "library_ms": lib_ms, "library_mm_ms": mm_ms,
                        "library_rate": res["ops"] / lib_ms * 1e3,
                        "library_mm_rate": res["ops"] / steps / mm_ms * 1e3,
                        "peak": PEAKS[arm]}
        res["sm_clock"] = sm_clock()
    return res


def library_peak(arm: str, generator: torch.Generator) -> dict:
    """PyTorch's library product at its best: one LIBRARY_N³ product,
    large enough to be bound by the tensor cores, as a rate."""
    n = LIBRARY_N
    a = probe_inputs(n, n, generator)["a8" if arm == "int8" else "a16"]
    ms = cuda_ms(lambda: library_product(a, a), reps=10)
    return {"n": n, "ms": ms, "rate": 2 * n ** 3 / ms * 1e3, "peak": PEAKS[arm]}


def main(device=None, shapes: Sequence[Tuple[int, int]] = PROBE_SHAPES,
         steps: int = CHAIN) -> List[dict]:
    """Run the probe: every shape of ``shapes`` in both arms under both
    routes, then the exact one_mm check at (512, 128)·(128, 128) under
    both.  Prints one line a measurement and returns the results (rates
    only on a card)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    results = []
    for m, k in shapes:
        r = probe_shape(m, k, g, dev, steps)
        results.append(r)
        tag = f"{m}x{k}x{k}, {steps} steps"
        for route, c in r["routes"].items():
            print(f"mma chain {tag}, {route}: int8 equal to the plain chain {c['int8_equal']} "
                  f"({c['int8_differ']} differ); bf16 within tolerance {c['bf16_ok']} (rel L2 "
                  f"{c['bf16_rel_l2']:.3g}, max {c['bf16_rel_max']:.3g} of max|ref|)",
                  flush=True)
        for arm in ("int8", "bf16"):
            if arm not in r:
                print(f"mma {arm} {tag}: rate not measured (no card)")
                continue
            t = r[arm]
            print(f"mma {arm} {tag}: wgmma {t['ms']:.4f} ms = {t['rate'] / 1e12:.1f} T/s "
                  f"({t['rate'] / t['peak']:.1%} of the data sheet's {t['peak'] / 1e12:.0f}; "
                  f"the call by events {t['event_ms']:.4f}); mma.sync {t['mma_sync_ms']:.4f} "
                  f"ms = {t['mma_sync_rate'] / 1e12:.1f} T/s ({t['mma_sync_rate'] / t['peak']:.1%}"
                  f"; events {t['mma_sync_event_ms']:.4f}); library chain "
                  f"{t['library_ms']:.4f} ms = {t['library_rate'] / 1e12:.1f} T/s; one library "
                  f"product {t['library_mm_ms']:.4f} ms = {t['library_mm_rate'] / 1e12:.1f} T/s",
                  flush=True)
        if "sm_clock" in r:
            print(f"SM clock after the timed chains at {tag}: {r['sm_clock']}", flush=True)
    if dev.type == "cuda":
        chains = list(results)
        for arm in ("int8", "bf16"):
            lib = library_peak(arm, g)
            best = max(r[arm]["rate"] for r in chains)
            print(f"library {arm} product {lib['n']}^3: {lib['ms']:.4f} ms = "
                  f"{lib['rate'] / 1e12:.1f} T/s ({lib['rate'] / lib['peak']:.1%} of the "
                  f"data sheet); the wgmma route's best chain rate is {best / lib['rate']:.1%} "
                  f"of it", flush=True)
            results.append({"library_peak": arm, **lib})
    x = probe_inputs(512, 128, g, dev)
    want = int8_matmul_acc_plain(x["a8"], x["b8"])
    exact = {route: bool(torch.equal(one_mm(x["a8"], x["b8"], route), want)) for route in ROUTES}
    print(f"mma s8 matmul exact: {exact}", flush=True)
    results.append({"one_mm_exact": all(exact.values())})
    return results


# timing-only rebuilds of the wgmma route (--diag)
DIAG_BUILDS = {"no_pingpong": ["-DWGC_PINGPONG=0"], "no_epilogue": ["-DWGC_DIAG=1"]}


def diagnostics(shapes: Sequence[Tuple[int, int]] = PROBE_SHAPES, steps: int = CHAIN) -> dict:
    """The wgmma route rebuilt under each of ``DIAG_BUILDS`` and timed at
    ``shapes`` beside this build, each kernel's device time by the
    profiler: without the warpgroups' turns (its int8 chain held bit-equal
    to this build's) and without the epilogue's stores (the products
    alone).  Prints ``ptxas``'s registers, spills and wgmma notes of each
    build."""
    from .flash_plans import build
    libs = build({tag: (CSRC / "wgmma_chain.cu", CSRC, flags, _WGMMA_SIG)
                  for tag, flags in DIAG_BUILDS.items()})
    for tag in ["wgmma_chain"] + [f"flash_plans/{t}" for t in DIAG_BUILDS]:
        log = BUILD_DIR / f"{tag}.log"
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line or "wgmma" in line:
                print(f"  ptxas {tag}: {line.strip()}", flush=True)
    libs = {"this": cuda_lib("wgmma_chain", _WGMMA_SIG), **libs}
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for m, k in shapes:
        x = probe_inputs(m, k, g)
        for arm, a, b in (("int8", x["a8"], x["b8"]), ("bf16", x["a16"], x["b16"])):
            plan, times = chain_plan(k, a.dtype), {}
            for tag, lib in libs.items():
                o = torch.empty_like(a)
                run = lambda lib=lib, o=o: launch_wgmma(lib, a, b, o, None, steps, plan)
                run()
                if tag == "no_pingpong" and arm == "int8":
                    same = bool(torch.equal(o, mma_chain(a, b, steps)))
                    print(f"  {tag} {m}x{k} int8: equal to this build's chain {same}")
                times[tag] = device_ms(run, KERNEL_NAME["wgmma"])
            out[f"{arm} {m}x{k}"] = times
            print(f"  wgmma {arm} {m}x{k}x{k} x{steps}, device time: " + ", ".join(
                f"{tag} {t:.4f} ms" for tag, t in times.items()), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--diag", action="store_true",
                    help="also time the wgmma route's timing-only rebuilds")
    args = ap.parse_args()
    main()
    if args.diag:
        diagnostics()
