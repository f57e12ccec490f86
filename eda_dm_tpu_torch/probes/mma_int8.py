"""Tensor-core rate probe (P1): how close does a hand-written kernel come
to the H100's int8 and bf16 matrix rates?

Port of ``scripts/probes/mosaic_int8.py``.  A kernel that keeps a chain of
``CHAIN`` dependent products on chip (``csrc/mma_chain.cu``, through
``mma.sync``) is timed beside the data-sheet peaks and beside the same
chain through PyTorch's library products (``torch._int_mm`` for int8,
``torch.matmul`` for bf16, each step's requantize as separate element-wise
passes), the counterparts of the TPU probe's XLA arms:

    int8:  a ← int8(wrap)((a·B) >> 8)       int32 sums, arithmetic shift
    bf16:  a ← bf16((a·B) · 0.01)           float32 sums

plus one exact int8 product (``one_mm``).  Rates are ``2·m·k²·CHAIN / t``.
Inputs are seeded: a and the int8 B full-range int8; the bf16 B uniform
integers in ±round(100·√3/√k), so that the bf16 chain stays finite for
all 40 steps (full-range B overflows it to inf).

    python -m eda_dm_tpu_torch.probes.mma_int8        # on one CUDA card

On a CUDA tensor :func:`mma_chain` and :func:`one_mm` launch the kernel;
on a CPU tensor they run their plain versions.
"""

from __future__ import annotations

import ctypes
import math
import statistics
from typing import Dict, List, Sequence, Tuple

import torch

from ..device import resolve_device
from ..ops._build import check_launch, cuda_lib, launch_counts, ptr, stream_ptr
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

_SIG = {"edm_mma_chain": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_void_p]}


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


def _mma_chain_cuda(a, b, steps, acc_out=False):
    m, k = a.shape if a.dim() == 2 else (0, 0)
    if a.dtype not in (torch.int8, torch.bfloat16) or b.dtype != a.dtype:
        raise ValueError(f"mma_chain takes int8 or bf16 operands of one type, not "
                         f"{a.dtype} and {b.dtype}")
    if a.dim() != 2 or tuple(b.shape) != (k, k) or b.device != a.device:
        raise ValueError(f"mma_chain takes a (M, K) and B (K, K) on one device, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if k % 128 or k > 512:
        raise ValueError(f"mma_chain takes K a multiple of 128 up to 512, not {k}")
    if acc_out and (a.dtype != torch.int8 or steps != 1):
        raise ValueError("int32 sums come from one int8 step")
    a, bt = a.contiguous(), b.t().contiguous()      # B's columns as rows
    out = torch.empty((m, k), dtype=torch.int32 if acc_out else a.dtype, device=a.device)
    lib = cuda_lib("mma_chain", _SIG)
    err = lib.edm_mma_chain(ptr(a), ptr(bt), ptr(None if acc_out else out),
                            ptr(out if acc_out else None), m, k, steps,
                            int(a.dtype == torch.bfloat16), stream_ptr(a.device))
    check_launch(lib, err, "mma_chain")
    launch_counts["mma_chain"] += 1
    return out


def mma_chain(a: torch.Tensor, b: torch.Tensor, steps: int = CHAIN) -> torch.Tensor:
    """``steps`` chained products of a (M, K) with B (K, K), int8 or bf16,
    requantized after each (module docstring); returns the last a."""
    if a.is_cuda:
        return _mma_chain_cuda(a, b, steps)
    if a.device.type != "cpu":
        raise ValueError(f"mma_chain: unsupported device {a.device}")
    return mma_chain_plain(a, b, steps)


def one_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The int32 product of int8 a (M, K) and B (K, K): the kernel's
    single step with its sums stored, on a CUDA tensor."""
    if a.is_cuda:
        return _mma_chain_cuda(a, b, 1, acc_out=True)
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


def probe_shape(m: int, k: int, generator: torch.Generator, device,
                steps: int = CHAIN) -> dict:
    """Both arms at one shape: the kernel's chain against its plain
    version (int8 bit-equal, bf16 within BF16_REL_L2 / BF16_REL_MAX), and
    on a card the kernel's and the library chain's times and rates."""
    x = probe_inputs(m, k, generator, device)
    res = {"m": m, "k": k, "steps": steps, "ops": 2 * m * k * k * steps}
    out8 = mma_chain(x["a8"], x["b8"], steps)
    res["int8_equal"] = bool(torch.equal(out8, mma_chain_plain(x["a8"], x["b8"], steps)))
    out16 = mma_chain(x["a16"], x["b16"], steps)
    rel_l2, rel_max = bf16_errors(out16, mma_chain_plain(x["a16"], x["b16"], steps))
    res.update(bf16_rel_l2=rel_l2, bf16_rel_max=rel_max,
               bf16_ok=bool(torch.isfinite(out16.float()).all()) and rel_l2 <= BF16_REL_L2
               and rel_max <= BF16_REL_MAX)
    if x["a8"].is_cuda:
        for arm, a, b in (("int8", x["a8"], x["b8"]), ("bf16", x["a16"], x["b16"])):
            ms = cuda_ms(lambda: mma_chain(a, b, steps))
            lib_ms = cuda_ms(lambda: library_chain(a, b, steps))
            mm_ms = cuda_ms(lambda: library_product(a, b))
            res[arm] = {"ms": ms, "library_ms": lib_ms, "library_mm_ms": mm_ms,
                        "rate": res["ops"] / ms * 1e3, "library_rate": res["ops"] / lib_ms * 1e3,
                        "library_mm_rate": res["ops"] / steps / mm_ms * 1e3,
                        "peak": PEAKS[arm]}
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
    """Run the probe: every shape of ``shapes`` in both arms, then the
    exact one_mm check at (512, 128)·(128, 128).  Prints one line a
    measurement and returns the results (rates only on a card)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    results = []
    for m, k in shapes:
        r = probe_shape(m, k, g, dev, steps)
        results.append(r)
        tag = f"{m}x{k}x{k}, {steps} steps"
        print(f"mma int8 chain {tag}: equal to the plain chain {r['int8_equal']}; bf16 "
              f"chain within tolerance {r['bf16_ok']} (rel L2 {r['bf16_rel_l2']:.3g}, "
              f"max {r['bf16_rel_max']:.3g} of max|ref|)", flush=True)
        for arm in ("int8", "bf16"):
            if arm not in r:
                print(f"mma {arm} {tag}: rate not measured (no card)")
                continue
            t = r[arm]
            print(f"mma {arm} {tag}: {t['ms']:.4f} ms = {t['rate'] / 1e12:.1f} T/s "
                  f"({t['rate'] / t['peak']:.1%} of the data sheet's "
                  f"{t['peak'] / 1e12:.0f}); library chain {t['library_ms']:.4f} ms = "
                  f"{t['library_rate'] / 1e12:.1f} T/s; one library product "
                  f"{t['library_mm_ms']:.4f} ms = {t['library_mm_rate'] / 1e12:.1f} T/s "
                  f"(the kernel at {t['rate'] / t['library_mm_rate']:.1%} of it)", flush=True)
    if dev.type == "cuda":
        chains = list(results)
        for arm in ("int8", "bf16"):
            lib = library_peak(arm, g)
            best = max(r[arm]["rate"] for r in chains)
            print(f"library {arm} product {lib['n']}^3: {lib['ms']:.4f} ms = "
                  f"{lib['rate'] / 1e12:.1f} T/s ({lib['rate'] / lib['peak']:.1%} of the "
                  f"data sheet); the kernel's best chain rate is {best / lib['rate']:.1%} "
                  f"of it", flush=True)
            results.append({"library_peak": arm, **lib})
    x = probe_inputs(512, 128, g, dev)
    exact = bool(torch.equal(one_mm(x["a8"], x["b8"]), int8_matmul_acc_plain(x["a8"], x["b8"])))
    print(f"mma s8 matmul exact: {exact}", flush=True)
    results.append({"one_mm_exact": exact})
    return results


if __name__ == "__main__":
    main()
