"""K6's plans and phases timed, and an earlier K6 held bit for bit
(``csrc/gn_int8.cu``).

K6 takes a tile of (batch element, span of whole groups, range of pixels)
in 16-byte channel vectors, and splits a slice's pixels over a cluster of
R blocks where the plan says so.  This probe builds (one ``nvcc`` a build,
all started together):

* this tree's K6 whole and stopped after the mean and after the inverse
  deviation (``-DK6_STOP_AFTER=0, 1``), so its passes are the differences
  of neighbouring builds' times; timing-only builds with wrong results
  (``-DK6_DIAG``): no swish, a product in place of the division by Δ, no
  reciprocal in the swish; and builds with other launch bounds
  (``-DK6_BLOCKS_AN_SM``), each with ``ptxas``'s registers;
* with ``--parent DIR`` (a checkout of an earlier commit, e.g. unpacked
  from ``git archive``), that checkout's ``gn_int8.cu`` with the C
  interface it had before K6 took a plan, whole and with stops written
  into the probe's own copy of its source (``K6_PARENT_STOP``: after the
  mean, after the inverse deviation), so its statistics and write phases
  are timed apart.

At ``chip_smoke.py``'s five K6 shapes (bf16, the serving carrier) it times
the phases of both, the diagnostic builds, this K6 under every plan that
fits (span, R, and a half and a quarter of the plan's threads: each held
bit for bit against ``gn_plan``'s; device time by the profiler), and the
parent in turns with this K6 (parent, this, this, parent; by CUDA events
and by the profiler, since at the small shapes a call's event time is the
host's launch path).  With ``--parent`` it also compares the two
kernels' codes and outputs bit for bit at those shapes and the card tests'
``GN`` shapes, in bf16 and float32: it counts the (batch, group) slices
whose outputs differ (a slice whose float64 sums, added in two orders,
straddle a float32 rounding boundary; 0 expected).

    python -m eda_dm_tpu_torch.probes.gn_plans [--parent DIR] [--json PATH]

It prints the card's name and power limit, one line a number, and writes
them all to ``--json``.
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import torch

from ..device import resolve_device
from ..ops import _build
from ..ops.gn_int8 import (_GN_SIG, K6_CLUSTERS, K6_PLAN_ARGS, K6_VEC, NO_PADS,
                           gn_launch_plan, gn_plan)
from .attention_phases import card
from .flash_plans import build
from .mma_int8 import cuda_ms, device_ms

SAME = ((1, 1), (1, 1))
# chip_smoke.py's K6 shapes: (b, h, w, c, pads or None for gn_norm, swish)
SMOKE = ((500, 32, 32, 128, SAME, True), (500, 32, 32, 384, SAME, True),
         (500, 16, 16, 256, None, True), (50, 16, 16, 672, SAME, True),
         (8, 16, 16, 1280, NO_PADS, False))
# the card tests' GN shapes
CARD = ((3, 7, 9, 96, SAME, True), (2, 5, 6, 672, ((0, 1), (0, 1)), True),
        (2, 8, 8, 1280, NO_PADS, False), (1, 32, 32, 416, SAME, True),
        (2, 32, 32, 384, SAME, True), (2, 16, 16, 128, None, True),
        (3, 4, 4, 64, None, False), (40, 32, 32, 128, SAME, True),
        (33, 32, 32, 128, SAME, True), (32, 32, 32, 128, SAME, True),
        (17, 32, 32, 128, SAME, True), (16, 32, 32, 128, SAME, True),
        (9, 32, 32, 128, SAME, True), (8, 32, 32, 128, SAME, True),
        (1, 853, 16, 32, SAME, True), (2, 16, 16, 224, SAME, True),
        (2, 16, 16, 672, ((0, 1), (0, 1)), False), (3, 16, 16, 1280, SAME, True),
        (8, 16, 16, 1280, None, True), (5, 16, 16, 1280, ((0, 1), (0, 1)), True),
        (4, 16, 16, 1280, None, False), (3, 16, 16, 1280, NO_PADS, False),
        (2, 16, 16, 1280, SAME, True), (1, 16, 16, 1280, None, False),
        (1, 16, 16, 320, SAME, True), (1, 2, 4, 16384, SAME, True),
        (1, 2, 4, 54560, SAME, True))
STOPS = (0, 1)
# builds that leave part of the write pass out (K6_DIAG; wrong results,
# timing only), and launch bounds of more blocks an SM (K6_BLOCKS_AN_SM)
DIAGNOSTICS = {"no-swish": ["-DK6_DIAG=1"], "no-division": ["-DK6_DIAG=2"],
               "no-reciprocal": ["-DK6_DIAG=4"], "none-of-the-three": ["-DK6_DIAG=7"],
               "1-block-an-SM": ["-DK6_BLOCKS_AN_SM=1"], "3-blocks-an-SM": ["-DK6_BLOCKS_AN_SM=3"]}
# the parent's C interface (no plan arguments)
_PARENT_SIG = {"edm_gn_int8": _GN_SIG["edm_gn_int8"][:19] + [_GN_SIG["edm_gn_int8"][-1]]}
# where the parent's stops go: (text the stop follows, stop, its sink)
PARENT_ANCHORS = (
    ("  const float mean = __fdiv_rn(__double2float_rn(block_sum(s, red)), cnt);\n", 0,
     "mean"),
    ("  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));\n", 1, "inv"))
D, ZP, LEVELS, EPS = 0.043, 57.0, 256, 1e-6


def parent_with_stops(text: str) -> str:
    """The parent K6's source with ``K6_PARENT_STOP`` points: each block
    returns after the stop's statistic, storing it (on a value no input
    reaches) so that the compiler keeps every thread's work."""
    for anchor, stop, sink in PARENT_ANCHORS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"the parent's K6 source differs: no single {anchor!r}")
        text = text.replace(anchor, anchor + (
            f"#if defined(K6_PARENT_STOP)\n  if (K6_PARENT_STOP == {stop}) {{\n"
            f"    if ({sink} == 1.2345e-30f) reinterpret_cast<unsigned char*>(out)"
            "[blockIdx.x] = 0;\n    return;\n  }\n#endif\n"))
    return text


def inputs(g, b, h, w, c, dtype):
    """chip_smoke.py's K6 inputs: x, scale, bias, Δ and zp."""
    x = (2.1 * torch.randn(b, h, w, c, generator=g, device="cuda") + 0.3).to(dtype)
    scale = 0.5 + torch.rand(c, generator=g, device="cuda")
    bias = 0.1 * torch.randn(c, generator=g, device="cuda")
    return (x, scale, bias, torch.tensor(D, device="cuda"), torch.tensor(ZP, device="cuda"))


def output(x, pads):
    """An empty output: padded int8 codes, or y in x's dtype (``pads`` None)."""
    b, h, w, c = x.shape
    if pads is None:
        return torch.empty_like(x)
    (pt, pb), (pl, pr) = pads
    return torch.empty((b, h + pt + pb, w + pl + pr, c), dtype=torch.int8, device="cuda")


def launcher(lib, x, scale, bias, d, zp, out, pads, swish, plan=None):
    """One launch through a built library: K6 under ``plan`` (default
    ``gn_plan``'s), or, with ``plan="parent"``, the plan-free interface."""
    b, h, w, c = x.shape
    quant = pads is not None
    (pt, pb), (pl, pr) = pads if quant else NO_PADS
    args = [_build.ptr(t) for t in (x, scale, bias, d if quant else None,
                                    zp if quant else None, out)]
    args += [int(x.dtype == torch.bfloat16), int(swish), b, h, w, c, 32,
             LEVELS if quant else 0, pt, pb, pl, pr, EPS]
    if plan == "parent":
        err = lib.edm_gn_int8(*args, _build.stream_ptr(x.device))
    else:
        p = plan or gn_plan(b, h, w, c, x.dtype)
        err = lib.edm_gn_int8(*args, *(p[k] for k in K6_PLAN_ARGS),
                              _build.stream_ptr(x.device))
    _build.check_launch(lib, err, "K6")


def run(fn, x, pads):
    out = output(x, pads)
    fn(out)
    torch.cuda.synchronize()
    return out


def compare(a, b, pads, c) -> dict:
    """Two outputs: (batch, group) slices whose interior outputs differ,
    and whether the rims are equal."""
    if pads is not None:
        (pt, pb), (pl, pr) = pads
        h, w = a.shape[1] - pt - pb, a.shape[2] - pl - pr
        rim = torch.ones(a.shape[1:3], dtype=torch.bool, device=a.device)
        rim[pt:pt + h, pl:pl + w] = False
        rim_equal = bool(torch.equal(a[:, rim], b[:, rim]))
        a, b = a[:, pt:pt + h, pl:pl + w], b[:, pt:pt + h, pl:pl + w]
    else:
        rim_equal = True
    diff = (a != b).reshape(a.shape[0], -1, 32, c // 32).any(-1).any(1)
    return {"slices": int(diff.numel()), "slices_differ": int(diff.sum()),
            "equal": bool(torch.equal(a, b)) and rim_equal, "rim_equal": rim_equal}


def registers(tag) -> list:
    """``ptxas``'s registers of each kernel instance of a probe build."""
    log = _build.BUILD_DIR / "flash_plans" / f"{tag}.log"
    return [int(m) for m in re.findall(r"Used (\d+) registers", log.read_text())]


def plans(b, h, w, c, dtype):
    """Every plan that fits: spans of 2^i times ``gn_plan``'s (whole groups
    that divide C), R in ``K6_CLUSTERS``, the plan's lanes and a half and a
    quarter of them."""
    esz = torch.empty((), dtype=dtype).element_size()
    base = gn_plan(b, h, w, c, dtype)["span"]
    spans, span = [], base
    while c % span == 0 and span <= c:
        spans.append(span)
        span *= 2
    out = []
    for span in spans:
        for r in K6_CLUSTERS:
            p = gn_launch_plan(h, w, c, esz, span, r)
            if p is None:
                continue
            out.append(p)
            for div in (2, 4):
                q = gn_launch_plan(h, w, c, esz, span, r, lanes=max(1, p["lanes"] // div))
                if q is not None and q not in out:
                    out.append(q)
    return out


def main(parent=None, json_path=None, device=None) -> dict:
    if resolve_device(device).type != "cuda":
        raise RuntimeError("gn_plans times kernels: it needs a CUDA card")
    csrc = _build.CSRC
    k6 = csrc / "gn_int8.cu"
    builds = {"k6-this": (k6, csrc, [], _GN_SIG)}
    builds.update({f"k6-this-stop{p}": (k6, csrc, [f"-DK6_STOP_AFTER={p}"], _GN_SIG)
                   for p in STOPS})
    builds.update({f"k6-this-{tag}": (k6, csrc, flags, _GN_SIG)
                   for tag, flags in DIAGNOSTICS.items()})
    if parent:
        pcsrc = Path(parent) / "eda_dm_tpu_torch" / "csrc"
        copy = _build.BUILD_DIR / "flash_plans" / "gn_int8_parent_stops.cu"
        copy.parent.mkdir(parents=True, exist_ok=True)
        copy.write_text(parent_with_stops((pcsrc / "gn_int8.cu").read_text()))
        builds["k6-parent"] = (pcsrc / "gn_int8.cu", pcsrc, [], _PARENT_SIG)
        builds.update({f"k6-parent-stop{p}": (copy, pcsrc, [f"-DK6_PARENT_STOP={p}"],
                                           _PARENT_SIG) for p in STOPS})
    libs = {tag[3:]: lib for tag, lib in build(builds).items()}
    result = {"card": card(), "registers": {tag: registers(f"k6-{tag}") for tag in libs},
              "phases": {}, "parent_phases": {}, "diagnostics": {}, "plans": {}, "turns": {},
              "bitwise": {}}
    print(f"card: {result['card']}", flush=True)
    for tag, regs in result["registers"].items():
        print(f"K6 build {tag}: registers by instance {regs}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, h, w, c, pads, swish in SMOKE:
        x, scale, bias, d, zp = inputs(g, b, h, w, c, torch.bfloat16)
        out = output(x, pads)
        shape = f"({b}, {h}, {w}, {c}) {'gn_norm' if pads is None else 'codes'} bf16"
        call = lambda tag, plan=None: (lambda: launcher(libs[tag], x, scale, bias, d, zp,
                                                         out, pads, swish, plan))
        t = [cuda_ms(call(f"this-stop{p}")) for p in STOPS] + [cuda_ms(call("this"))]
        ph = {"load_and_mean": t[0], "variance": t[1] - t[0], "write": t[2] - t[1],
              "whole": t[2]}
        result["phases"][shape] = ph
        print(f"K6 {shape} plan {gn_plan(b, h, w, c, x.dtype)}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ph.items()) + " ms", flush=True)
        for tag in DIAGNOSTICS:
            ms = cuda_ms(call(f"this-{tag}"))
            result["diagnostics"][f"{tag} {shape}"] = ms
            print(f"K6 {shape} {tag} (timing only): {ms:.4f} ms", flush=True)
        if parent:
            t = [cuda_ms(call(f"parent-stop{p}", "parent")) for p in STOPS]
            t.append(cuda_ms(call("parent", "parent")))
            ph = {"load_and_mean": t[0], "variance": t[1] - t[0], "write": t[2] - t[1],
                  "whole": t[2]}
            result["parent_phases"][shape] = ph
            print(f"K6 parent {shape}: " + ", ".join(f"{k} {v:.4f}" for k, v in ph.items())
                  + " ms", flush=True)
        ref = run(lambda o: launcher(libs["this"], x, scale, bias, d, zp, o, pads, swish),
                  x, pads)
        for p in plans(b, h, w, c, x.dtype):
            got = run(lambda o: launcher(libs["this"], x, scale, bias, d, zp, o, pads, swish,
                                         p), x, pads)
            same = compare(ref, got, pads, c)
            del got
            ms = device_ms(call("this", p), "gn_kernel")
            key = f"{shape} span {p['span']} r {p['r']} lanes {p['lanes']}"
            result["plans"][key] = dict(ms=ms, plan=p, **same)
            print(f"K6 {key} pix {p['pix']} lanes {p['lanes']} threads {p['threads']} smem "
                  f"{p['smem']}: {ms:.4f} ms, against the plan's: {same}", flush=True)
        if parent:
            order = ("parent", "this", "this", "parent")
            turns = [cuda_ms(call(tag, "parent" if tag == "parent" else None))
                     for tag in order]
            result["turns"][shape] = list(zip(order, turns))
            print(f"K6 {shape} parent, this, this, parent: "
                  + " / ".join(f"{v:.4f}" for v in turns) + " ms", flush=True)
            dev = [device_ms(call(tag, "parent" if tag == "parent" else None), "gn_kernel")
                   for tag in order]
            result["turns"][shape + " (profiler)"] = list(zip(order, dev))
            print(f"K6 {shape} device time by the profiler, parent, this, this, parent: "
                  + " / ".join(f"{v:.4f}" for v in dev) + " ms", flush=True)
        del x, out, ref
    if parent:
        g = torch.Generator(device="cuda").manual_seed(0)
        for b, h, w, c, pads, swish in SMOKE + CARD:
            for dtype in (torch.bfloat16, torch.float32):
                x, scale, bias, d, zp = inputs(g, b, h, w, c, dtype)
                old = run(lambda o: launcher(libs["parent"], x, scale, bias, d, zp, o, pads,
                                             swish, "parent"), x, pads)
                new = run(lambda o: launcher(libs["this"], x, scale, bias, d, zp, o, pads,
                                             swish), x, pads)
                rec = compare(old, new, pads, c)
                key = f"({b}, {h}, {w}, {c}) {pads} swish {swish} {str(dtype)[6:]}"
                result["bitwise"][key] = rec
                print(f"K6 parent vs this {key}: {rec}", flush=True)
                del x, old, new
    if json_path:
        Path(json_path).parent.mkdir(parents=True, exist_ok=True)
        Path(json_path).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit whose K6 to compare")
    ap.add_argument("--json", help="write the numbers here")
    a = ap.parse_args()
    main(a.parent, a.json)
