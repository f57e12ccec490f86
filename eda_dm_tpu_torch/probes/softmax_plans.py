"""K3's phases and plans timed, and an earlier K3 held code for code
(``csrc/softmax_codes.cu``).

K3 takes a tile of whole rows a block, loaded as one contiguous span, and
``tpr`` threads a row.  This probe builds (one ``nvcc`` a build, all
started together) this tree's K3 whole and stopped after the tile's load
and after the row statistics (``-DK3_STOP_AFTER=0, 1``), so its phases are
the differences of neighbouring builds' times; timing-only builds with
wrong codes (``-DK3_DIAG``): products in place of both divisions,
``__expf`` in place of ``expf``, no loads (the arithmetic alone), float32
sums; and builds whose launch bounds ask 2 to 4 blocks an SM
(``-DK3_BLOCKS_AN_SM``) or that launch a block a tile (``-DK3_GRID_ALL``).

At ``chip_smoke.py``'s four K3 shapes (float32 logits) it times the phases,
the diagnostic builds, and this K3 under every plan it tries (tiles of 8
to 64 KB, 4 to 32 elements a thread: each held code for code against
``softmax_plan``'s; device time by the profiler).  With ``--parent DIR`` (a
checkout of an earlier commit, e.g. unpacked from ``git archive``), that
checkout's ``softmax_int8_codes`` (the Triton kernel before the redesign,
imported from its own package) runs in turns with this K3 (parent, this,
this, parent; by CUDA events and by the profiler), and the two kernels'
codes are compared at those shapes and the card tests' softmax shapes,
float32 and bfloat16: the rows whose codes differ are counted (a row whose
float64 sums, added in two orders, straddle a float32 rounding boundary; 0
expected), as are this K3's against the plain version.

    python -m eda_dm_tpu_torch.probes.softmax_plans [--parent DIR] [--json PATH]

It prints the card's name and power limit, one line a number, and writes
them all to ``--json``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

from ..device import resolve_device
from ..ops import _build
from ..ops.softmax_codes import (_K3_SIG, K3_PLAN_ARGS, k3_launch_plan, softmax_int8_codes_plain,
                                 softmax_plan)
from .attention_phases import card
from .flash_plans import build
from .gn_plans import registers
from .mma_int8 import cuda_ms, device_ms

# chip_smoke.py's K3 shapes (rows, S), then the card tests' softmax widths
SMOKE = ((500 * 256, 256), (500 * 16, 16), (50 * 28 * 64, 64), (64 * 4096, 77))
CARD = ((333, 16), (333, 64), (333, 77), (333, 256), (333, 300), (7, 1), (5, 33),
        (5, 1024), (3, 4096), (2, 5000), (2, 8193), (1, 32768))
STOPS = (0, 1)
# builds that leave part of the work out (K3_DIAG; wrong codes, timing
# only), and builds with other launch bounds or a block a tile
DIAGNOSTICS = {"no-divisions": ["-DK3_DIAG=1"], "fast-exp": ["-DK3_DIAG=2"],
               "arithmetic-only": ["-DK3_DIAG=4"], "f32-sums": ["-DK3_DIAG=8"],
               "2-blocks-an-SM": ["-DK3_BLOCKS_AN_SM=2"],
               "3-blocks-an-SM": ["-DK3_BLOCKS_AN_SM=3"],
               "4-blocks-an-SM": ["-DK3_BLOCKS_AN_SM=4"], "a-block-a-tile": ["-DK3_GRID_ALL"]}
TILES = (8 * 1024, 16 * 1024, 32 * 1024, 64 * 1024)
PER_THREAD = (4, 8, 16, 32)
D, ZP, LEVELS = 1.0 / 255.0, 0.0, 256


def parent_softmax(parent: str):
    """The parent checkout's ``softmax_int8_codes``, its package imported
    under another name so that both ports load side by side."""
    pkg = Path(parent) / "eda_dm_tpu_torch"
    name = "edm_parent_port"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.softmax_codes").softmax_int8_codes


def launcher(lib, x, d, zp, out, plan=None):
    """One launch of a built K3 library under ``plan`` (default
    ``softmax_plan``'s)."""
    r, s = x.shape
    p = plan or softmax_plan(r, s, x.dtype)
    err = lib.edm_softmax_codes(_build.ptr(x), _build.ptr(d), _build.ptr(zp), _build.ptr(out),
                                int(x.dtype == torch.bfloat16), r, s, LEVELS,
                                *(p[k] for k in K3_PLAN_ARGS), _build.stream_ptr(x.device))
    _build.check_launch(lib, err, "K3")


def rows_differ(a, b) -> int:
    return int((a != b).reshape(-1, a.shape[-1]).any(-1).sum())


def plans(r, s):
    """The plans tried: every tile in ``TILES`` with every aim of elements a
    thread in ``PER_THREAD``, without repeats."""
    out = []
    for tile in TILES:
        for per_thread in PER_THREAD:
            p = k3_launch_plan(r, s, 4, per_thread, tile)
            if p not in out:
                out.append(p)
    return out


def main(parent=None, json_path=None, device=None) -> dict:
    if resolve_device(device).type != "cuda":
        raise RuntimeError("softmax_plans times kernels: it needs a CUDA card")
    csrc = _build.CSRC
    k3 = csrc / "softmax_codes.cu"
    builds = {"k3-this": (k3, csrc, [], _K3_SIG)}
    builds.update({f"k3-this-stop{p}": (k3, csrc, [f"-DK3_STOP_AFTER={p}"], _K3_SIG)
                   for p in STOPS})
    builds.update({f"k3-this-{tag}": (k3, csrc, flags, _K3_SIG)
                   for tag, flags in DIAGNOSTICS.items()})
    libs = {tag[3:]: lib for tag, lib in build(builds).items()}
    old = parent_softmax(parent) if parent else None
    result = {"card": card(), "registers": {tag: registers(f"k3-{tag}") for tag in libs},
              "phases": {}, "diagnostics": {}, "plans": {}, "turns": {}, "codes": {}}
    print(f"card: {result['card']}", flush=True)
    for tag, regs in result["registers"].items():
        print(f"K3 build {tag}: registers by instance {regs}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    d, zp = torch.tensor(D, device="cuda"), torch.tensor(ZP, device="cuda")
    for r, s in SMOKE:
        x = 6.0 * torch.randn(r, s, generator=g, device="cuda")
        out = torch.empty((r, s), dtype=torch.int8, device="cuda")
        shape = f"({r}, {s}) f32"
        call = lambda tag, plan=None: (lambda: launcher(libs[tag], x, d, zp, out, plan))
        t = [device_ms(call(tag), "softmax_codes_kernel")
             for tag in [f"this-stop{p}" for p in STOPS] + ["this"]]
        ph = {"load": t[0], "statistics": t[1] - t[0], "codes_and_store": t[2] - t[1],
              "whole": t[2]}
        result["phases"][shape] = ph
        print(f"K3 {shape} plan {softmax_plan(r, s)}: device time "
              + ", ".join(f"{k} {v:.4f}" for k, v in ph.items()) + " ms", flush=True)
        for tag in DIAGNOSTICS:
            ms = device_ms(call(f"this-{tag}"), "softmax_codes_kernel")
            result["diagnostics"][f"{tag} {shape}"] = ms
            print(f"K3 {shape} {tag} (timing only): {ms:.4f} ms", flush=True)
        call("this")()
        ref = out.clone()
        for p in plans(r, s):
            call("this", p)()
            same = bool(torch.equal(out, ref))
            ms = device_ms(call("this", p), "softmax_codes_kernel")
            key = f"{shape} " + " ".join(f"{k} {p[k]}" for k in K3_PLAN_ARGS)
            result["plans"][key] = dict(ms=ms, plan=p, equal=same)
            print(f"K3 {key}: {ms:.4f} ms, codes equal to the plan's: {same}", flush=True)
        if old is not None:
            order = ("parent", "this", "this", "parent")
            fns = {"parent": lambda: old(x, d, zp, LEVELS), "this": call("this")}
            turns = [cuda_ms(fns[tag]) for tag in order]
            result["turns"][shape] = list(zip(order, turns))
            print(f"K3 {shape} parent, this, this, parent: "
                  + " / ".join(f"{v:.4f}" for v in turns) + " ms", flush=True)
            dev = [device_ms(fns[tag], "softmax_codes_kernel") for tag in order]
            result["turns"][shape + " (profiler)"] = list(zip(order, dev))
            print(f"K3 {shape} device time by the profiler, parent, this, this, parent: "
                  + " / ".join(f"{v:.4f}" for v in dev) + " ms", flush=True)
        del x, out, ref
    g = torch.Generator(device="cuda").manual_seed(0)
    for r, s in SMOKE + CARD:
        for dtype in (torch.float32, torch.bfloat16):
            x = (6.0 * torch.randn(r, s, generator=g, device="cuda")).to(dtype)
            new = torch.empty((r, s), dtype=torch.int8, device="cuda")
            launcher(libs["this"], x, d, zp, new)
            plain = softmax_int8_codes_plain(x, d, zp, LEVELS)
            rec = {"rows": r, "plain_rows_differ": rows_differ(new, plain),
                   "plain_most": int((new.int() - plain.int()).abs().max())}
            if old is not None and dtype == torch.float32:   # the parent took float32
                prev = old(x, d, zp, LEVELS)[0]
                rec.update(parent_rows_differ=rows_differ(new, prev),
                           parent_most=int((new.int() - prev.int()).abs().max()))
            key = f"({r}, {s}) {str(dtype)[6:]}"
            result["codes"][key] = rec
            print(f"K3 codes {key}: {rec}", flush=True)
            del x, new, plain
    if json_path:
        Path(json_path).parent.mkdir(parents=True, exist_ok=True)
        Path(json_path).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit whose K3 to compare")
    ap.add_argument("--json", help="write the numbers here")
    a = ap.parse_args()
    main(a.parent, a.json)
