"""K5's plans and phases timed, the sweep route's sweeps timed apart, and
an earlier K5 held bit for bit (``csrc/int8_flash_attention.cu``).

K5 splits a row tile's keys over a cluster of R blocks, each holding its
slice's logits (one pass), with two W·V buffers (route ``one_pass``) or,
where two do not fit, one (``one_pass_wide``: ImageNet's C = 384); past
what 8 blocks hold it takes the sweep route, ``csrc/int8_flash_sweep.cu``
(the three-sweep kernel K5 was before its redesign).  This probe builds
(one ``nvcc`` a build, all started together):

* this tree's K5 whole and stopped before any work, after the logits,
  after the codes and after W·V (``-DK5_STOP_AFTER=0 … 3``), so its phases
  are the differences of neighbouring builds' times; with
  ``-DK5_CLOCKS``, which counts the cycles of each stretch of an item;
  three timing-only builds with wrong results (``-DK5_DIAG``): block
  barriers in place of the cluster's, no exponentials, no divisions; and
  one that admits clusters of 16 blocks (``-DK5_R_MAX=16``, a
  non-portable size);
* the sweep route, whole and with a stop written into the probe's own
  copy of its source (``K5_SWEEP_STOP``: before any sweep, after the max
  sweep, after the sum sweep), so its three sweeps are timed apart;
* with ``--parent DIR`` (a checkout of an earlier commit whose K5 takes
  the plan's arguments, e.g. unpacked from ``git archive``), that
  checkout's ``int8_flash_attention.cu`` and ``int8_flash_sweep.cu``.

At SD's 64×64 self-attention (64 and 16 (b·h) elements, 4096 queries and
keys, C = 40) and ImageNet's 32×32 one (100 elements, 1024 queries and
keys, C = 384) it times every phase and diagnostic build, prints the
cycles an item, times the sweep route's sweeps, K5 under each plan that
fits (either route, R = 1 … 16 blocks a cluster, 32 or 64 query rows an
item: each held bit for bit against ``flash_plan``'s), the port's unfused
chain K2 → K3 → K2, and the parent in turns with this tree's K5 (parent,
this, this, parent; the parent's K5 where its plan took the one pass, its
sweep route where not).  With ``--parent`` it also compares the two
trees' codes and outputs bit for bit at ``chip_smoke.py``'s K5 shapes and
the card tests' ``FLASH`` shapes: it counts the rows whose codes differ (a
row whose float64 row sums, added in two orders, straddle a float32
rounding boundary; 0 expected) and fails if an output differs on a row
whose codes agree.

    python -m eda_dm_tpu_torch.probes.flash_plans [--parent DIR] [--json PATH]

It prints the card's name and power limit, one line a number, and writes
them all to ``--json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from ..device import resolve_device
from ..ops import _build
from ..ops.int8_attention import (_FLASH_SIG, _SWEEP_SIG, K5_CLUSTERS, K5_ENTRY,
                                  K5_PLAN_ARGS, K5_ROUTES, _int8_flash_attention_cuda,
                                  attention_scalars, flash_plan, k5_plan)
from .attention_phases import card
from .mma_int8 import cuda_ms

# SD 64x64 at 8 and 2 rows, ImageNet 32x32 at 100 rows
TIMED = ((64, 4096, 4096, 40), (16, 4096, 4096, 40), (100, 1024, 1024, 384))
# chip_smoke.py's one-pass K5 shapes (n, sq, skv, c, softmax levels), then
# the card tests' FLASH shapes
SMOKE = ((64, 4096, 4096, 40, 256), (16, 4096, 4096, 40, 256), (8, 256, 512, 32, 256),
         (16, 4096, 4096, 40, 16), (100, 1024, 1024, 384, 256))
CARD = ((3, 64, 64, 40), (4, 100, 77, 40), (2, 256, 512, 32), (5, 33, 300, 8),
        (2, 130, 4096, 40), (2, 64, 128, 160), (2, 40, 200, 384), (1, 1, 1, 4),
        (16, 4096, 4096, 40), (2, 40, 832, 40), (2, 40, 833, 40), (2, 40, 1665, 40),
        (2, 40, 3329, 40), (2, 40, 6656, 40), (2, 40, 6657, 40), (2, 40, 100, 516),
        (2, 8, 300, 1024), (2, 40, 1024, 384), (2, 100, 1000, 384), (2, 33, 1280, 320),
        (2, 64, 2048, 256), (2, 64, 512, 512), (2, 130, 1024, 448))
# cluster sizes tried beside the plan's: 16 blocks only in the K5_R_MAX=16 build
PROBE_CLUSTERS = K5_CLUSTERS + (16,)
STOPS = (0, 1, 2, 3)
# builds that leave part of the work out (K5_DIAG; wrong results, timing only)
DIAGNOSTICS = {"block-barriers": 1, "no-exp": 2, "no-divisions": 4}
TQS = (32, 64)
# this tree's K5 with its probe query: the clusters its last launch held
_PROBE_SIG = {**_FLASH_SIG, "edm_int8_flash_last_clusters": []}
# the parent's C interface: K5 with the plan's arguments, two W·V buffers
_PARENT_SIG = {"edm_int8_flash_attention": _FLASH_SIG["edm_int8_flash_attention"]}
# where the sweep route's stops go: (text the stop follows, stop, its sink)
SWEEP_ANCHORS = (
    ("  for (int m = 0; m < 4; ++m) qterm[m] = "
     "__fmul_rn(ck, __int2float_rn(sq[ty + 16 * m]));\n",
     0, "qterm[0] + qterm[1] + qterm[2] + qterm[3]"),
    ("  for (int m = 0; m < 4; ++m) mrow[m] = max16(mrow[m]);\n",
     1, "mrow[0] + mrow[1] + mrow[2] + mrow[3]"),
    ("  for (int m = 0; m < 4; ++m) srow[m] = __double2float_rn(sum16(s64[m]));\n",
     2, "srow[0] + srow[1] + srow[2] + srow[3]"))


def sweep_with_stops(text: str) -> str:
    """The sweep route's source with ``K5_SWEEP_STOP`` points: each block
    returns after the stop's sweep, storing (on a value no input reaches)
    what the sweep computed, so the compiler keeps every thread's work."""
    for anchor, stop, sink in SWEEP_ANCHORS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"the sweep route's source changed: no single {anchor!r}")
        text = text.replace(anchor, anchor + (
            f"#if defined(K5_SWEEP_STOP)\n  if (K5_SWEEP_STOP == {stop}) {{\n"
            f"    if ({sink} == 1.2345e-30f) out[blockIdx.x] = 0.f;\n    return;\n  }}\n"
            "#endif\n"))
    return text


def build(builds: dict) -> dict:
    """One library a build (tag -> (source, include directory, extra nvcc
    flags, signatures)), all started together: ``{tag: lib}``."""
    out_dir = _build.BUILD_DIR / "flash_plans"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for tag, (src, inc, flags, sig) in builds.items():
        so = out_dir / f"{tag}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, f"-I{inc}", "-o", str(so), str(src)]
        procs.append((tag, so, sig, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)))
    libs, failed = {}, []
    for tag, so, sig, p in procs:
        log, _ = p.communicate()
        (out_dir / f"{tag}.log").write_text(log)
        if p.returncode:
            failed.append(f"{tag}:\n{log}")
        else:
            libs[tag] = _build.load_lib(so, sig)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return libs


def inputs(g, n, sq, skv, c, levels=256):
    """chip_smoke.py's K5 inputs: seeded codes and its scalars."""
    Q, K, V = (torch.randint(-128, 128, (n, s, c), generator=g, device="cuda",
                             dtype=torch.int32).to(torch.int8) for s in (sq, skv, skv))
    sc = attention_scalars(3.0, 0.021, -5.0, 0.017, 1.0, 0.025, c ** -0.5,
                           1.0 / (levels - 1), 0.0, "cuda")
    return Q, K, V, sc


def launcher(lib, Q, K, V, sc, out, codes=None, plan=None, levels=256):
    """One launch through a built library: K5 under ``plan`` (default
    ``flash_plan``'s) through its route's entry point, or, with
    ``plan="sweep"``, the sweep route."""
    n, sq, c = Q.shape
    args = [_build.ptr(x) for x in (Q, K, V, sc, out, codes)] + [n, sq, K.shape[1], c, levels]
    if plan == "sweep":
        err = lib.edm_int8_flash_sweep(*args, _build.stream_ptr(Q.device))
    else:
        p = plan or flash_plan(sq, K.shape[1], c)
        err = getattr(lib, K5_ENTRY[p["route"]])(*args, *(p[k] for k in K5_PLAN_ARGS),
                                                 _build.stream_ptr(Q.device))
    _build.check_launch(lib, err, "K5")


def parent_launcher(libs, Q, K, V, sc, out, codes=None, levels=256):
    """The parent tree's launch at this shape: its K5 under the plan it
    had (the one-pass plan with two W·V buffers where one fits), else its
    sweep route."""
    plan = flash_plan(Q.shape[1], K.shape[1], Q.shape[2])
    if plan["route"] == "one_pass":
        launcher(libs["parent"], Q, K, V, sc, out, codes, plan, levels)
    else:
        launcher(libs["parent-sweep"], Q, K, V, sc, out, codes, "sweep", levels)


def run(fn, Q, K):
    """(out, codes) of one launch ``fn(out, codes)``."""
    n, sq, c = Q.shape
    out = torch.empty((n, sq, c), dtype=torch.float32, device="cuda")
    codes = torch.empty((n, sq, K.shape[1]), dtype=torch.int8, device="cuda")
    fn(out, codes)
    torch.cuda.synchronize()
    return out, codes


def chain_ms(Q, K, V, levels=256):
    """The port's unfused chain K2 → K3 → K2 on the same inputs."""
    from ..ops.int8_einsum import int8_code_einsum
    from ..ops.softmax_codes import softmax_int8_codes
    c = Q.shape[2]
    tq, tk, tv, tdq, tdk, tdv, tdw, tzw = (
        torch.tensor(v, device="cuda")
        for v in (3.0, -5.0, 1.0, 0.021, 0.017, 0.025, 1.0 / (levels - 1), 0.0))

    def chain():
        w = int8_code_einsum("nic,njc->nij", Q, tq, tdq, K, tk, tdk) * (c ** -0.5)
        W, cw = softmax_int8_codes(w, tdw, tzw, levels)
        return int8_code_einsum("nij,njc->nic", W, cw, tdw, V, tv, tdv)
    return cuda_ms(chain, reps=5, warmup=1)


# the stretches of an item that a K5_CLOCKS build times (ticks[k])
STRETCHES = ("start", "logits", "barrier A", "exponentials", "epilogue", "wait B", "codes",
             "W·V")


def clocks(lib, Q, K, V, sc, out) -> dict:
    """Cycles an item spends in each stretch, from a ``K5_CLOCKS`` build:
    the mean over the blocks that had items, for the first warp and for
    the last (the first also writes the epilogue)."""
    out.zero_()
    launcher(lib, Q, K, V, sc, out)
    torch.cuda.synchronize()
    rec = out.flatten()[:18 * 1024].view(1024, 18)
    rec = rec[(rec[:, 17] == 12345.0) & (rec[:, 16] > 0)]
    per_item = rec[:, :16] / rec[:, 16:17]
    res = {"blocks": int(rec.shape[0]), "items_per_block": float(rec[:, 16].mean())}
    print(f"K5 clocks: {res['blocks']} blocks ran, {res['items_per_block']:.1f} items each",
          flush=True)
    for w, name in ((0, "warp 0"), (8, "last warp")):
        res[name] = {k: float(per_item[:, w + i].mean()) for i, k in enumerate(STRETCHES)}
        print(f"K5 clocks, {name}, cycles an item: " + ", ".join(
            f"{k} {v:.0f}" for k, v in res[name].items()), flush=True)
    return res


def compare(a, b) -> dict:
    """Two (out, codes) results: rows whose codes differ, and whether the
    outputs are equal on the rest."""
    (oa, ca), (ob, cb) = a, b
    rows = (ca != cb).any(-1)
    same = ~rows
    return {"rows": int(rows.numel()), "rows_codes_differ": int(rows.sum()),
            "codes_equal": bool(torch.equal(ca, cb)),
            "outputs_equal_where_codes_agree": bool(torch.equal(oa[same], ob[same])),
            "outputs_equal": bool(torch.equal(oa, ob))}


def main(parent=None, json_path=None, device=None) -> dict:
    if resolve_device(device).type != "cuda":
        raise RuntimeError("flash_plans times kernels: it needs a CUDA card")
    csrc = _build.CSRC
    sweep_src = _build.BUILD_DIR / "flash_plans" / "int8_flash_sweep_stops.cu"
    sweep_src.parent.mkdir(parents=True, exist_ok=True)
    sweep_src.write_text(sweep_with_stops((csrc / "int8_flash_sweep.cu").read_text()))
    k5, sweep = csrc / "int8_flash_attention.cu", csrc / "int8_flash_sweep.cu"
    builds = {"this": (k5, csrc, [], _PROBE_SIG), "sweep": (sweep, csrc, [], _SWEEP_SIG)}
    builds.update({f"this-stop{p}": (k5, csrc, [f"-DK5_STOP_AFTER={p}"], _FLASH_SIG)
                   for p in STOPS})
    builds.update({f"this-{tag}": (k5, csrc, [f"-DK5_DIAG={d}"], _FLASH_SIG)
                   for tag, d in DIAGNOSTICS.items()})
    builds["this-clocks"] = (k5, csrc, ["-DK5_CLOCKS"], _FLASH_SIG)
    builds["this-r16"] = (k5, csrc, ["-DK5_R_MAX=16"], _PROBE_SIG)
    builds.update({f"sweep-stop{p}": (sweep_src, csrc, [f"-DK5_SWEEP_STOP={p}"], _SWEEP_SIG)
                   for p in STOPS[:3]})
    if parent:
        pcsrc = Path(parent) / "eda_dm_tpu_torch" / "csrc"
        builds["parent"] = (pcsrc / "int8_flash_attention.cu", pcsrc, [], _PARENT_SIG)
        builds["parent-sweep"] = (pcsrc / "int8_flash_sweep.cu", pcsrc, [], _SWEEP_SIG)
    libs = build(builds)
    result = {"card": card(), "phases": {}, "diagnostics": {}, "clocks": {}, "sweeps": {},
              "plans": {},
              "turns": {},
              "chain_ms": {}, "bitwise": {}}
    print(f"card: {result['card']}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for n, sq, skv, c in TIMED:
        Q, K, V, sc = inputs(g, n, sq, skv, c)
        out = torch.empty((n, sq, c), dtype=torch.float32, device="cuda")
        shape = f"({n}, {sq}, {skv}, {c})"
        t = [cuda_ms(lambda: launcher(libs[f"this-stop{p}"], Q, K, V, sc, out))
             for p in STOPS] + [cuda_ms(lambda: launcher(libs["this"], Q, K, V, sc, out))]
        ph = {"launch": t[0], "logits": t[1] - t[0], "codes": t[2] - t[1], "wv": t[3] - t[2],
              "epilogue": t[4] - t[3], "whole": t[4]}
        result["phases"][shape] = ph
        print(f"K5 {shape} plan {flash_plan(sq, skv, c)}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ph.items()) + " ms", flush=True)
        result["clocks"][shape] = clocks(libs["this-clocks"], Q, K, V, sc, out)
        for tag in DIAGNOSTICS:
            ms = cuda_ms(lambda: launcher(libs[f"this-{tag}"], Q, K, V, sc, out))
            result["diagnostics"][f"{tag} {shape}"] = ms
            print(f"K5 {shape} {tag} (timing only): {ms:.4f} ms", flush=True)
        t = [cuda_ms(lambda: launcher(libs[f"sweep-stop{p}"], Q, K, V, sc, out, plan="sweep"),
                     reps=5) for p in STOPS[:3]]
        t.append(cuda_ms(lambda: launcher(libs["sweep"], Q, K, V, sc, out, plan="sweep"),
                         reps=5))
        sw = {"launch_and_q": t[0], "max": t[1] - t[0], "sum": t[2] - t[1],
              "codes_and_wv": t[3] - t[2], "whole": t[3]}
        result["sweeps"][shape] = sw
        print(f"K5 sweep route {shape}: " + ", ".join(f"{k} {v:.4f}" for k, v in sw.items())
              + " ms", flush=True)
        ref = run(lambda o, cd: launcher(libs["this"], Q, K, V, sc, o, cd), Q, K)
        for nbuf, route in K5_ROUTES.items():
            for r in PROBE_CLUSTERS:
                for tq in TQS:
                    p = k5_plan(r, tq, skv, c, nbuf)
                    if p is None:
                        continue
                    lib = libs["this-r16" if r > max(K5_CLUSTERS) else "this"]
                    tag = f"{shape} {route} r {r} tq {tq} kb {p['kb']}"
                    try:
                        got = run(lambda o, cd: launcher(lib, Q, K, V, sc, o, cd, plan=p), Q, K)
                    except RuntimeError as e:    # a cluster size the card cannot place
                        result["plans"][tag] = dict(refused=str(e), smem=p["smem"],
                                                    clusters=lib.edm_int8_flash_last_clusters())
                        print(f"K5 {tag} smem {p['smem']}: refused ({e})", flush=True)
                        continue
                    same = all(torch.equal(x, y) for x, y in zip(got, ref))
                    del got
                    ms = cuda_ms(lambda: launcher(lib, Q, K, V, sc, out, plan=p))
                    clusters = lib.edm_int8_flash_last_clusters()
                    result["plans"][tag] = dict(ms=ms, bitwise=same, smem=p["smem"],
                                                clusters=clusters)
                    print(f"K5 {tag} smem {p['smem']}: {ms:.4f} ms, {clusters} clusters at "
                          f"once, bit for bit with the plan's: {same}", flush=True)
                    if not same:
                        raise RuntimeError(f"K5 at {shape}: plan {p} changes the result")
        del ref
        if parent:
            order = ("parent", "this", "this", "parent")
            turns = [cuda_ms(lambda: parent_launcher(libs, Q, K, V, sc, out) if tag == "parent"
                             else launcher(libs["this"], Q, K, V, sc, out), reps=10)
                     for tag in order]
            result["turns"][shape] = list(zip(order, turns))
            print(f"K5 {shape} parent, this, this, parent: "
                  + " / ".join(f"{x:.4f}" for x in turns) + " ms", flush=True)
        result["chain_ms"][shape] = chain_ms(Q, K, V)
        print(f"K2 -> K3 -> K2 {shape}: {result['chain_ms'][shape]:.4f} ms", flush=True)
        del Q, K, V, out
    if parent:
        g = torch.Generator(device="cuda").manual_seed(0)
        for n, sq, skv, c, levels in SMOKE + tuple(s + (256,) for s in CARD):
            Q, K, V, sc = inputs(g, n, sq, skv, c, levels)
            old = run(lambda o, cd: parent_launcher(libs, Q, K, V, sc, o, cd, levels), Q, K)
            new = _int8_flash_attention_cuda(Q, K, V, sc, levels, True)
            torch.cuda.synchronize()
            rec = dict(compare(old, new), route=flash_plan(sq, skv, c)["route"])
            key = f"({n}, {sq}, {skv}, {c}), {levels} levels"
            result["bitwise"][key] = rec
            print(f"K5 parent vs this {key}: {rec}", flush=True)
            if not rec["outputs_equal_where_codes_agree"]:
                raise RuntimeError(f"K5 outputs differ at {key} on rows whose codes agree")
            del Q, K, V, old, new
    if json_path:
        Path(json_path).parent.mkdir(parents=True, exist_ok=True)
        Path(json_path).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit whose K5 to compare")
    ap.add_argument("--json", help="write the numbers here")
    a = ap.parse_args()
    main(a.parent, a.json)
