"""K4's three phases timed apart, and two builds of K4 held bit for bit
(``csrc/int8_attention.cu``).

K4 runs three phases a work item: the logits (Q·Kᵀ and its epilogue),
the softmax codes, then W·V.  This probe builds the source six times
(one ``nvcc`` a build, all started together, with a parent's four): whole,
and stopped before any work (``-DK4_STOP_AFTER=0``: the launch, host calls included), after
the logits (``=1``) and after the codes (``=2``; the persistent K4 then
leaves each item after that phase and loads no V tile), and times each
at the bedroom's (700, 1024, 32) and SD's (64, 1024, 80).  Each phase is
the difference of two neighbouring builds' times.  Two more builds stop
after the logits with part of the work left out (``-DK4_DIAG``):
``no-epilogue`` (no Σk reduction over the lanes, f32 logits, stores or
row max) and ``loads-only`` (no products either), which split the logits
phase into its loads and barriers, its products and its epilogue.  It also times the whole kernel
under each K and V tile choice in ``TILES`` that fits
(``k4_smem_bytes``), holding each one's codes and outputs bit for bit
against ``attention_plan``'s, and the port's unfused chain K2 → K3 → K2
at the bedroom shape.

With ``--parent DIR`` (a checkout of an earlier commit that has the
stop points and the plan arguments, e.g. unpacked from ``git archive``)
it builds that checkout's K4 the same way, times it in turns with this
tree's (parent, this, this, parent), and at ``chip_smoke.py``'s seven K4
shapes compares the two kernels' codes and outputs bit for bit: it
counts the rows whose codes differ (a row whose float64 row sums, added
in two orders, straddle a float32 rounding boundary; 0 expected) and
fails if an output differs on a row whose codes agree.

    python -m eda_dm_tpu_torch.probes.attention_phases [--parent DIR] [--json PATH]

It prints the card's name and power limit, one line a number, and
writes them all to ``--json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from ..device import resolve_device
from ..ops import _build
from ..ops.int8_attention import (_ATTN_SIG, K4_PLAN_ARGS, attention_plan, attention_scalars,
                                  k4_smem_bytes)
from .mma_int8 import cuda_ms

SHAPES = ((700, 1024, 32), (1050, 256, 32), (8, 256, 256), (8, 16, 256),
          (64, 1024, 80), (64, 256, 160), (64, 64, 160))      # chip_smoke.py's K4 shapes
TIMED = ((700, 1024, 32), (64, 1024, 80))                     # bedroom 32x32, SD 32x32
TILES = ((256, 256), (256, 512), (512, 512), (512, 1024))     # K, V tile keys
STOPS = (None, 0, 1, 2)
# phase-1 builds with part of its work left out (K4_DIAG)
DIAGNOSTICS = {"no-epilogue": 1, "loads-only": 2}


def build(builds: dict) -> dict:
    """``int8_attention.cu`` once a build ((tag, name) -> (csrc directory,
    extra nvcc flags)), all started together: ``{tag: {name: lib}}``."""
    out_dir = _build.BUILD_DIR / "attention_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for (tag, name), (csrc, flags) in builds.items():
        so = out_dir / f"{tag}-{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, f"-I{csrc}", "-o", str(so),
               str(Path(csrc) / "int8_attention.cu")]
        procs.append((tag, name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True)))
    libs, failed = {}, []
    for tag, name, so, p in procs:
        log, _ = p.communicate()
        (out_dir / f"{tag}-{name}.log").write_text(log)
        if p.returncode:
            failed.append(f"{tag} {name}:\n{log}")
        else:
            libs.setdefault(tag, {})[name] = _build.load_lib(so, _ATTN_SIG)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return libs


def launcher(lib, Q, K, V, sc, out, codes=None, tiles=None):
    """One K4 launch through a built library, under ``attention_plan`` or
    with K and V tiles of ``tiles`` keys."""
    n, s, c = Q.shape
    p = attention_plan(s, c)
    if tiles:
        p = dict(p, tj=tiles[0], tv=tiles[1], smem=k4_smem_bytes(s, c, *tiles))
    err = lib.edm_int8_fused_attention(
        *(_build.ptr(t) for t in (Q, K, V, sc, out, codes)), n, s, c, 256,
        *(p[k] for k in K4_PLAN_ARGS), _build.stream_ptr(Q.device))
    _build.check_launch(lib, err, "K4")


def inputs(g, n, s, c):
    """chip_smoke.py's K4 inputs: seeded codes and its scalars."""
    Q, K, V = (torch.randint(-128, 128, (n, s, c), generator=g, device="cuda",
                             dtype=torch.int32).to(torch.int8) for _ in range(3))
    sc = attention_scalars(3.0, 0.021, -5.0, 0.017, 1.0, 0.025, c ** -0.5,
                           1.0 / 255.0, 0.0, "cuda")
    return Q, K, V, sc


def run(lib, Q, K, V, sc, tiles=None):
    """One launch with codes: (out, codes)."""
    n, s, c = Q.shape
    out = torch.empty((n, s, c), dtype=torch.float32, device="cuda")
    codes = torch.empty((n, s, s), dtype=torch.int8, device="cuda")
    launcher(lib, Q, K, V, sc, out, codes, tiles)
    torch.cuda.synchronize()
    return out, codes


def chain_ms(Q, K, V):
    """The port's unfused chain K2 → K3 → K2 on the same inputs."""
    from ..ops.int8_einsum import int8_code_einsum
    from ..ops.softmax_codes import softmax_int8_codes
    c = Q.shape[2]
    tq, tk, tv, tdq, tdk, tdv, tdw, tzw = (
        torch.tensor(v, device="cuda")
        for v in (3.0, -5.0, 1.0, 0.021, 0.017, 0.025, 1.0 / 255.0, 0.0))

    def chain():
        w = int8_code_einsum("nic,njc->nij", Q, tq, tdq, K, tk, tdk) * (c ** -0.5)
        W, cw = softmax_int8_codes(w, tdw, tzw, 256)
        return int8_code_einsum("nij,njc->nic", W, cw, tdw, V, tv, tdv)
    return cuda_ms(chain, reps=5)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def main(parent=None, json_path=None, device=None) -> dict:
    if resolve_device(device).type != "cuda":
        raise RuntimeError("attention_phases times kernels: it needs a CUDA card")
    sources = {"this": _build.CSRC}
    if parent:
        sources["parent"] = Path(parent) / "eda_dm_tpu_torch" / "csrc"
    builds = {(tag, stop): (csrc, [] if stop is None else [f"-DK4_STOP_AFTER={stop}"])
              for tag, csrc in sources.items() for stop in STOPS}
    builds.update({("this", tag): (_build.CSRC, ["-DK4_STOP_AFTER=1", f"-DK4_DIAG={d}"])
                   for tag, d in DIAGNOSTICS.items()})
    libs = build(builds)
    result = {"card": card(), "phases": {}, "logits_without": {}, "tiles": {}, "turns": {},
              "bitwise": {}}
    print(f"card: {result['card']}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for n, s, c in TIMED:
        Q, K, V, sc = inputs(g, n, s, c)
        out = torch.empty((n, s, c), dtype=torch.float32, device="cuda")
        shape = f"({n}, {s}, {c})"
        for tag, lib in libs.items():
            t = [cuda_ms(lambda: launcher(lib[stop], Q, K, V, sc, out))
                 for stop in (0, 1, 2, None)]
            ph = {"launch": t[0], "logits": t[1] - t[0], "codes": t[2] - t[1],
                  "wv": t[3] - t[2], "whole": t[3]}
            result["phases"][f"{tag} {shape}"] = ph
            print(f"K4 {tag} {shape}: " + ", ".join(f"{k} {v:.4f}" for k, v in ph.items())
                  + " ms", flush=True)
        for tag in DIAGNOSTICS:
            ms = cuda_ms(lambda: launcher(libs["this"][tag], Q, K, V, sc, out))
            result["logits_without"][f"{tag} {shape}"] = ms
            print(f"K4 this {shape}, launch and logits, {tag}: {ms:.4f} ms", flush=True)
        whole = libs["this"][None]
        ref = run(whole, Q, K, V, sc)
        p = attention_plan(s, c)
        for tiles in dict.fromkeys(((p["tj"], p["tv"]),) + TILES):
            if k4_smem_bytes(s, c, *tiles) is None:
                continue
            same = all(torch.equal(x, y) for x, y in zip(run(whole, Q, K, V, sc, tiles), ref))
            ms = cuda_ms(lambda: launcher(whole, Q, K, V, sc, out, tiles=tiles))
            result["tiles"][f"{shape} tj {tiles[0]} tv {tiles[1]}"] = dict(ms=ms, bitwise=same)
            print(f"K4 this {shape} tiles {tiles}: {ms:.4f} ms, bit for bit with the "
                  f"plan's: {same}", flush=True)
            if not same:
                raise RuntimeError(f"K4 at {shape}: tiles {tiles} change the result")
        del ref
        if parent:
            order = ("parent", "this", "this", "parent")
            turns = [cuda_ms(lambda: launcher(libs[tag][None], Q, K, V, sc, out))
                     for tag in order]
            result["turns"][shape] = list(zip(order, turns))
            print(f"K4 {shape} parent, this, this, parent: "
                  + " / ".join(f"{x:.4f}" for x in turns) + " ms", flush=True)
        if (n, s, c) == TIMED[0]:
            result["chain_ms"] = chain_ms(Q, K, V)
            print(f"K2 -> K3 -> K2 {shape}: {result['chain_ms']:.4f} ms", flush=True)
        del Q, K, V, out
    if parent:
        g = torch.Generator(device="cuda").manual_seed(0)
        for n, s, c in SHAPES:
            Q, K, V, sc = inputs(g, n, s, c)
            (op, cp), (ot, ct) = (run(libs[tag][None], Q, K, V, sc)
                                  for tag in ("parent", "this"))
            rows = (cp != ct).any(-1)
            same = ~rows
            out_equal = bool(torch.equal(op[same], ot[same]))
            rec = {"rows": n * s, "rows_codes_differ": int(rows.sum()),
                   "codes_equal": bool(torch.equal(cp, ct)), "outputs_equal_where_codes_agree":
                   out_equal, "outputs_equal": bool(torch.equal(op, ot))}
            result["bitwise"][f"({n}, {s}, {c})"] = rec
            print(f"K4 parent vs this ({n}, {s}, {c}): {rec}", flush=True)
            if not out_equal:
                raise RuntimeError(f"K4 outputs differ at ({n}, {s}, {c}) on rows whose "
                                   "codes agree")
            del Q, K, V, op, cp, ot, ct
    if json_path:
        Path(json_path).parent.mkdir(parents=True, exist_ok=True)
        Path(json_path).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit whose K4 to compare")
    ap.add_argument("--json", help="write the numbers here")
    a = ap.parse_args()
    main(a.parent, a.json)
