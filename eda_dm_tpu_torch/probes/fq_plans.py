"""K7's column tiles timed, and an earlier K7 in turns with this one
(``csrc/fakequant_matmul.cu``).

K7's tensor-core route takes 64 rows and ``bn`` columns a block
(:func:`~eda_dm_tpu_torch.ops.quant_matmul.fq_plan`).  At
``chip_smoke.py``'s three DEPLOY_FUSED CIFAR shapes (bf16, the serving
carrier), with the port's [out, in] weights and with a contiguous (K, N),
this probe times this tree's K7 under each column tile by the profiler's
device time, each held to ``chip_smoke.py``'s gate (within
1e-5·(|xq|·|w| + |bias|) of the float64 product, plus one bf16 step), and
the DEPLOY chain fake_quant → cuBLAS → bias beside it.  With ``--parent
DIR`` (a checkout of an earlier commit, e.g. unpacked from ``git
archive``), that checkout's ``fakequant_matmul.cu`` (built from its own
source, with its C interface) runs in turns with this one (parent, this,
this, parent; by CUDA events and by the profiler).

    python -m eda_dm_tpu_torch.probes.fq_plans [--parent DIR] [--json PATH]

It prints the card's name and power limit, one line a number, and writes
them all to ``--json``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..device import resolve_device
from ..ops import _build
from ..ops.quant_matmul import _FQ_SIG, FQ_BNS, fq_error, fq_plan
from .attention_phases import card
from .flash_plans import build
from .gn_plans import registers
from .mma_int8 import cuda_ms, device_ms

# chip_smoke.py's K7 shapes: (name, M, K, N, the split of K's two quantizers)
SHAPES = (("attention 1x1", 500 * 256, 256, 256, 0),
          ("split nin_shortcut", 500 * 256, 512, 256, 256),
          ("temb_proj dense", 500, 512, 256, 0))
# the parent's C interface (no column tile)
_PARENT_SIG = {"edm_fakequant_matmul": _FQ_SIG["edm_fakequant_matmul"][:14]
               + _FQ_SIG["edm_fakequant_matmul"][-1:]}


def launcher(lib, x, w, dk, zk, bias, out, bn=None):
    """One launch through a built K7 library: this tree's with ``bn``
    columns a block, or (``bn`` None) the parent's interface."""
    m, k = x.shape
    args = [_build.ptr(t) for t in (x, w, dk, zk, bias, out)]
    args += [1, 1, m, w.shape[1], k, w.stride(0), w.stride(1), 256]
    if bn is not None:
        args.append(bn)
    _build.check_launch(lib, lib.edm_fakequant_matmul(*args, _build.stream_ptr(x.device)),
                        "K7")


def main(parent=None, json_path=None, device=None) -> dict:
    if resolve_device(device).type != "cuda":
        raise RuntimeError("fq_plans times kernels: it needs a CUDA card")
    csrc = _build.CSRC
    builds = {"k7-this": (csrc / "fakequant_matmul.cu", csrc, [], _FQ_SIG)}
    if parent:
        pcsrc = Path(parent) / "eda_dm_tpu_torch" / "csrc"
        builds["k7-parent"] = (pcsrc / "fakequant_matmul.cu", pcsrc, [], _PARENT_SIG)
    libs = {tag[3:]: lib for tag, lib in build(builds).items()}
    result = {"card": card(), "registers": {tag: registers(f"k7-{tag}") for tag in libs},
              "tiles": {}, "turns": {}, "chain": {}}
    print(f"card: {result['card']}", flush=True)
    for tag, regs in result["registers"].items():
        print(f"K7 build {tag}: registers by instance {regs}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, m, k, n, split in SHAPES:
        x = (1.7 * torch.randn(m, k, generator=g, device="cuda") + 0.2).to(torch.bfloat16)
        w_oi = (0.05 * torch.randn(n, k, generator=g, device="cuda")).to(torch.bfloat16)
        first = torch.arange(k, device="cuda") < (split or k)
        dk, zk = torch.where(first, 0.031, 0.017), torch.where(first, 121.0, 64.0)
        bias = 0.3 * torch.randn(n, generator=g, device="cuda")
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        shape = f"{name} ({m}, {k})x({k}, {n})"
        for layout, w in (("[out, in]", w_oi.t()), ("(K, N)", w_oi.t().contiguous())):
            for bn in FQ_BNS:
                launcher(libs["this"], x, w, dk, zk, bias, out, bn)
                ok, e = fq_error(out, x, w, dk, zk, 256, bias)
                ms = device_ms(lambda: launcher(libs["this"], x, w, dk, zk, bias, out, bn),
                               "fakequant_matmul")
                key = f"{shape} {layout} bn {bn}"
                result["tiles"][key] = dict(ms=ms, within_gate=ok, max_abs=e,
                                            planned=bn == fq_plan(m, n))
                print(f"K7 {key}{' (the plan)' if bn == fq_plan(m, n) else ''}: {ms:.4f} ms "
                      f"device time, within the gate {ok} (max |d| {e:.3g})", flush=True)
        w = w_oi.t()
        xs = [x[:, :split], x[:, split:]] if split else [x]
        rows = [(0.031, 121.0), (0.017, 64.0)]

        def chain():
            from ..quant.affine import fake_quant
            parts = [fake_quant(p, torch.tensor(d, device="cuda"), torch.tensor(z, device="cuda"),
                                256) for p, (d, z) in zip(xs, rows)]
            return (torch.cat(parts, -1) if split else parts[0]) @ w + bias
        result["chain"][shape] = cuda_ms(chain, reps=5)
        print(f"K7 {shape} DEPLOY chain fake_quant -> cuBLAS -> bias: "
              f"{result['chain'][shape]:.4f} ms", flush=True)
        if parent:
            order = ("parent", "this", "this", "parent")
            fns = {"parent": lambda: launcher(libs["parent"], x, w, dk, zk, bias, out),
                   "this": lambda: launcher(libs["this"], x, w, dk, zk, bias, out,
                                            fq_plan(m, n))}
            turns = [cuda_ms(fns[tag]) for tag in order]
            dev = [device_ms(fns[tag], "fakequant_matmul") for tag in order]
            result["turns"][shape] = list(zip(order, turns))
            result["turns"][shape + " (profiler)"] = list(zip(order, dev))
            print(f"K7 {shape} [out, in] parent, this, this, parent: "
                  + " / ".join(f"{v:.4f}" for v in turns) + " ms; device time "
                  + " / ".join(f"{v:.4f}" for v in dev) + " ms", flush=True)
        del x, out
    if json_path:
        Path(json_path).parent.mkdir(parents=True, exist_ok=True)
        Path(json_path).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier commit whose K7 to compare")
    ap.add_argument("--json", help="write the numbers here")
    a = ap.parse_args()
    main(a.parent, a.json)
