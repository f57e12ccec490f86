"""What the program's spans (``utils/run.py::span``) and its launch record
(``ops/_build.py``) cost a UNet forward, on the card.

* Sites a forward: the ``edm.*`` spans one forward opens and the K1
  launches that ask ``recording()``, counted in one traced forward of SD v1.4's UNet
  at 4 prompts under guidance (8 rows of 64×64 latents, the stand-in text
  context) and of the CIFAR DDPM at batch 500, both the int8 export of
  their seeded weights (random weights: the launches do not depend on the
  values).
* Off (no profiler session): the µs of one ``span`` (the check, the
  shared null context's enter and exit) and of one ``recording()`` check,
  each over a million calls, loop included, and their cost a forward.
* On: the host ms of an SD forward (call to return, the card idle at the
  call) under a profiler session (CPU and CUDA activity) in three
  variants: as the program is; with the spans' range
  (``utils/run.py::_RANGE``) replaced by a null context for the probe, so
  the session records no span; and with no span and K1's ``recording``
  answering False, so the record stays empty.  ``--turns`` sessions, each
  of two untimed forwards and then ``--rounds`` rounds of one forward a
  variant, in turn order, so neighbouring forwards are compared: each
  variant's median and quartiles, and the median and quartiles of the
  per-round ratios (as is over no spans: the spans' cost; no spans over
  neither: the record's).

    python -m eda_dm_tpu_torch.probes.span_cost [--turns N] [--rounds N] [--json PATH]

It prints the card's name and power limit, one line a number, and writes
them all to ``--json``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import statistics
import time

import torch

from ..device import resolve_device
from ..ops import _build
from ..utils import run
from .attention_phases import card

CALLS = 1_000_000


def sd_forward(device):
    """A forward of SD v1.4's int8 UNet export at 4 prompts under guidance."""
    from ..pipelines.latent import LDMPipeline, task_config
    pipe = LDMPipeline(task_config("coco"), device=device)
    unet, mode = pipe.serving_variables(serve="int8")
    pipe.ld.unet = unet
    ct = next(unet.parameters()).dtype
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(8, 64, 64, 4, generator=g, device=device).to(ct)
    ctx = torch.cat([pipe.ld.get_learned_conditioning([""] * 4),
                     pipe.ld.get_learned_conditioning(["a red bus on a street"] * 4)]).to(ct)
    t = torch.full((8,), 501.0, device=device)
    return lambda: unet(x, t, context=ctx, mode=mode)


def cifar_forward(device):
    """A forward of the CIFAR DDPM's int8 export at batch 500."""
    from ..pipelines.cifar import CifarConfig, CifarPipeline
    pipe = CifarPipeline(CifarConfig(), device=device)
    model, mode = pipe.serving_variables(pipe.init_variables(), "int8")
    ct = next(model.parameters()).dtype
    x = torch.randn(500, 32, 32, 3, device=device).to(ct)
    t = torch.full((500,), 501.0, device=device)
    return lambda: model(x, t, mode)


def _session():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def sites(forward) -> dict:
    """Spans and record checks of one traced forward."""
    with _session() as prof:
        forward()
        torch.cuda.synchronize()
    names = collections.Counter(e.name for e in prof.events() if e.name.startswith("edm.")
                                and str(e.device_type).endswith("CPU"))     # not the card's copy
    return {"spans": sum(names.values()), "record_checks": len(_build.launch_record),
            "by_span": dict(names.most_common(6))}


def off_us() -> dict:
    t0 = time.perf_counter()
    for _ in range(CALLS):
        with run.span("edm.op.int8_conv"):
            pass
    t1 = time.perf_counter()
    for _ in range(CALLS):
        _build.recording()
    t2 = time.perf_counter()
    return {"span_us": (t1 - t0) / CALLS * 1e6, "recording_us": (t2 - t1) / CALLS * 1e6}


VARIANTS = ("as is", "no spans", "no spans, no record")


@contextlib.contextmanager
def _variant(name):
    """The program as it is, or with the probe's replacements."""
    from ..ops import int8_conv
    saved = [(run, "_RANGE", run._RANGE)]
    if name != "as is":
        run._RANGE = lambda *a, **k: contextlib.nullcontext()
    if name == "no spans, no record":
        saved.append((int8_conv, "recording", int8_conv.recording))
        int8_conv.recording = lambda: False
    try:
        yield
    finally:
        for obj, attr, val in saved:
            setattr(obj, attr, val)


def _spread(x) -> dict:
    q1, q2, q3 = statistics.quantiles(x, n=4)
    return {"median": statistics.median(x), "q1": q1, "q3": q3}


def on_ms(forward, turns: int, rounds: int) -> dict:
    ms = {v: [] for v in VARIANTS}
    for _ in range(turns):
        with _session():
            for _ in range(2):                  # the session's first forwards
                forward()
            torch.cuda.synchronize()
            for i in range(rounds):
                for v in VARIANTS if i % 2 == 0 else VARIANTS[::-1]:
                    with _variant(v):
                        t0 = time.perf_counter()
                        forward()
                        ms[v].append((time.perf_counter() - t0) * 1e3)
                        torch.cuda.synchronize()
    out = {v: dict(_spread(x), all=x) for v, x in ms.items()}
    a, s, n = (ms[v] for v in VARIANTS)
    out["spans / no spans"] = _spread([x / y for x, y in zip(a, s)])
    out["record / neither"] = _spread([x / y for x, y in zip(s, n)])
    return out


def main(turns: int = 3, rounds: int = 12, json_path=None, device=None) -> dict:
    if resolve_device(device).type != "cuda":
        raise RuntimeError("span_cost times the card's host path: it needs a CUDA card")
    result = {"card": card()}
    print(f"card: {result['card']}", flush=True)
    result["off"] = off_us()
    print(f"off: span {result['off']['span_us']:.4f} us, recording() "
          f"{result['off']['recording_us']:.4f} us a call", flush=True)
    with torch.no_grad():
        for name, make in (("sd p4", sd_forward), ("cifar b500", cifar_forward)):
            forward = make("cuda")
            for _ in range(3):
                forward()
            torch.cuda.synchronize()
            s = result[name] = sites(forward)
            s["off_ms"] = (s["spans"] * result["off"]["span_us"]
                           + s["record_checks"] * result["off"]["recording_us"]) * 1e-3
            print(f"{name}: {s['spans']} spans and {s['record_checks']} record checks a forward "
                  f"({s['by_span']}); off {s['off_ms']:.4f} ms a forward", flush=True)
            if name == "sd p4":
                s["on"] = on_ms(forward, turns, rounds)
                for v, m in s["on"].items():
                    print(f"{name} traced host a forward, {v}: median {m['median']:.4f} "
                          f"(quartiles {m['q1']:.4f}, {m['q3']:.4f})"
                          + (" ms" if "all" in m else " (ratio)"), flush=True)
            del forward
            torch.cuda.empty_cache()
    if json_path:
        with open(json_path, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--turns", type=int, default=3)
    p.add_argument("--rounds", type=int, default=12)
    p.add_argument("--json")
    a = p.parse_args()
    main(a.turns, a.rounds, a.json)
