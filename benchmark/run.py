#!/usr/bin/env python3
"""The benchmark of ``eda_dm_tpu_torch`` on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration and a traffic mix; the run sets the system up (weights from
the seed, the stand-in quant state, the serving export, a warm-up of the
cell's shapes), measures ``--seconds`` of back-to-back batches, then
checks what the program produced against the plain reference
(``benchmark/reference``) and prints one JSON line: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones (a
profiled stretch of whole steps inside the window).  Each compared number
and its limit end standard error and the result line (``checks``).

Exits 2 with no result when there is no CUDA card or fewer than the cell
asks for, and 3 when a JAX module is loaded once the window has closed."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "eda_dm_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def environment(root: Path):
    """Caches inside the checkout at fixed paths, the program's default
    serving branches, and no JAX pulled in by a library."""
    cache = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for k in [k for k in os.environ if k.startswith("EDM_")]:
        del os.environ[k]


def loaded_forbidden():
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def card(torch, chips):
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=30).stdout.split("\n")[0]
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return {"platform": "gpu", "kind": name, "count": chips}, limit.strip()


def main(argv=None, device=None, root: Path = ROOT, bench_dir: Path = None):
    args = parse(argv)
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    environment(root)
    from benchmark.lib.manifest import BENCH_DIR, Manifest
    man = Manifest(root, bench_dir or BENCH_DIR)
    cell = man.cell(args.workload)
    config, traffic = man.config(cell["config"]), man.traffic(cell["traffic"])
    import torch
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"needs {cell['chips']} CUDA card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
        device = torch.device("cuda")
        dev_info, power = card(torch, cell["chips"])
        print(f"card: {dev_info['kind']}, power limit {power}", file=sys.stderr)
    else:
        device, dev_info = torch.device(device), {"platform": "cpu", "kind": "cpu", "count": 1}
    cuda = device.type == "cuda"
    try:
        system = man.system(config["system"])(config, traffic, args.seed, device, man)
        system.setup()
    except ImportError as e:
        print(f"the program is not importable: {e}", file=sys.stderr)
        return 1
    from benchmark.lib import trace as tracing
    from benchmark.lib.window import Window
    with torch.no_grad():
        system.warm_up()
        if cuda and args.trace:                 # the profiler's own start-up, out of the window
            tracing.stop(tracing.start())
    system.mark("warm_up")
    window = Window(system, args.seconds, traffic["trace"] if args.trace else None,
                    config["count"])
    setup_s = time.perf_counter() - T0
    print("set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in system.phase_s.items())
          + f"; in all {setup_s:.3f} s", file=sys.stderr)
    with torch.no_grad():
        window.run()
    print(f"window {window.t_end - window.t0:.3f} s: {window.finished} batches and "
          f"{window.partial} of {system.forwards_per_batch} forwards; the main thread "
          f"ran {window.host[0]:.3f} s and waited {window.host[1]:.3f} s for a core; "
          f"load {os.getloadavg()[0]:.2f}", file=sys.stderr)
    rec = types.SimpleNamespace(window=window, system=system, setup_s=setup_s,
                                trace=window.trace, traced_steps=window.traced_steps,
                                shapes=window.shapes.calls if window.shapes else [],
                                launches=window.launches)
    metrics = {}
    for m in man.metrics(args.workload, bool(args.trace)):
        v = man.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info["memory_peak_bytes"] = window.peak
    if args.trace and window.trace:
        dev_info["busy_s"] = window.trace["busy_s"]
        dev_info["window_s"] = window.trace["window_s"]
    batches = window.checked_batches()
    failed = sum(not bool(torch.isfinite(b.images).all()) for b in batches)
    system.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = system.check(batches)
    limits = man.limits(args.workload) or {}
    checks = {k: {"value": v, "limit": limits.get(k, {}).get("limit")} for k, v in numbers.items()}
    correct = (failed == 0 and bool(checks)
               and all(c["limit"] is not None and math.isfinite(c["value"])
                       and c["value"] <= c["limit"] for c in checks.values()))
    bad = loaded_forbidden()
    if bad:
        print(f"JAX modules are loaded: {bad}", file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": window.attempted, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if args.trace and window.trace:
        result["breakdown"] = {"device_ops": window.trace["device_ops"],
                               "idle_gaps": window.trace["idle_gaps"]}
    result["checks"] = checks
    print(f"checked batches {[b.index for b in batches]}, correct {correct}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
