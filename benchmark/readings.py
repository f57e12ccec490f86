#!/usr/bin/env python3
"""The readings that the correctness limits are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 --control-seeds 1,2,3

For each seed, in one process: the cell's set-up at its own size, one
batch through the program's timed entry point at the cell's load (as a
run's window drives it, recorded as a run records it), then the check's
numbers against the reference; for a control seed also the control's
numbers (the reference in the program's place one precision below the
configuration's: an fp8 carrier, a bfloat16 sampler, a TF32 decode), on
the same recorded inputs.  One JSON line a seed; ``--out`` appends them to
a file too."""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def open_cell(workload, device=None, root=ROOT, bench_dir=None):
    """The manifest and the cell's (configuration, traffic mix, device)."""
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import torch
    from benchmark.lib.manifest import BENCH_DIR, Manifest
    from benchmark.run import environment
    environment(root)
    man = Manifest(root, bench_dir or BENCH_DIR)
    cell = man.cell(workload)
    return man, man.config(cell["config"]), man.traffic(cell["traffic"]), \
        torch.device(device or "cuda")


def set_up(man, config, traffic, seed, device):
    """The cell's system, set up and warmed up at its own size."""
    import torch
    system = man.system(config["system"])(config, traffic, seed, device, man)
    with torch.no_grad():
        system.setup()
        system.warm_up()
    return system


def one_batch(system):
    """One batch through the timed entry at the cell's load, recorded as a
    run's window records it (a window that closes at once)."""
    import torch
    from benchmark.lib.window import Window
    with torch.no_grad():
        window = Window(system, 0.0).run()
    return window.checked_batches()


def free(device):
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def readings(workload, seeds, control_seeds, device=None, root=ROOT, bench_dir=None, out=None):
    man, config, traffic, device = open_cell(workload, device, root, bench_dir)
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        system = set_up(man, config, traffic, seed, device)
        t1 = time.perf_counter()
        batches = one_batch(system)
        t2 = time.perf_counter()
        system.release()
        free(device)
        row = {"workload": workload, "seed": seed, "program": system.check(batches),
               "setup_s": t1 - t0, "batch_s": t2 - t1, "detail": system.detail}
        if seed in control_seeds:
            row["control"] = system.check(batches, control=True)
            row["control_detail"] = system.detail
        row["check_s"] = time.perf_counter() - t2
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
        rows.append(row)
        del system, batches
        free(device)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    ints = lambda s: [int(v) for v in s.split(",") if v]
    readings(a.workload, ints(a.seeds), set(ints(a.control_seeds)), out=a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
