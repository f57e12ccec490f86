"""The traced stretch: ``torch.profiler`` (CPU and CUDA activity) over a
few whole denoise steps inside the window, its Chrome trace reduced to the
device's kernels, its busy time (the union of every kernel, copy and set
interval), the stretch's length on the device clock, and the idle gaps,
each named by the innermost host operation running when it began."""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def start():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def stop(prof) -> dict:
    torch.cuda.synchronize()
    prof.stop()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce(events)


def _intervals(events, cat):
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                 if e.get("cat") == cat and e.get("ph") == "X")
    return [o[0] for o in ops], ops


def _covering(intervals, t):
    """The name of the latest-starting interval that covers ``t`` (the
    innermost of nested host operations), or None."""
    starts, ops = intervals
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 400, -1), -1):
        if ops[j][1] >= t:
            return ops[j][2]
    return None


def reduce(events) -> dict:
    """Kernels launched inside the stretch (a kernel whose launch the trace
    holds), busy seconds, window seconds, the ten device operations with the
    most time and the ten host operations under which the device idled
    longest (summed; a gap outside every torch operation is named by the
    CUDA runtime call under way, such as a launch of the port's own
    kernels through ``ctypes``)."""
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
           and (not launched or e.get("args", {}).get("correlation") in launched)]
    if not dev:
        return {"kernels": [], "busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": []}
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    busy, gaps, cur_s, cur_e = 0.0, [], iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = iv[-1][1] - iv[0][0]
    idle = collections.Counter()
    host = [_intervals(events, "cpu_op"), _intervals(events, "cuda_runtime")]
    for g0, g1 in gaps:
        name = next((n for h in host if (n := _covering(h, g0))), "python, no torch op")
        idle[name] += (g1 - g0) * 1e-6
    per_op = collections.Counter()
    for e in dev:
        if e["cat"] == "kernel":
            per_op[e["name"]] += float(e["dur"]) * 1e-6
    kernels = [(e["name"], float(e["dur"]) * 1e-6) for e in dev if e["cat"] == "kernel"]
    return {"kernels": kernels, "busy_s": busy * 1e-6, "window_s": window * 1e-6,
            "device_ops": [[n, s] for n, s in per_op.most_common(10)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(10)]}
