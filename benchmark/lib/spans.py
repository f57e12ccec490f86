"""The program's own spans in the traced stretch: the ``edm.*`` host
ranges that ``eda_dm_tpu_torch`` opens with ``utils/run.py::span`` while a
profiler session records (torch's C++ range: ``cpu_op`` events), read
from the profiler object the window keeps (``r.window.prof``; its Chrome trace is already written, its
Kineto events stay).  The spans are on the host clock, which is the device trace's clock,
so each device kernel links to the runtime call that launched it (by
correlation id) and so to the innermost span open at that launch, and each
idle gap to the innermost span open on the host when it began.

A span counts as whole if it ended before the session stopped: the stretch
starts and stops inside a forward's pre-hook, so the sampler step and the
batch under way at either end are open (PLMS p4: 2 whole steps, 3 whole
forwards).  Per-forward and per-step figures count whole spans only.
Without the program's spans (a program that opens none) every figure is
None and nothing is printed."""

from __future__ import annotations

import bisect
import collections
import dataclasses
import statistics
import sys
from typing import Dict, List, Optional, Tuple

from .trace import DEVICE_CATS

FORWARD, STEP, OP = "edm.unet.forward", "edm.sampler.step", "edm.op."
NO_SPAN = "(no span)"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_SPAN_CATS = ("cpu_op",)                        # torch's C++ range


@dataclasses.dataclass
class Ev:
    cat: str
    name: str
    start: int                 # ns, the session's clock
    end: int
    corr: int = 0              # a runtime call's and its device activity's


def _call(e, name, default=None):
    f = getattr(e, name, None)
    try:
        v = f() if callable(f) else f
    except (RuntimeError, TypeError, ValueError):
        return default
    return default if v is None else v


def _category(e) -> str:
    """The event's Chrome-trace category: Kineto's own where this torch
    gives it, else from the device and the name (a runtime call is
    ``cuda*``, a driver call ``cu*``).  A ``record_function`` range (the
    caller's, not the program's) is neither a span nor device activity,
    though the card's copy of it carries a correlation id."""
    cat = _call(e, "activity_type", "")
    if cat:
        return str(cat)
    name, device = _call(e, "name", ""), str(_call(e, "device_type", ""))
    on_card = not device.endswith("CPU")
    if _call(e, "is_user_annotation", False):
        return "user_annotation"
    if on_card:
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    if name.startswith("cuda"):
        return "cuda_runtime"
    if name.startswith("cu") and name[2:3].isupper():
        return "cuda_driver"
    return "cpu_op"


def events(prof) -> List[Ev]:
    """The session's Kineto events: host operations, runtime calls, user
    annotations and device activity, with their times and correlation ids."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = int(_call(e, "start_ns", 0))
        out.append(Ev(_category(e), _call(e, "name", ""), start,
                      start + int(_call(e, "duration_ns", 0)),
                      int(_call(e, "correlation_id", 0))))
    return out


@dataclasses.dataclass
class Spans:
    spans: List[Ev]            # every edm.* span, by start
    whole: List[Ev]            # those that ended before the session stopped
    device: List[Ev]           # device activity launched in the stretch
    launch: Dict[int, Ev]      # correlation id -> the runtime call
    gaps: List[Tuple[int, int]]  # device idle intervals, ns

    def named(self, name: str) -> List[Ev]:
        return [s for s in self.whole if s.name == name]

    def inside(self, outer: Ev, prefix: str) -> List[Ev]:
        """Outermost spans named ``prefix``… inside ``outer``."""
        found, last_end = [], -1
        for s in self.spans:
            if s.start < outer.start or s.end > outer.end or s is outer:
                continue
            if s.name.startswith(prefix) and s.start >= last_end:
                found.append(s)
                last_end = s.end
        return found

    def launcher(self, d: Ev) -> Optional[Ev]:
        return self.launch.get(d.corr)

    def innermost(self, times: List[int]) -> List[str]:
        """The innermost span open at each of the sorted ``times``."""
        bounds = sorted([(s.start, 1, i) for i, s in enumerate(self.spans)]
                        + [(s.end, 0, i) for i, s in enumerate(self.spans)])
        out, stack, j = [], [], 0
        for t in times:
            while j < len(bounds) and bounds[j][0] <= t:
                _, opens, i = bounds[j]
                if opens:
                    stack.append(i)
                elif i in stack:
                    stack.remove(i)
                j += 1
            out.append(self.spans[stack[-1]].name if stack else NO_SPAN)
        return out

    def idle_by_span(self) -> collections.Counter:
        names = self.innermost([g0 for g0, _ in self.gaps])
        idle = collections.Counter()
        for (g0, g1), name in zip(self.gaps, names):
            idle[name] += (g1 - g0) * 1e-9
        return idle

    def idle_in(self, spans: List[Ev]) -> float:
        """Seconds of the gaps that began inside one of ``spans``."""
        starts = [s.start for s in spans]
        total = 0.0
        for g0, g1 in self.gaps:
            i = bisect.bisect_right(starts, g0) - 1
            if i >= 0 and spans[i].end >= g0:
                total += (g1 - g0) * 1e-9
        return total

    def device_busy_ms(self, outer: Ev) -> Optional[float]:
        """Busy device time (the union of the intervals) of the activity
        launched inside ``outer``, in ms: the idle gaps between them, which
        the traced host lengthens, are left out."""
        ds = [d for d in self.device
              if (c := self.launcher(d)) is not None and outer.start <= c.start <= outer.end]
        if not ds:
            return None
        busy, cur_s, cur_e = 0, ds[0].start, ds[0].end
        for d in ds[1:]:
            if d.start > cur_e:
                busy += cur_e - cur_s
                cur_s = d.start
            cur_e = max(cur_e, d.end)
        return (busy + cur_e - cur_s) * 1e-6


def build(evs: List[Ev]) -> Optional[Spans]:
    spans = sorted((e for e in evs if e.cat in HOST_SPAN_CATS and e.name.startswith("edm.")),
                   key=lambda e: (e.start, -e.end))
    if not spans:
        return None
    stop = max(e.end for e in evs if e.cat not in DEVICE_CATS)
    launch = {e.corr: e for e in evs if e.cat in LAUNCH_CATS and e.corr}
    device = sorted((e for e in evs if e.cat in DEVICE_CATS and e.corr in launch),
                    key=lambda e: e.start)
    gaps = []
    if device:
        cur_e = device[0].end
        for d in device[1:]:
            if d.start > cur_e:
                gaps.append((cur_e, d.start))
            cur_e = max(cur_e, d.end)
    return Spans(spans, [s for s in spans if s.end < stop], device, launch, gaps)


def read(r) -> Optional[Spans]:
    """The stretch's spans, read once a run (None where the run kept no
    profiler, or the program opened no span); the first read prints the
    idle table to standard error."""
    if "spans" not in r.__dict__:
        prof = getattr(getattr(r, "window", None), "prof", None)
        r.spans = build(events(prof)) if prof is not None else None
        if r.spans is not None:
            report(r.spans, r.trace, sys.stderr)
    return r.spans


def ms_per(total_s: float, n: int) -> Optional[float]:
    return total_s * 1e3 / n if n else None


def mean_ms(values) -> Optional[float]:
    values = [v for v in values if v is not None]
    return statistics.fmean(values) * 1e-6 if values else None


def level(name: str) -> str:
    """A span's level: an op wrapper, a block group, the forward itself, the
    sampler step, the pipeline, or no span."""
    if name.startswith(OP):
        return "edm.op.*"
    if name.startswith("edm.unet.") and name != FORWARD:
        return "edm.unet.<group>"
    if name.startswith("edm.pipeline."):
        return "edm.pipeline.*"
    return name


def report(s: Spans, trace: Optional[dict], out) -> None:
    """The stretch's device idle time by the innermost program span open
    when each gap began (top 10, then the share under no span; then by
    :func:`level`), the whole spans counted, and the idle time inside and outside forwards against
    the harness's reading (1 − busy / window, times the window)."""
    fwd, steps = s.named(FORWARD), s.named(STEP)
    idle = s.idle_by_span()
    total = sum(idle.values())
    print(f"program spans: {len(s.spans)} in the stretch; whole: {len(steps)} sampler steps, "
          f"{len(fwd)} forwards, {sum(1 for x in s.whole if x.name.startswith(OP))} op spans; "
          f"{len(s.device)} device activities, "
          f"{sum(1 for d in s.device if s.launcher(d) is not None)} linked to a launch",
          file=out)
    print(f"idle by program span: {total * 1e3:.3f} ms in all", file=out)
    for name, sec in idle.most_common(10):
        print(f"  {name:<36} {sec * 1e3:10.3f} ms {100 * sec / total if total else 0:6.2f} %",
              file=out)
    if NO_SPAN not in dict(idle.most_common(10)):
        sec = idle.get(NO_SPAN, 0.0)
        print(f"  {NO_SPAN:<36} {sec * 1e3:10.3f} ms {100 * sec / total if total else 0:6.2f} %",
              file=out)
    levels = collections.Counter()
    for name, sec in idle.items():
        levels[level(name)] += sec
    print("idle by level: " + ", ".join(
        f"{k} {v * 1e3:.3f} ms ({100 * v / total if total else 0:.2f} %)"
        for k, v in levels.most_common()), file=out)
    inside = s.idle_in(fwd)
    line = (f"idle in whole forwards {inside * 1e3:.3f} ms, outside {(total - inside) * 1e3:.3f} ms, "
            f"sum {total * 1e3:.3f} ms")
    if trace and trace.get("window_s"):
        ref = trace["window_s"] - trace["busy_s"]
        line += (f"; the harness's (1 - busy/window) x window {ref * 1e3:.3f} ms "
                 f"({100 * (total - ref) / ref if ref else 0:+.3f} %)")
    print(line, file=out)
