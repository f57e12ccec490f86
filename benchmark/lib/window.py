"""The measured window: back-to-back batches from one caller through the
system's entry point for ``--seconds`` seconds, with nothing but hooks
around the program.

A forward pre-hook on the served UNet records a CUDA event at each
forward's start (a forward hook one at its end) and closes the window at
the first forward that begins after the deadline: the card is
synchronised there, the wall time, the peak memory and the forwards done
are read.  If a recorded batch has finished by then, the running batch is
abandoned; otherwise it runs on past the close, unmeasured, so that the
check has an answer.  Recorded batches (the first ``record_batches``) keep
every forward's output (copied to pinned host memory, so the device's
peak does not move), the inputs of the checked forwards, the latents the
decode takes and the images.  With a trace, the profiler and the shape
hooks run over ``trace.steps`` forwards from ``trace.start`` on."""

from __future__ import annotations

import time

import torch

from . import trace as tracing
from .counts import ShapeLog
from .systems import Batch


def host_times():
    """(Seconds this thread has run on a core, seconds it has waited in a
    run queue for one) by the kernel's schedstat; the second is nan where
    there is none."""
    try:
        with open("/proc/thread-self/schedstat") as f:
            on, wait = f.read().split()[:2]
        return int(on) * 1e-9, int(wait) * 1e-9
    except (OSError, ValueError):
        return time.thread_time(), float("nan")


class Closed(Exception):
    """Raised in the UNet's pre-hook to abandon the batch at the close."""


class HostEvent:
    """A host-clock stand-in for ``torch.cuda.Event`` where there is no card
    (the CPU tests)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Window:
    def __init__(self, system, seconds: float, trace: dict = None, count: dict = None):
        self.s, self.seconds = system, seconds
        self.cuda = torch.device(system.device).type == "cuda"
        n = int(system.spec["record_batches"])
        self.records = {b: Batch(b, eps=torch.empty(
            (system.forwards_per_batch, *system.out_shape), dtype=system.carrier,
            pin_memory=self.cuda)) for b in range(n)}
        self.checked = set(system.checked_forwards())
        self.starts, self.ends, self.decodes = [], [], []
        self.measuring = self.tracing = False
        self.batch, self.fidx, self.gidx = None, 0, 0
        self.finished = self.partial = self.traced_steps = 0
        self.trace_spec, self.trace, self.prof = trace, None, None
        self.shapes = ShapeLog(system.unet, count) if trace else None
        self.launches = {}
        self.handles = [
            system.unet.register_forward_pre_hook(self._pre, with_kwargs=True),
            system.unet.register_forward_hook(self._post, with_kwargs=True)]
        if hasattr(system, "wrap_decode"):
            system.wrap_decode(self._decode_start, self._decode_end)

    # ------------------------------------------------------------------
    def _event(self):
        ev = torch.cuda.Event(enable_timing=True) if self.cuda else HostEvent()
        ev.record()
        return ev

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _close(self):
        self._sync()
        self.t_end = time.perf_counter()
        self.host = [b - a for a, b in zip(self.host0, host_times())]
        self.peak = torch.cuda.max_memory_allocated() if self.cuda else 0
        self.partial, self.measuring = self.fidx, False
        if self.tracing:
            self._trace_stop()

    def _trace_start(self):
        from eda_dm_tpu_torch.ops._build import launch_counts
        self.launches = dict(launch_counts)
        self.prof, self.tracing, self.shapes.on = tracing.start(), True, True
        self.trace_from = self.gidx

    def _trace_stop(self):
        from eda_dm_tpu_torch.ops._build import launch_counts
        self.trace = tracing.stop(self.prof)
        self.tracing = self.shapes.on = False
        self.traced_steps = self.gidx - self.trace_from
        self.launches = {k: v - self.launches.get(k, 0) for k, v in launch_counts.items()
                         if v - self.launches.get(k, 0)}

    def _pre(self, mod, args, kwargs):
        if self.measuring and time.perf_counter() >= self.deadline:
            self._close()
            if any(r.finished for r in self.records.values()) or not self.records:
                raise Closed
        if self.measuring and self.trace_spec and self.trace is None:
            first = int(self.trace_spec["start"])
            if self.gidx == first and not self.tracing:
                self._trace_start()
            elif self.gidx == first + int(self.trace_spec["steps"]) and self.tracing:
                self._trace_stop()
        self.starts.append((self.batch, self.fidx, self._event(),
                            self.measuring and not self.tracing))
        rec = self.records.get(self.batch)
        if rec is not None and self.fidx in self.checked:
            rec.inputs[self.fidx] = args[0].detach().clone()

    def _post(self, mod, args, kwargs, out):
        self.ends.append(self._event())
        rec = self.records.get(self.batch)
        if rec is not None:
            rec.eps[self.fidx].copy_(out, non_blocking=True)
        self.fidx += 1
        self.gidx += 1

    def _decode_start(self, z):
        self.decodes.append([self._event(), None, self.measuring])
        rec = self.records.get(self.batch)
        if rec is not None:
            rec.latents = z.detach().clone()

    def _decode_end(self, _images):
        self.decodes[-1][1] = self._event()

    # ------------------------------------------------------------------
    def run(self):
        self._sync()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        self.host0 = host_times()
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + self.seconds
        self.measuring, b = True, 0
        while True:
            self.batch, self.fidx = b, 0
            try:
                out = self.s.run_batch(b)
            except Closed:
                break
            rec = self.records.get(b)
            if rec is not None:
                rec.images, rec.finished = out, True
            if not self.measuring:
                break                      # the batch that ran on past the close
            self.finished += 1
            b += 1
        self.attempted = b + 1
        self._sync()
        for h in self.handles:
            h.remove()
        if self.shapes is not None:
            self.shapes.remove()
        return self

    # ------------------------------------------------------------------
    def step_gaps_ms(self):
        """Times between successive forward starts inside the window."""
        return [e0.elapsed_time(e1) for (_, _, e0, m0), (_, _, e1, m1)
                in zip(self.starts, self.starts[1:]) if m0 and m1]

    def inner_step_ms(self):
        """Gaps between successive forwards of one batch, both measured and
        untraced (a denoise step's time, the batch's set-up and decode not
        in it)."""
        out = []
        for (b0, _, e0, m0), (b1, _, e1, m1) in zip(self.starts, self.starts[1:]):
            if m0 and m1 and b0 == b1:
                out.append(e0.elapsed_time(e1))
        return out

    def unet_ms(self):
        return [s[2].elapsed_time(e) for s, e in zip(self.starts, self.ends) if s[3]]

    def decode_ms(self):
        return [s.elapsed_time(e) for s, e, m in self.decodes if m and e is not None]

    def decode_share(self) -> float:
        """The decode's share of a batch's time on the device: the mean
        decode over the mean time from one batch's first forward to the
        next's, both inside the window (0 without a decode or a second
        batch)."""
        dec = self.decode_ms()
        firsts = [ev for b, f, ev, m in self.starts if f == 0 and m]
        if not dec or len(firsts) < 2:
            return 0.0
        batch = [a.elapsed_time(b) for a, b in zip(firsts, firsts[1:])]
        return (sum(dec) / len(dec)) / (sum(batch) / len(batch))

    def checked_batches(self):
        return [r for r in self.records.values() if r.finished]
