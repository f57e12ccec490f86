"""Run management: seeding, timestamped run directories, config dumps,
phase timing, profiling and the program's spans (port of
``eda_dm_tpu/utils/run.py``).

``seed_everything`` seeds Python, numpy and PyTorch and returns a
``torch.Generator``; ``profile_trace`` traces with ``torch.profiler``;
``span`` marks a stretch of the program in such a trace; ``hard_sync``
waits for the card (``torch.cuda.synchronize``).  The JAX
package's ``enable_compilation_cache`` (XLA's persistent compile cache)
and ``relay_mode`` (a TPU reached through a relay) have no counterpart
here: the port compiles no XLA programs and reaches its card directly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import logging
import os
import random
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def _no_range(name: str):
    raise RuntimeError(f"span {name!r}: this torch has no torch._C._profiler._RecordFunctionFast")


# a span's range while a session records (a ``cpu_op`` in the trace; see ``span``)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", _no_range)


def seed_everything(seed: int, device=None) -> torch.Generator:
    """Seed Python, numpy and PyTorch; return a ``torch.Generator`` on
    ``device`` (the CPU unless given) seeded with ``seed``."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device or "cpu").manual_seed(seed)


def hard_sync(device=None) -> None:
    """Wait until the card has finished the work queued so far."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


def setup_run_dir(logdir: str, name: str = "samples") -> str:
    """Create logdir/<name>/<timestamp>/ (with ``img/``) and log to its
    run.log and the console."""
    ts = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    run_dir = os.path.join(logdir, name, ts)
    os.makedirs(os.path.join(run_dir, "img"), exist_ok=True)
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s -   %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S", level=logging.INFO,
        handlers=[logging.FileHandler(os.path.join(run_dir, "run.log")),
                  logging.StreamHandler()], force=True)
    return run_dir


def dump_config(cfg: Any, run_dir: str, filename: str = "sampling_config.yaml") -> None:
    """Write the resolved config (a dataclass or a dict) beside the run log:
    YAML where PyYAML is installed, else JSON."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        cfg = dataclasses.asdict(cfg)
    path = os.path.join(run_dir, filename)
    try:
        import yaml
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f, default_flow_style=False)
    except Exception:
        with open(path.replace(".yaml", ".json"), "w") as f:
            json.dump(cfg, f, indent=2, default=str)


def span(name: str):
    """A context that marks its block as ``name`` in a ``torch.profiler``
    trace while a profiler session records: a host range on the clock of
    the card's kernels; else, after one check, a shared null context.
    ``name`` is a fixed string (``edm.<layer>.<what>``), not formatted a
    call.  The range is torch's C++ one (``_RecordFunctionFast``); a torch
    without it raises here.  ``record_function`` is not used: it costs
    about 10 µs a span on the H100's host and, while CUDA activity is
    traced, adds to each operation run inside it, which made the traced
    stretches wait on the host."""
    if _autograd_profiler._is_profiler_enabled:
        return _RANGE(name)
    return _NO_SPAN


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str] = None, label: str = "phase"):
    """A ``torch.profiler`` trace of the block (CPU and, where present, CUDA
    activity; a Chrome trace written to ``trace_dir``, with the program's
    ``edm.*`` spans on the clock of the card's kernels) and its wall time,
    logged."""
    log = logging.getLogger("eda_dm_tpu_torch.profile")
    t0 = time.time()
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        os.makedirs(trace_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield
            hard_sync()
        prof.export_chrome_trace(os.path.join(trace_dir, f"{label}.json"))
    else:
        yield
    log.info("%s took %.2fs", label, time.time() - t0)


class PhaseTimer:
    """Wall seconds accumulated per phase; each phase is also the span
    ``edm.phase.<name>``."""

    def __init__(self):
        self.times: Dict[str, float] = {}
        self._spans: Dict[str, str] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        if name not in self._spans:
            self._spans[name] = "edm.phase." + name
        with span(self._spans[name]):
            yield
        self.times[name] = self.times.get(name, 0.0) + time.time() - t0

    def summary(self) -> Dict[str, float]:
        return dict(self.times)
