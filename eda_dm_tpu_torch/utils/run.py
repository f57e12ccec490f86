"""Run management: seeding, timestamped run directories, config dumps,
phase timing and profiling (port of ``eda_dm_tpu/utils/run.py``).

``seed_everything`` seeds Python, numpy and PyTorch and returns a
``torch.Generator``; ``profile_trace`` traces with ``torch.profiler``;
``hard_sync`` waits for the card (``torch.cuda.synchronize``).  The JAX
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


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str] = None, label: str = "phase"):
    """A ``torch.profiler`` trace of the block (CPU and, where present, CUDA
    activity; a Chrome trace written to ``trace_dir``) and its wall time,
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
    """Wall seconds accumulated per phase."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        yield
        self.times[name] = self.times.get(name, 0.0) + time.time() - t0

    def summary(self) -> Dict[str, float]:
        return dict(self.times)
