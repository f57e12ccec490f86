"""Fixtures of the benchmark's CPU tests: a tiny checkout (``tiny.py``)."""

import pytest
import torch

from . import tiny


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_root(tmp_path):
    return tiny.make_root(tmp_path, tiny.LIMITS)


def run_cell(root, cell, seed=2147483659, seconds=2.0, trace=0):
    """A run of ``cell`` in ``root`` on the CPU; returns (exit code, the
    result line as a dict or None)."""
    import io
    import json
    from contextlib import redirect_stdout

    from benchmark import run
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu", root=root,
                      bench_dir=root / "benchmark")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
