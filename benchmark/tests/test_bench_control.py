"""The control: the reference put in the program's place one precision
below the configuration's (an fp8 carrier for the bf16 one, a bfloat16
sampler, a TF32 decode) has to fail a number that the program passes.

On the CPU, at the tiny size, three seeds: the control's ``eps_err`` and
``sample_err`` fail the tiny limits that the program's readings pass (the
CPU has no TF32, so the decode's control reads the reference there).  On
a card (marker ``cuda``), at each cell's own size and limits, three
seeds: the control fails a limit on every seed and the program passes
all."""

import json

import pytest
import torch

from benchmark import readings

from . import tiny

SEEDS = [2147483711, 2147483723, 2147483789]


@pytest.mark.parametrize("cell", [tiny.PIXEL, tiny.LATENT])
def test_control_fails_at_tiny_size(tiny_root, cell):
    rows = readings.readings(cell, SEEDS, set(SEEDS), device="cpu", root=tiny_root,
                             bench_dir=tiny_root / "benchmark")
    lim = tiny.LIMITS[cell]
    for r in rows:
        assert all(v <= lim[k] for k, v in r["program"].items()), r
        assert r["control"]["eps_err"] > lim["eps_err"], r
        assert r["control"]["sample_err"] > lim["sample_err"], r


CELLS = [w["name"] for w in json.loads((tiny.REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.lib.manifest import Manifest
    lim = {k: v["limit"] for k, v in Manifest().limits(cell).items()}
    for r in readings.readings(cell, SEEDS, set(SEEDS)):
        assert all(v <= lim[k] for k, v in r["program"].items()), r
        assert any(v > lim[k] for k, v in r["control"].items()), r
