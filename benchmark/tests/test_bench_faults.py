"""The check catches a broken timed path.  The faults a cell of one chip
can have: a step that returns its state unchanged, half of the batch left
out (its rows set to the mean of the rest), an answer altered where it is
produced.  (No cell crosses chips, so no exchange can be left out.)

On the CPU, a run of each tiny cell (the look for a card skipped) with a
fault planted under the program's entry point reads ``correct`` false.  On
a card (marker ``cuda``), each cell of ``BENCHMARK.json`` at its own size
and limits: one set-up, one sound batch that passes every limit, then one
batch under each fault that fails one."""

import json

import pytest
import torch

from . import tiny
from .conftest import run_cell

def _unchanged_step(monkeypatch, system):
    if system == "pixel_ddim":
        import eda_dm_tpu_torch.samplers.ddim as mod
        monkeypatch.setattr(mod, "ddim_denoise_step", lambda x, et, *a: (x, x))
    else:
        import eda_dm_tpu_torch.samplers.latent as mod
        monkeypatch.setattr(mod, "ddim_update", lambda x, *a: (x, x))


def _half_batch(monkeypatch, system):
    if system == "pixel_ddim":
        from eda_dm_tpu_torch.models.ddpm_unet import DDPMUNet as cls
    else:
        from eda_dm_tpu_torch.models.ldm_unet import LDMUNet as cls
    forward = cls.forward

    def half(self, x, t, *args, **kwargs):
        k = x.shape[0] // 2
        sub = lambda v: v[:k] if isinstance(v, torch.Tensor) and v.shape[:1] == x.shape[:1] else v
        out = forward(self, x[:k], t[:k], *[sub(a) for a in args],
                      **{n: sub(v) for n, v in kwargs.items()})
        return torch.cat([out, out.mean(0, keepdim=True).expand(x.shape[0] - k, *out.shape[1:])])
    monkeypatch.setattr(cls, "forward", half)


def _altered_answer(monkeypatch, system):
    if system == "pixel_ddim":
        from eda_dm_tpu_torch.pipelines.cifar import CifarPipeline as cls
    else:
        from eda_dm_tpu_torch.pipelines.latent import LDMPipeline as cls
    sample = cls.sample_batch

    def altered(self, *args, **kwargs):
        img = sample(self, *args, **kwargs).clone()
        img[-1] = 1.0 - img[-1]
        return img
    monkeypatch.setattr(cls, "sample_batch", altered)


FAULTS = [_unchanged_step, _half_batch, _altered_answer]
SYSTEM = {tiny.PIXEL: "pixel_ddim", tiny.LATENT: "latent_text"}


@pytest.mark.parametrize("cell", [tiny.PIXEL, tiny.LATENT])
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__.strip("_"))
def test_fault_reads_incorrect(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch, SYSTEM[cell])
    rc, res = run_cell(tiny_root, cell)
    assert rc == 0 and res is not None
    assert res["correct"] is False, res["checks"]


CELLS = [w["name"] for w in json.loads((tiny.REPO / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2147483831


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_faults_read_incorrect_at_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import readings
    man, config, traffic, device = readings.open_cell(cell)
    lim = {k: v["limit"] for k, v in man.limits(cell).items()}
    system = readings.set_up(man, config, traffic, SEED, device)
    for fault in [None] + FAULTS:
        with pytest.MonkeyPatch.context() as mp:
            if fault:
                fault(mp, config["system"])
            numbers = system.check(readings.one_batch(system))
        name = fault.__name__.strip("_") if fault else "none"
        print(json.dumps({"workload": cell, "seed": SEED, "fault": name, "program": numbers,
                          "limits": lim}), flush=True)
        if fault:
            assert any(v > lim[k] for k, v in numbers.items()), (name, numbers)
        else:
            assert all(v <= lim[k] for k, v in numbers.items()), numbers
