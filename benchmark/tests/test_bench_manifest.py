"""A configuration, a cell, a system and a metric reader are added as
files alone: in a tiny checkout, a throwaway configuration file, a traffic
file, a system file and a reader, named in BENCHMARK.json, are found by
the loader and reported by a run, and no file that was there changes but
BENCHMARK.json, which only gains entries."""

import json
import shutil

import pytest

from benchmark.lib.manifest import Manifest

from . import tiny
from .conftest import run_cell


def add_throwaway(root):
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "tiny-ddpm.json").read_text())
    cfg["name"] = "throwaway-ddpm"
    cfg["unet"] = dict(cfg["unet"], ch_mult=[1, 1])
    (bench / "configs" / "throwaway-ddpm.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "traffic" / "tiny-pixel-mix.json", bench / "traffic" / "throwaway-mix.json")
    shutil.copy(bench / "limits" / "tiny-pixel.json", bench / "limits" / "throwaway.json")
    (bench / "metrics" / "batches_begun.py").write_text(
        "def read(r):\n    return float(r.window.attempted)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "throwaway-ddpm", "source": "https://example.org/x",
                            "file": "benchmark/configs/throwaway-ddpm.json", "reduced": [],
                            "why": "throwaway"})
    spec["workloads"].append({"name": "throwaway", "config": "throwaway-ddpm",
                              "traffic": "throwaway-mix", "chips": 1, "why": "throwaway"})
    spec["end_to_end"].append({"name": "batches_begun", "unit": "batches", "better": "higher",
                               "bound": 0.01, "source": "host_clock", "workloads": ["throwaway"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_loader_finds_added_files(tiny_root):
    add_throwaway(tiny_root)
    man = Manifest(tiny_root, tiny_root / "benchmark")
    assert man.cell("throwaway")["config"] == "throwaway-ddpm"
    assert man.config("throwaway-ddpm")["unet"]["ch_mult"] == [1, 1]
    assert man.traffic("throwaway-mix")["batch"] == tiny.tiny_traffic()[0]["batch"]
    names = [m["name"] for m in man.metrics("throwaway", trace=False)]
    assert "batches_begun" in names and "step_ms_p95" not in names
    assert "batches_begun" not in [m["name"] for m in man.metrics(tiny.PIXEL, trace=False)]


def test_run_reports_added_cell_and_metric(tiny_root):
    add_throwaway(tiny_root)
    rc, res = run_cell(tiny_root, "throwaway")
    assert rc == 0 and res["correct"], res
    assert res["metrics"]["batches_begun"]["value"] >= 1.0
    # the metrics without a list of cells, and the one added for this cell
    # (peak_gib reads nothing on the CPU)
    assert set(res["metrics"]) == {"setup_s", "batches_begun"}


def snapshot(root):
    return {p: p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def grows(old, new) -> bool:
    """``new`` holds all of ``old``, lists only lengthened at their ends."""
    if isinstance(old, dict):
        return isinstance(new, dict) and all(k in new and grows(v, new[k]) for k, v in old.items())
    if isinstance(old, list):
        return isinstance(new, list) and len(new) >= len(old) and all(map(grows, old, new))
    return old == new


def assert_only_added(root, before):
    after = snapshot(root)
    spec_path = root / "BENCHMARK.json"
    assert grows(json.loads(before.pop(spec_path)), json.loads(after[spec_path]))
    assert all(after.get(p) == data for p, data in before.items())


def add_cell(root, name, config, mix, limits_from):
    bench = root / "benchmark"
    shutil.copy(bench / "limits" / f"{limits_from}.json", bench / "limits" / f"{name}.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": name, "config": config, "traffic": mix, "chips": 1,
                              "why": "throwaway"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if limits_from in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.mark.parametrize("guidance, eta", [(7.5, 0.0), (1.0, 1.0)])
def test_latent_ddim_mix_added_as_a_file(tiny_root, guidance, eta):
    """A DDIM mix for the latent system: guided at eta 0, and unguided at
    eta 1 (each step's noise handed to the program and the replay)."""
    before = snapshot(tiny_root)
    traffic = tiny_root / "benchmark" / "traffic"
    mix = json.loads((traffic / f"{tiny.LATENT}-mix.json").read_text())
    mix.update(sampler="ddim", guidance=guidance, eta=eta, check_forwards=[0, 2, -1])
    (traffic / "throwaway-ddim.json").write_text(json.dumps(mix))
    add_cell(tiny_root, "throwaway-ddim", "tiny-sd", "throwaway-ddim", tiny.LATENT)
    assert_only_added(tiny_root, before)
    rc, res = run_cell(tiny_root, "throwaway-ddim")
    assert rc == 0 and res["correct"], res
    assert res["checks"]["sample_err"]["value"] <= 1e-6


def test_system_added_as_a_file(tiny_root, capsys):
    before = snapshot(tiny_root)
    bench = tiny_root / "benchmark"
    (bench / "systems" / "throwaway.py").write_text(
        (bench / "systems" / "pixel_ddim.py").read_text()
        + "\n\nclass System(System):\n    def setup(self):\n"
          "        import sys\n        print('throwaway system', file=sys.stderr)\n"
          "        super().setup()\n")
    cfg = json.loads((bench / "configs" / "tiny-ddpm.json").read_text())
    cfg.update(name="throwaway-sys", system="throwaway")
    (bench / "configs" / "throwaway-sys.json").write_text(json.dumps(cfg))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "throwaway-sys", "source": "https://example.org/x",
                            "file": "benchmark/configs/throwaway-sys.json", "reduced": [],
                            "why": "throwaway"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    add_cell(tiny_root, "throwaway-sys", "throwaway-sys", f"{tiny.PIXEL}-mix", tiny.PIXEL)
    assert_only_added(tiny_root, before)
    rc, res = run_cell(tiny_root, "throwaway-sys")
    assert rc == 0 and res["correct"], res
    assert "throwaway system" in capsys.readouterr().err
