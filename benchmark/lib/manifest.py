"""The benchmark's manifest: ``BENCHMARK.json`` at the checkout's root and
the files it names.  A cell is found by its name there; its configuration
by the ``file`` of its ``configs`` entry; its traffic mix in
``traffic/<traffic>.json``; its correctness limits in
``limits/<cell>.json``; each metric's reader in ``metrics/<metric>.py``;
the system a configuration names in ``systems/<system>.py``.  Nothing
here knows a cell, a configuration, a system or a metric by name, so a
later change adds any of them as files."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Manifest:
    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root, self.bench_dir = Path(root), Path(bench_dir)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules: Dict[str, object] = {}

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench_dir / "traffic" / f"{name}.json").read_text())

    def data_file(self, kind: str, name: str) -> Path:
        return self.bench_dir / kind / name

    def limits(self, cell: str) -> Optional[dict]:
        p = self.bench_dir / "limits" / f"{cell}.json"
        return json.loads(p.read_text()) if p.exists() else None

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (``trace`` False) or per-layer ones."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def _module(self, kind: str, name: str):
        """``<kind>/<name>.py`` under the benchmark's folder, loaded once."""
        path = self.bench_dir / kind / f"{name}.py"
        if str(path) not in self._modules:
            spec = importlib.util.spec_from_file_location(f"_bench_{kind}_{len(self._modules)}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[str(path)] = mod
        return self._modules[str(path)]

    def reader(self, metric: str) -> Callable:
        """``read(record)`` of ``metrics/<metric>.py``."""
        return self._module("metrics", metric).read

    def system(self, name: str) -> type:
        """``System`` of ``systems/<name>.py``: the class that sets up, drives
        and checks a configuration whose ``system`` is ``name``."""
        return self._module("systems", name).System
