"""What every system under test shares.  A configuration's ``system``
names its file, ``systems/<system>.py``, whose ``System`` subclasses
:class:`System` here: it drives the program's own entry point and checks
what the program produced against the reference.  The manifest finds it by
that name, so a new kind of system is a new file.

Set-up (every run): the program's pipeline at the configuration's widths,
the benchmark's weights from the seed (``lib/weights.py``), the stand-in
quant state (``lib/standin.py``), the user's export
(``serving_variables(serve=...)``, the float model then dropped) and a
warm-up of this cell's shapes only.  A system knows no cell: batch,
sampler, steps, eta and guidance come from the traffic mix, and the
reference's replay of the sampler from ``reference/samplers.py``'s table
by the mix's ``sampler``."""

from __future__ import annotations

import dataclasses
import importlib
import math
import time

import torch

from ..reference.samplers import SAMPLERS, guide
from . import weights
from .traffic import Traffic

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve(name: str):
    """``"package.module:attr"`` → the attribute."""
    mod, _, attr = name.partition(":")
    return getattr(importlib.import_module(mod), attr)


def tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


class Gaps:
    """The compared numbers.  Each is the worst row's gap: ``||a − b||``
    over the larger of the reference row's norm and the median reference
    row's (a row whose reference is near zero does not blow up; a garbage
    row still reads about 1 or more); a non-finite row reads inf.  The
    readings also get the other statistics of each comparison
    (``detail``)."""

    def __init__(self):
        self.values, self.detail = {}, []

    def add(self, name: str, a: torch.Tensor, b: torch.Tensor, **where):
        a, b = a.float().flatten(1), b.float().flatten(1)
        d, n = (a - b).norm(dim=1), b.norm(dim=1)
        med = n.median()
        worst = float((d / torch.maximum(n, med).clamp_min(1e-30)).max())
        worst = worst if math.isfinite(worst) else float("inf")
        self.values.setdefault(name, []).append(worst)
        rel = d / n.clamp_min(1e-30)
        i = int(rel.argmax())
        self.detail.append(dict(number=name, **where, value=worst, rel_max=float(rel[i]),
                                rel_median=float(rel.median()),
                                whole=float(d.norm() / n.norm().clamp_min(1e-30)),
                                worst_row=i, worst_norm_over_median=float(n[i] / med)))

    def numbers(self) -> dict:
        return {k: max(v) for k, v in self.values.items()}


@dataclasses.dataclass
class Batch:
    """What a recorded batch left for the check."""
    index: int
    eps: torch.Tensor = None           # (forwards, rows, ...) on pinned host memory
    inputs: dict = dataclasses.field(default_factory=dict)   # forward → its x
    images: torch.Tensor = None
    latents: torch.Tensor = None       # the decode's input (latent models)
    finished: bool = False


class System:
    """The base of ``systems/<system>.py``'s ``System``.  A subclass gives
    ``sample_shape``, ``setup`` (which sets ``unet``, ``mode``, ``rows``,
    ``out_shape`` and ``forwards_per_batch``), ``warm_up``, ``run_batch``,
    ``release`` and ``check``; it may give ``wrap_decode``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, manifest):
        self.config, self.spec, self.seed, self.device = config, traffic, seed, device
        q = config["quant"]
        self.serve, self.carrier = q["serve"], DTYPES[q["carrier"]]
        vocab = (manifest.data_file("traffic", traffic["prompts"]["vocabulary"])
                 if "prompts" in traffic else None)
        self.traffic = Traffic(traffic, self.sample_shape(), seed, device, vocab)
        self.images_per_batch = self.traffic.batch
        self.sampler = SAMPLERS[traffic["sampler"]]
        self.eta = float(traffic.get("eta", 0.0))
        self.program_seed = weights.derive(seed, "program") % 2 ** 31
        self.ref_rows = int(config["reference"]["rows"])
        self.phase_s, self._last = {}, time.perf_counter()

    def mark(self, phase: str):
        """Seconds since the previous mark, under ``phase`` (the set-up's
        split, printed by the run; the card synchronised)."""
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.phase_s[phase] = now - self._last
        self._last = now

    def build_kernels(self):
        """Every kernel source at once (the first run in a checkout; later
        runs find them in the program's build directory)."""
        if torch.device(self.device).type == "cuda":
            from eda_dm_tpu_torch.ops import _build
            _build.build()

    def checked_forwards(self) -> list:
        """The forwards of a recorded batch whose inputs the check reruns:
        the mix's fixed positions (first, middle, last).  The UNet's gap to
        the reference grows with the noise level, so positions drawn from
        the seed made the number swing twofold from seed to seed."""
        return [int(f) % self.forwards_per_batch for f in self.spec["check_forwards"]]

    def noise(self, b):
        """Batch ``b``'s per-step noise where the sampler draws any."""
        return self.traffic.noise(b) if self.eta else None

    def replay(self, rec: Batch, steps, dtype, guidance: float = None):
        """The reference's sampler from the batch's x_T over the program's
        recorded UNet outputs (guided at ``guidance``, if given)."""
        recorded = iter(rec.eps)

        def eps(x, t):
            e = next(recorded).to(self.device).float()
            return e if guidance is None else guide(e, guidance)
        return self.sampler.replay(self.traffic.x_T(rec.index), steps, eps, dtype=dtype,
                                   eta=self.eta, noise=self.noise(rec.index))

    def state(self, cls, arch, tag):
        """The benchmark's weights for the reference module ``cls(arch)``
        (the stream ``tag``), which the program's module takes too."""
        with torch.device("meta"):
            shapes = weights.shapes_of(cls(arch))
        return weights.make(shapes, self.config["init"][tag], self.seed, self.device, tag)

    def reference(self, cls, arch, tag):
        from ..reference.layers import _Quantized
        with torch.device(self.device):
            ref = cls(arch)
        weights.load(ref, self.state(cls, arch, tag), f"reference {tag}")
        for m in ref.modules():
            if isinstance(m, _Quantized):
                m.prepare()
        return ref
