"""The one traffic generator.  A traffic mix is a data file
(``traffic/<name>.json``): the batch, the sampler's recipe (sampler,
steps, grid, eta, guidance) and, for text-conditioned models, the prompt
lengths and the vocabulary file their words come from.  Every batch's x_T,
prompts and (at eta above 0) per-step noise are drawn from ``--seed`` and
the batch index; every seed gives the same sizes, so only the values
change."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .weights import derive, generator


class Traffic:
    def __init__(self, spec: dict, sample_shape, seed: int, device, vocabulary=None):
        self.spec, self.seed, self.device = spec, seed, device
        self.batch = int(spec["batch"])
        self.shape = tuple(sample_shape)
        self.words = None
        if "prompts" in spec:
            self.words = [w for w in vocabulary.read_text().split() if w]
            self.lengths = tuple(spec["prompts"]["words"])

    def x_T(self, b, rows: int = None) -> torch.Tensor:
        """Batch ``b``'s starting noise (``rows`` of it; default the batch)."""
        return torch.randn((rows or self.batch, *self.shape), device=self.device,
                           generator=generator(self.seed, self.device, "x_T", b))

    def noise(self, b) -> "Noise":
        """Batch ``b``'s per-step noise for a sampler at eta above 0, handed
        to the program and to the reference's replay alike."""
        return Noise(self, b)

    def prompts(self, b, rows: int = None) -> List[str]:
        """Batch ``b``'s prompts: each of a length drawn uniformly from the
        mix's range, its words drawn uniformly from the vocabulary."""
        rng = np.random.default_rng(derive(self.seed, "prompts", b))
        lo, hi = self.lengths
        return [" ".join(rng.choice(self.words, int(rng.integers(lo, hi + 1))))
                for _ in range(rows or self.batch)]

    def timesteps(self, b, rows: int, num_timesteps: int) -> torch.Tensor:
        """Timesteps drawn uniformly over the schedule (the stand-in
        calibration's rows)."""
        g = generator(self.seed, self.device, "t", b)
        return torch.randint(0, num_timesteps, (rows,), generator=g,
                             device=self.device).float()


class Noise:
    """Step k's noise of one batch (``noise[k]``), drawn when it is asked
    for, on the device."""

    def __init__(self, traffic: Traffic, b):
        self.t, self.b = traffic, b

    def __getitem__(self, k: int) -> torch.Tensor:
        t = self.t
        return torch.randn((t.batch, *t.shape), device=t.device,
                           generator=generator(t.seed, t.device, "noise", self.b, k))
