"""Weights and seeds.  Every random draw of a run comes from ``--seed``
through :func:`derive`, which names the stream (weights, a batch's x_T, its
prompts, the checked forwards), so the same seed gives the same inputs and
weights.

:func:`make` draws a whole model's parameters on the device in one call
(float32 normals) and scales each slice by the configuration's rule for
its name; the state dict it returns loads into the program's model and
into the reference alike."""

from __future__ import annotations

import math
import re
import zlib
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the stream that ``tags`` name."""
    words = [seed % 2 ** 32, (seed // 2 ** 32) % 2 ** 32, (seed // 2 ** 64) % 2 ** 32]
    words += [zlib.crc32(str(t).encode()) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def _scale(rule: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of one parameter under ``rule``: ``normal:<std>``,
    ``one+normal:<std>`` (norm scales), or ``fan_in:<axes>`` (N(0, 1/fan_in),
    fan_in the product of the axes a slice names: ``1:`` all but the
    first, ``:-1`` all but the last, ``:1`` the first)."""
    kind, arg = rule.split(":", 1)
    if kind == "normal":
        return 0.0, float(arg)
    if kind == "one+normal":
        return 1.0, float(arg)
    if kind == "fan_in":
        lo, hi = (int(v) if v else None for v in arg.split(":"))
        return 0.0, math.prod(shape[lo:hi]) ** -0.5
    raise ValueError(f"unknown init rule {rule!r}")


def make(named_shapes: Iterable[Tuple[str, Tuple[int, ...]]], rules: List[List[str]],
         seed: int, device, tag: str) -> Dict[str, torch.Tensor]:
    """Parameters for ``named_shapes`` from the stream ``(seed, "weights",
    tag)``: one normal draw for all, each slice shifted and scaled by the
    first rule (``[regex, init]``) whose regex finds its name."""
    named = [(n, tuple(s)) for n, s in named_shapes]
    flat = torch.randn(sum(math.prod(s) for _, s in named),
                       generator=generator(seed, device, "weights", tag), device=device)
    out, off = {}, 0
    for name, shape in named:
        rule = next((r for pat, r in rules if re.search(pat, name)), None)
        if rule is None:
            raise ValueError(f"no init rule names parameter {name!r}")
        mean, std = _scale(rule, shape)
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape).mul_(std).add_(mean)
        off += n
    return out


def shapes_of(module: torch.nn.Module):
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


@torch.no_grad()
def load(module: torch.nn.Module, state: Dict[str, torch.Tensor], what: str) -> None:
    """Copy ``state`` into every parameter of ``module``: the names have to
    match one to one (buffers are left as they are)."""
    params = dict(module.named_parameters())
    if set(params) != set(state):
        raise RuntimeError(f"{what}: parameters differ from the reference's: "
                           f"missing {sorted(set(params) - set(state))[:5]}, "
                           f"extra {sorted(set(state) - set(params))[:5]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(state[name].shape):
            raise RuntimeError(f"{what}: {name} is {tuple(p.shape)}, "
                               f"the reference's {tuple(state[name].shape)}")
        p.copy_(state[name])
