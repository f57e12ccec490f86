"""Module paths: the JAX package's variable paths on the port's modules."""

from __future__ import annotations

import re
from typing import Sequence

import torch.nn as nn

_LIST = re.compile(r"(down|up|block|attn)_(\d+)")


def child(module: nn.Module, name: str) -> nn.Module:
    """The submodule that the JAX path element ``name`` names: the
    attribute of that name, or for a flax list entry ``down_0`` /
    ``up_1`` / ``block_0`` / ``attn_2`` the entry ``down[0]`` ..."""
    sub = getattr(module, name, None)
    if isinstance(sub, nn.Module):
        return sub
    m = _LIST.fullmatch(name)
    if m and isinstance(getattr(module, m.group(1), None), nn.ModuleList):
        return getattr(module, m.group(1))[int(m.group(2))]
    raise KeyError(f"{type(module).__name__} has no submodule {name!r}")


def get_submodule(module: nn.Module, path: Sequence[str]) -> nn.Module:
    for p in path:
        module = child(module, p)
    return module
