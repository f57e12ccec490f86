"""The collectives of the parallel paths, on ``torch.distributed``.

The backend is the caller's choice, made when the ranks start
(``launch.spawn``): NCCL with one card a rank, gloo on the host or for
ranks that share one card (NCCL refuses two ranks on one device).  Gloo's
collectives take host tensors (its support for card tensors covers a few
operations and dtypes), so on the gloo path a card tensor is staged
through the host: copied down, reduced or gathered there, copied back.
That is how the gloo path works, not a fallback: on NCCL the tensors never
leave the card.  Gathers and broadcasts move a tensor's bytes (uint8,
which every backend takes), so they are exact in every dtype.

``stats`` counts the collectives, their bytes and their wall seconds (a
card tensor's stream is synchronized before and after, so the seconds are
the collective's own).
"""

from __future__ import annotations

import contextlib
import time
from typing import List

import torch
import torch.distributed as dist

stats = {"calls": 0, "bytes": 0, "seconds": 0.0}

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def reset_stats() -> None:
    stats.update(calls=0, bytes=0, seconds=0.0)


def size(group) -> int:
    """Ranks in ``group`` (1 for ``None``: no group, one process)."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


@contextlib.contextmanager
def _timed(t: torch.Tensor):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    stats["calls"] += 1
    stats["bytes"] += t.numel() * t.element_size()
    stats["seconds"] += time.perf_counter() - t0


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes, flat (every backend moves uint8)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def all_reduce_(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """Reduce ``t`` over ``group`` in place (``op``: sum, min or max);
    returns it."""
    if size(group) == 1:
        return t
    with _timed(t):
        if _staged(t, group):
            h = t.cpu()
            dist.all_reduce(h, op=_OPS[op], group=group)
            t.copy_(h)
        else:
            dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in the
    group's rank order."""
    n = size(group)
    if n == 1:
        return t
    with _timed(t):
        src = _as_bytes(t.cpu() if _staged(t, group) else t)
        parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        out = torch.cat([p.view(t.dtype).reshape(t.shape) for p in parts], dim=dim)
        if out.device != t.device:
            out = out.to(t.device)
    return out


def broadcast_many_(tensors: List[torch.Tensor], group=None) -> None:
    """Overwrite every tensor in place with the group's first rank's, in
    one collective a device (their bytes concatenated)."""
    if size(group) == 1:
        return
    by_device: dict = {}
    for t in tensors:
        by_device.setdefault(t.device, []).append(t)
    for ts in by_device.values():
        flat = broadcast_(torch.cat([_as_bytes(t) for t in ts]), group)
        for t, b in zip(ts, flat.split([t.numel() * t.element_size() for t in ts])):
            t.copy_(b.clone().view(t.dtype).reshape(t.shape))   # aligned


def broadcast_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Overwrite ``t`` in place with the group's first rank's; returns it."""
    if size(group) == 1:
        return t
    src = dist.get_global_rank(group, 0)
    with _timed(t):
        h = _as_bytes(t.cpu() if _staged(t, group) else t)
        dist.broadcast(h, src=src, group=group)
        if h.data_ptr() != t.data_ptr():          # staged or made contiguous
            t.copy_(h.view(t.dtype).reshape(t.shape))
    return t

