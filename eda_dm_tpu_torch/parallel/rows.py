"""Which rows of a global batch this process holds.

Under GSPMD a JAX function traces the global shapes, so its shape rules,
random draws and batch statistics are those of the global batch.  A rank
here holds a contiguous block of the rows (``mesh.shard_batch``: rank r of
n holds rows ``[r·b, (r+1)·b)`` of ``n·b``).  Inside
``with sharded_rows(group):`` the model code reads the global batch from
here:

* :func:`global_rows`: the attention dispatch (``attention_impl``) takes
  the global batch, as JAX's does;
* :func:`draw`: every rank draws the global shape from the same generator
  state and keeps its own rows (the samplers' noise, QDrop's masks,
  reconstruction's input mixing), so the rows equal a single process's;
* :func:`stats_group`: the activation range search reduces its statistics
  over the group (``quant/search.py``).

:func:`fetch` takes rows of tensors that are themselves sharded in such
blocks (reconstruction's captures): each rank gets its block of a global
index list, the rows it does not hold coming from their owners.

Outside the context (or with one rank) every function is the identity of
the single-process path.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from . import comm


@dataclasses.dataclass(frozen=True)
class RowShard:
    group: object
    rank: int
    size: int


_current: contextvars.ContextVar[Optional[RowShard]] = contextvars.ContextVar(
    "row_shard", default=None)


@contextlib.contextmanager
def sharded_rows(group):
    """Mark the enclosed forwards as running on this rank's rows of a batch
    sharded over ``group`` (``None``: one process, no sharding)."""
    n = comm.size(group)
    token = _current.set(RowShard(group, comm.rank(group), n) if n > 1 else None)
    try:
        yield
    finally:
        _current.reset(token)


def global_rows(n_local: int) -> int:
    """The global batch of a forward on ``n_local`` rows."""
    shard = _current.get()
    return n_local if shard is None else n_local * shard.size


def stats_group():
    """The group that statistics of a sharded batch reduce over, or None."""
    shard = _current.get()
    return None if shard is None else shard.group


def draw(fn: Callable, shape: Sequence[int], **kw) -> torch.Tensor:
    """``fn(shape, **kw)`` (``torch.randn``, ``torch.rand``) for a local
    ``shape`` whose first axis is this rank's rows: the global shape is
    drawn and this rank's contiguous block of its rows returned."""
    shard = _current.get()
    if shard is None:
        return fn(tuple(shape), **kw)
    full = fn((shape[0] * shard.size,) + tuple(shape[1:]), **kw)
    return full[shard.rank * shape[0]:(shard.rank + 1) * shape[0]]


def fetch(tensors: Sequence[torch.Tensor], idx: torch.Tensor, group) -> List[torch.Tensor]:
    """Rows ``idx`` (global indices) of tensors whose rows are sharded over
    ``group`` in contiguous blocks (rank r holds rows ``[r·b, (r+1)·b)``).
    Every rank passes the same ``idx`` and gets its block of it: rank r the
    rows ``idx[r·k:(r+1)·k]``, k = ``len(idx) / n``, in that order.  Rows
    held by another rank come from it through ``comm.exchange_rows``, and
    only those move.  ``len(idx)`` must divide over the ranks, as
    ``mesh.shard_batch`` requires.  Without a group: ``[a[idx] for a in
    tensors]``."""
    n = comm.size(group)
    if n == 1:
        return [a[idx.to(a.device)] for a in tensors]
    r, b, m = comm.rank(group), tensors[0].shape[0], idx.shape[0]
    if m % n:
        raise ValueError(f"{m} rows do not shard evenly over {n} devices")
    k = m // n
    gi = idx.cpu().long()
    if len(gi) and not (0 <= int(gi.min()) and int(gi.max()) < b * n):
        raise IndexError(f"row indices outside the {b * n} rows sharded over {n} ranks")
    owner, local = gi // b, gi % b
    mine = slice(r * k, (r + 1) * k)
    sends = [local[j * k:(j + 1) * k][owner[j * k:(j + 1) * k] == r] for j in range(n)]
    recvs = [int((owner[mine] == j).sum()) for j in range(n)]
    got = comm.exchange_rows(list(tensors), sends, recvs, group)
    out = []
    for i, a in enumerate(tensors):
        o = torch.empty((k,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
        here = (owner[mine] == r).to(a.device)
        o[here] = a[local[mine].to(a.device)[here]]
        for j, parts in got.items():
            o[(owner[mine] == j).to(a.device)] = parts[i]
        out.append(o)
    return out
