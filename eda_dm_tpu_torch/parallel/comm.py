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
the collective's own); the ``halo_*`` entries count the halo exchanges of
spatial parallelism (``parallel/spatial.py``) apart, and the ``rows_*``
entries the row exchanges of row-sharded reconstruction
(``parallel/rows.py::fetch``); both are in the totals too.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

stats = {"calls": 0, "bytes": 0, "seconds": 0.0,
         "halo_calls": 0, "halo_bytes": 0, "halo_seconds": 0.0,
         "rows_calls": 0, "rows_bytes": 0, "rows_seconds": 0.0}

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def reset_stats() -> None:
    stats.update({k: type(v)() for k, v in stats.items()})


def size(group) -> int:
    """Ranks in ``group`` (1 for ``None``: no group, one process)."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


@contextlib.contextmanager
def _timed(t: torch.Tensor, nbytes=None, kind=()):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    secs = time.perf_counter() - t0
    for prefix in ("",) + kind:
        stats[prefix + "calls"] += 1
        stats[prefix + "bytes"] += t.numel() * t.element_size() if nbytes is None else nbytes
        stats[prefix + "seconds"] += secs


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



def _p2p(payloads: Dict[int, torch.Tensor], recv_bytes: Dict[int, int], group,
         t: torch.Tensor, kind: str) -> Dict[int, torch.Tensor]:
    """One batch of point-to-point messages within ``group``: ``payloads[j]``
    (flat uint8) goes to rank ``j`` and ``recv_bytes[j]`` bytes come from
    rank ``j``; empty messages are not sent.  Staged through the host under
    gloo.  Returns ``{j: the bytes received from j}`` on ``t``'s device,
    counted in the totals and under the prefix ``kind``."""
    dev = torch.device("cpu") if _staged(t, group) else t.device
    peer = lambda j: dist.get_global_rank(group, j)
    with _timed(t, sum(recv_bytes.values()), (kind,)):
        ops = [dist.P2POp(dist.isend, p.to(dev), peer(j), group)
               for j, p in payloads.items() if p.numel()]
        bufs = {j: torch.empty(nb, dtype=torch.uint8, device=dev)
                for j, nb in recv_bytes.items() if nb}
        ops += [dist.P2POp(dist.irecv, b, peer(j), group) for j, b in bufs.items()]
        for req in (dist.batch_isend_irecv(ops) if ops else []):
            req.wait()
        got = {j: b.to(t.device) for j, b in bufs.items()}
    return got


def halo_exchange(t: torch.Tensor, dim: int, up: int, down: int, from_above: int,
                  from_below: int, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """The halo exchange of a tensor split along ``dim`` in rank order:
    ``t``'s first ``up`` rows go to the rank before this one in ``group``
    and its last ``down`` rows to the rank after it; ``from_above`` rows
    come from the rank before (its last ones) and ``from_below`` from the
    rank after (its first).  Returns (rows from above, rows from below),
    each with ``t``'s other axes.  Every rank passes the counts its
    neighbours expect (``spatial.halo_plan`` gives them alike on every
    rank); point-to-point sends of the rows' bytes, in one batch.  The
    bytes counted are those received."""
    r, n = rank(group), size(group)
    shape = lambda rows: t.shape[:dim] + (rows,) + t.shape[dim + 1:]
    sends = {to: _as_bytes(t.narrow(dim, start, rows)) for rows, start, to in
             ((up, 0, r - 1), (down, t.shape[dim] - down, r + 1)) if rows and 0 <= to < n}
    recvs = {frm: rows for rows, frm in ((from_above, r - 1), (from_below, r + 1))
             if 0 <= frm < n}
    got = _p2p(sends, {j: math.prod(shape(rows)) * t.element_size()
                       for j, rows in recvs.items()}, group, t, "halo_")
    above, below = (got[frm].view(t.dtype).reshape(shape(recvs[frm])) if frm in got
                    else t.new_empty(shape(0)) for frm in (r - 1, r + 1))
    return above, below


def exchange_rows(tensors: List[torch.Tensor], sends: List[torch.Tensor],
                  recvs: List[int], group) -> Dict[int, List[torch.Tensor]]:
    """Point-to-point exchange of leading-axis rows between the ranks of
    ``group``.  ``sends[j]``: the indices (a host index tensor) of this
    rank's rows that rank ``j`` gets; ``recvs[j]``: how many rows rank
    ``j`` sends here.  Every tensor (one device, any dtypes) sends the same
    rows, so each pair of ranks exchanges one message a direction: every
    tensor's rows' bytes, one after another.  Returns ``{j: [the rows
    received from j, one tensor per input tensor]}`` for the ranks that
    sent any.  The bytes counted are those received."""
    r, t0 = rank(group), tensors[0]
    row_bytes = [math.prod(t.shape[1:]) * t.element_size() for t in tensors]
    payloads = {j: torch.cat([_as_bytes(t[idx.to(t0.device)]) for t in tensors])
                for j, idx in enumerate(sends) if j != r and len(idx)}
    got = _p2p(payloads, {j: k * sum(row_bytes) for j, k in enumerate(recvs) if j != r},
               group, t0, "rows_")
    return {j: [p.clone().view(t.dtype).reshape((recvs[j],) + t.shape[1:])  # aligned
                for p, t in zip(buf.split([recvs[j] * b for b in row_bytes]), tensors)]
            for j, buf in got.items()}
