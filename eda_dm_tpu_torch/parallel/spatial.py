"""Which rows of the height axis this process holds (spatial parallelism).

JAX's ``shard_spatial`` (``parallel/tp.py``) puts an activation's H axis
on a mesh axis and lets GSPMD partition every op: a 3×3 conv gets its halo
rows from the neighbouring devices, a norm's statistics are reduced over
them and an attention over all of H gathers it.  Here a rank holds a
contiguous block of rows (rank r of n holds rows ``[r·h, (r+1)·h)`` of
``H = n·h``; ``tp.shard_spatial``) and, inside ``with
sharded_height(group):``, the layers do that work themselves through this
module:

* :func:`conv_site` and :func:`conv`: a conv's input rows and pads on this rank
  (:func:`halo_plan`: the rows it takes from the rank above and below, and
  the shard's own pads, which are the global ones only at the global
  edge);
* :func:`height_sum`, :func:`all_reduce_stats` and :func:`count`: a norm's
  sums over all of H, the ranks' partial sums added in rank order;
* :func:`run_whole`: a block that needs all of H (attention) runs on the
  gathered rows (:func:`gather_height`), and this rank keeps its own
  (:func:`keep_rows`);
* :func:`upsample`, :func:`downsample`: a 2× resample of the rows;
* :func:`draw`: a random draw of the global shape, of which this rank
  keeps its rows (the samplers' noise), as ``rows.draw`` does for a batch.

**Where H is not sharded.**  A conv's output is sharded where its global
height divides by n and each rank's window of input rows takes its halo
from its two neighbours only; a 2×2 pool's, where this rank's rows are
even.  Elsewhere (a 4×4 level over 8 ranks, a stride-2 conv over odd
shards) the input is gathered once and the output is whole on every rank;
the layers after it run whole until a 2× upsample brings the height back
to one that divides, where each rank keeps its rows again.  Whether a
tensor is sharded follows from its local shape: the models keep their
input's aspect ratio (global H / W, given to :func:`sharded_height`) at
every level, so on sharded rows n·h / W is that ratio and on a whole
tensor h / W is; a shape that is neither raises.  Tensors are NHWC
(``dim=1``) or NCHW (``dim=2``): H at ``dim``, W right after it.

:func:`rank_blocks` is the single-process control: one process computes
what a rank computes at its own number of rows, block by block as the
ranks do (the norms' sums, each block's added in rank order, and the
float convs, whose sums follow cuDNN's and cuBLAS's choice for that
shape), so a sharded forward that equals it bit for bit has its halos,
pads and gathers exact.

Outside the context (or with one rank) every function is the identity of
the single-process path.  Calibration and QDrop forwards are not run
sharded (``nn/layers.py`` refuses them): the serving forwards are.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from fractions import Fraction
from typing import Callable, Optional, Sequence, Tuple

import torch

from . import comm, rows

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class Halo:
    """One rank's rows for a conv: ``above`` rows from the rank before (its
    last), ``below`` from the rank after (its first), its own rows less
    ``skip`` = (top, bottom) that its outputs do not read, and ``pads`` =
    (top, bottom), the shard's own zero rows."""
    above: int
    below: int
    pads: Tuple[int, int]
    skip: Tuple[int, int] = (0, 0)


@functools.lru_cache(maxsize=None)
def halo_plans(kernel: int, stride: int, global_pads: Tuple[int, int], H: int,
               n: int) -> Optional[Tuple[Halo, ...]]:
    """Every rank's :class:`Halo` for a conv of ``kernel`` rows at ``stride``
    with ``global_pads`` = (top, bottom) over a height ``H`` split into n
    blocks, or None where the rule keeps the output whole (the module
    docstring).  Rank r computes output rows ``[r·ho, (r+1)·ho)``."""
    pt, pb = global_pads
    if H % n:
        return None
    h = H // n
    Ho = (H + pt + pb - kernel) // stride + 1
    if Ho < n or Ho % n:
        return None
    ho = Ho // n
    plans = []
    for r in range(n):
        lo = r * ho * stride - pt                       # first row read (pads < 0)
        hi = ((r + 1) * ho - 1) * stride - pt + kernel - 1
        first, last = max(lo, 0), min(hi, H - 1)
        if first > (r + 1) * h or last < r * h - 1:     # not contiguous with its own
            return None
        halo = Halo(above=max(0, r * h - first), below=max(0, last - ((r + 1) * h - 1)),
                    pads=(first - lo, hi - last),
                    skip=(max(0, first - r * h), max(0, (r + 1) * h - 1 - last)))
        if halo.above > h or halo.below > h:
            return None
        plans.append(halo)
    return tuple(plans)


def halo_plan(kernel: int, stride: int, global_pads: Tuple[int, int], H: int,
              rank: int, n: int) -> Optional[Halo]:
    """This rank's :class:`Halo` (see :func:`halo_plans`), or None where the
    rule keeps the conv's output whole."""
    plans = halo_plans(kernel, stride, tuple(global_pads), H, n)
    return None if plans is None else plans[rank]


def halo_rows(x: torch.Tensor, halo: Halo, rank: int, n: int, dim: int = 1) -> torch.Tensor:
    """The conv input rows of ``rank`` (without its pads) taken from the
    whole tensor ``x``: what the halo exchange gives that rank."""
    h = x.shape[dim] // n
    start = rank * h - halo.above + halo.skip[0]
    return x.narrow(dim, start, halo.above + h - halo.skip[0] - halo.skip[1] + halo.below)


class HeightShard:
    """The context's state: the group, this rank, the number of ranks and
    the inputs' aspect ratio (global H / W)."""

    def __init__(self, group, rank: int, size: int, aspect: Fraction):
        self.group, self.rank, self.size, self.aspect = group, rank, size, aspect

    def sharded(self, x: torch.Tensor, dim: int) -> bool:
        """Whether ``x`` holds this rank's rows (n·h / W is the aspect
        ratio) or all of them (h / W is)."""
        h, w = x.shape[dim], x.shape[dim + 1]
        if Fraction(h * self.size, w) == self.aspect:
            return True
        if Fraction(h, w) == self.aspect:
            return False
        raise RuntimeError(f"spatial parallelism: a local {h}x{w} is neither this rank's "
                           f"rows nor all of H at the aspect ratio {self.aspect} over "
                           f"{self.size} ranks")


_current: contextvars.ContextVar[Optional[HeightShard]] = contextvars.ContextVar(
    "height_shard", default=None)
_blocks: contextvars.ContextVar[int] = contextvars.ContextVar("rank_blocks", default=1)


@contextlib.contextmanager
def sharded_height(group, aspect=1):
    """Mark the enclosed forwards as running on this rank's rows of H,
    split over ``group`` (``None`` or one rank: no sharding); ``aspect``:
    the inputs' global H / W."""
    n = comm.size(group)
    token = _current.set(HeightShard(group, comm.rank(group), n, Fraction(aspect))
                         if n > 1 else None)
    try:
        yield
    finally:
        _current.reset(token)


@contextlib.contextmanager
def rank_blocks(n: int):
    """In one process, compute what n ranks of :func:`sharded_height`
    compute at their own number of rows, block by block: the norms' sums
    (:func:`height_sum`: each block of rows summed alone, the blocks' sums
    added in rank order) and the float convs (:func:`conv`: each block's
    rows and halo, contiguous, with its pads); attention blocks run whole,
    as they do sharded, and so do the exact int8 convs.  It splits every
    height that divides by n (a conv's, where :func:`halo_plans` shards
    it), which is where a sharded forward holds its rows when the rule
    shards every height that divides (the port's models at two ranks, the
    tiny test models at four)."""
    token = _blocks.set(n)
    try:
        yield
    finally:
        _blocks.reset(token)


def active() -> bool:
    return _current.get() is not None


@contextlib.contextmanager
def _whole():
    token, blocks = _current.set(None), _blocks.set(1)
    try:
        yield
    finally:
        _current.reset(token)
        _blocks.reset(blocks)


def is_sharded(x: torch.Tensor, dim: int = 1) -> bool:
    sh = _current.get()
    return sh is not None and sh.sharded(x, dim)


def global_shape(x: torch.Tensor, dim: int = 1) -> Tuple[int, ...]:
    """``x``'s shape with the global height."""
    if not is_sharded(x, dim):
        return tuple(x.shape)
    shape = list(x.shape)
    shape[dim] *= _current.get().size
    return tuple(shape)


def gather_height(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """All of H: every rank's rows in rank order."""
    sh = _current.get()
    return x if sh is None else comm.all_gather(x, sh.group, dim=dim)


def keep_rows(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's block of the rows of a whole ``x``."""
    sh = _current.get()
    if sh is None:
        return x
    h = x.shape[dim] // sh.size
    return x.narrow(dim, sh.rank * h, h)


def all_reduce_stats(t: torch.Tensor) -> torch.Tensor:
    """A norm's partial sums over this rank's rows summed over the ranks:
    gathered and added in rank order, so every rank holds the same sums
    and :func:`rank_blocks` reproduces them in one process (the identity
    outside the context)."""
    sh = _current.get()
    if sh is None:
        return t
    return functools.reduce(torch.add, comm.all_gather(t.unsqueeze(0), sh.group).unbind(0))


def splits_sums(x: torch.Tensor, dim: int = 1) -> bool:
    """Whether a norm over ``x`` takes its sums by :func:`height_sum`: on
    sharded rows, or under :func:`rank_blocks` where the height divides."""
    n = _blocks.get()
    return is_sharded(x, dim) or (n > 1 and x.shape[dim] % n == 0)


def height_sum(t: torch.Tensor, dims: Sequence[int], dim: int = 1) -> torch.Tensor:
    """``t`` summed over ``dims`` (the height ``dim`` among them, each kept
    as size 1) where :func:`splits_sums`: on sharded rows this rank's sums
    added over the ranks (:func:`all_reduce_stats`); under
    :func:`rank_blocks` each block of rows summed alone (contiguous, as a
    rank holds it) and the blocks' sums added in the same order."""
    if is_sharded(t, dim):
        return all_reduce_stats(t.sum(dim=dims, keepdim=True))
    return functools.reduce(torch.add, [b.contiguous().sum(dim=dims, keepdim=True)
                                        for b in t.chunk(_blocks.get(), dim)])


def run_whole(fn: Callable, x: torch.Tensor, *args, dim: int = 1):
    """``fn(x, *args)`` for a block that needs all of H: on sharded rows,
    gathered first and run as one process runs it (its shapes, and so its
    kernel dispatch, are the unsharded ones), this rank's rows kept."""
    sh = _current.get()
    if sh is None:
        if _blocks.get() == 1:
            return fn(x, *args)
        with _whole():
            return fn(x, *args)
    sharded = sh.sharded(x, dim)
    xin = gather_height(x, dim) if sharded else x
    with _whole():
        out = fn(xin, *args)
    return keep_rows(out, dim) if sharded else out


class ConvSite:
    """One conv's geometry on this rank (:func:`conv_site`): ``pads``, the
    pads its conv takes; ``global_pads``, the unsharded conv's;
    :meth:`rows` forms its input rows from the local ones (contiguous), :meth:`whole`
    gives all of H, and :meth:`padded_rows` takes its rows from all of H
    padded with ``global_pads`` (K6's output).  ``plans``: every rank's
    :class:`Halo`, or None where the output is whole."""

    def __init__(self, pads: Pads, global_pads: Pads, shard: Optional[HeightShard] = None,
                 plans=None, dim: int = 1):
        self.pads, self.global_pads = pads, global_pads
        self._shard, self._plans, self._dim = shard, plans, dim
        self._halo = plans[shard.rank] if plans else None

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        if self._shard is None:
            return t
        return comm.all_gather(t, self._shard.group, dim=self._dim)

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        sh, halo, dim = self._shard, self._halo, self._dim
        if halo is None:
            return self.whole(t)
        own = t.narrow(dim, halo.skip[0], t.shape[dim] - halo.skip[0] - halo.skip[1])
        if not any(p.above or p.below for p in self._plans):
            return own.contiguous()
        r, n = sh.rank, sh.size
        above, below = comm.halo_exchange(
            t, dim, self._plans[r - 1].below if r else 0,
            self._plans[r + 1].above if r + 1 < n else 0, halo.above, halo.below, sh.group)
        return torch.cat([above, own, below], dim)

    def padded_rows(self, tp: torch.Tensor) -> torch.Tensor:
        sh, halo = self._shard, self._halo
        if halo is None:
            return tp
        pt = self.global_pads[0][0]
        H = tp.shape[self._dim] - pt - self.global_pads[0][1]
        h = H // sh.size
        start = sh.rank * h - halo.above + halo.skip[0] - halo.pads[0] + pt
        length = (halo.above + h - halo.skip[0] - halo.skip[1] + halo.below
                  + halo.pads[0] + halo.pads[1])
        return tp.narrow(self._dim, start, length)


def conv_site(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
              pads_fn: Callable[[int, int], Pads], dim: int = 1) -> ConvSite:
    """How this rank runs a conv on ``x`` (H at ``dim``, W after it):
    ``pads_fn(H, W)`` gives the unsharded conv's pads.  Outside the context
    or on a whole ``x``: the unsharded conv.  On sharded rows: the halo
    exchange and the shard's pads of :func:`halo_plan`, or, where the rule
    keeps the output whole, the gathered rows and the global pads."""
    sh = _current.get()
    h, w = x.shape[dim], x.shape[dim + 1]
    if sh is None or not sh.sharded(x, dim):
        pads = pads_fn(h, w)
        return ConvSite(pads, pads)
    H = h * sh.size
    gp = pads_fn(H, w)
    plans = halo_plans(kernel[0], stride[0], tuple(gp[0]), H, sh.size)
    if plans is None:
        return ConvSite(gp, gp, sh, dim=dim)
    return ConvSite((plans[sh.rank].pads, tuple(gp[1])), gp, sh, plans, dim)


def conv(fn: Callable, x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
         pads_fn: Callable[[int, int], Pads], dim: int = 1) -> torch.Tensor:
    """``fn(rows, pads)``, a float conv of ``x`` (see :func:`conv_site`):
    on this rank's rows with their halo and the shard's pads; under
    :func:`rank_blocks`, block by block as the ranks run it (each block's
    rows and halo, contiguous, with its pads; the outputs concatenated),
    since cuDNN and cuBLAS choose their sums by the number of rows."""
    n = _blocks.get()
    if n > 1 and _current.get() is None:
        h, w = x.shape[dim], x.shape[dim + 1]
        gp = pads_fn(h, w)
        plans = halo_plans(kernel[0], stride[0], tuple(gp[0]), h, n)
        if plans is not None:
            return torch.cat([fn(halo_rows(x, p, r, n, dim).contiguous(), (p.pads, tuple(gp[1])))
                              for r, p in enumerate(plans)], dim)
    site = conv_site(x, kernel, stride, pads_fn, dim)
    return fn(site.rows(x), site.pads)


def upsample(fn: Callable, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """``fn(x)``, a 2× nearest upsample: local on sharded rows; from a
    whole ``x``, each rank keeps its rows again where the new height
    divides."""
    sh = _current.get()
    if sh is None:
        return fn(x)
    sharded = sh.sharded(x, dim)
    out = fn(x)
    if sharded or out.shape[dim] % sh.size:
        return out
    return keep_rows(out, dim)


def downsample(fn: Callable, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """``fn(x)``, a 2×2 stride-2 pool: local on an even number of sharded
    rows; on odd ones gathered, the output whole."""
    sh = _current.get()
    if sh is None:
        return fn(x)
    if sh.sharded(x, dim) and x.shape[dim] % 2 == 0:
        return fn(x)
    return fn(gather_height(x, dim) if sh.sharded(x, dim) else x)


def count(x: torch.Tensor, dims: Sequence[int], dim: int = 1) -> int:
    """The number of elements over ``dims`` of ``x`` with its global height."""
    shape = global_shape(x, dim)
    n = 1
    for d in dims:
        n *= shape[d]
    return n


def mean(t: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The mean of all of ``t``'s elements, over all of H on sharded rows."""
    if not is_sharded(t, dim):
        return torch.mean(t)
    s = all_reduce_stats(t.sum().reshape(1))
    return (s / count(t, range(t.dim()), dim))[0]


def draw(fn: Callable, shape: Sequence[int], dim: int = 1, **kw) -> torch.Tensor:
    """``rows.draw(fn, shape)`` for a local ``shape`` whose ``dim`` axis is
    this rank's rows of H: the global height is drawn and this rank's block
    of its rows returned, so the rows equal a single process's."""
    sh = _current.get()
    if sh is None:
        return rows.draw(fn, shape, **kw)
    shape = list(shape)
    h = shape[dim]
    shape[dim] = h * sh.size
    return rows.draw(fn, shape, **kw).narrow(dim, sh.rank * h, h)
