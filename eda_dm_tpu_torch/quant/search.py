"""MSE (L^2.4) quantization-range search (port of ``eda_dm_tpu/quant/search.py``).

Plain functions on tensors; no kernel.  The 1-D search scores every
candidate threshold at once (a candidate axis); the 2-D search loops over
ranges and, inside, over chunks of zero-points, in the JAX package's scan
order, keeping the earlier candidate on a tie (strict ``<``).  Where the
JAX package branches on a traced value with ``lax.cond``, the port
branches on the host.  ``torch.round`` rounds half to even and
``torch.argmin`` returns the first minimum, as their JAX counterparts do.
A division by a constant is a product with the constant's float32
reciprocal (:func:`_recip`): XLA compiles the JAX package's jitted
divisions so, and the candidate grids then agree bit for bit.

Over a batch sharded across ranks (``parallel/rows.py``) the per-tensor
activation search takes a ``group``, and each decision is the global
batch's: the side from all-reduced extremes, the histogram's counts summed
over the ranks on the shared grid of the global range (exact, so bit-equal
to one process), and the plain search (at most 4·``bins`` elements) on the
all-gathered tensor.  Without a group every function is the
single-process one.

One-side-distribution codes (sticky across calibration batches):
    0 = unset, 1 = 'pos', 2 = 'neg', 3 = 'no' (two-sided).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import comm
from .affine import EPS

SEARCH_P = 2.4  # L_p exponent used by every scale search

ONE_SIDE_UNSET, ONE_SIDE_POS, ONE_SIDE_NEG, ONE_SIDE_NO = 0, 1, 2, 3


def _extremes(x: torch.Tensor, group=None):
    """(min, max) of ``x``, over every rank's part with a ``group``."""
    lo, hi = torch.amin(x), torch.amax(x)
    if comm.size(group) > 1:
        lo, hi = comm.all_reduce_(lo, "min", group), comm.all_reduce_(hi, "max", group)
    return lo, hi


def detect_one_side(x: torch.Tensor, group=None) -> torch.Tensor:
    """Classify the distribution of ``x`` (whole tensor, even channel-wise)
    as an int32 code."""
    lo, hi = _extremes(x, group)
    code = (ONE_SIDE_POS if bool(lo >= 0.0) else
            ONE_SIDE_NEG if bool(hi <= 0.0) else ONE_SIDE_NO)
    return torch.tensor(code, dtype=torch.int32, device=x.device)


def _recip(c: int) -> float:
    """``1/c`` rounded once to float32."""
    return torch.tensor(float(c), dtype=torch.float32).reciprocal().item()


def _pinned_qparams(new_min, new_max, n_levels: int):
    """(scale, zero-point) of windows, the symmetric boundary pinned to
    ``n_levels // 2``: ``calculate_qparams`` of windows that contain 0."""
    scale = torch.clamp((new_max - new_min) * _recip(n_levels - 1), min=EPS)
    zp = torch.clamp(torch.round(-new_min / scale), 0.0, n_levels - 1)
    zp = torch.where(torch.clamp(new_min, max=0.0) == -torch.clamp(new_max, min=0.0),
                     torch.full_like(zp, n_levels // 2), zp)
    return scale, zp


def range_qparams(x_min, x_max, n_levels: int):
    """``calculate_qparams`` of a searched range as the jitted JAX package
    computes it: the range widened to include 0, its division by
    ``n_levels − 1`` a product with the float32 reciprocal."""
    return _pinned_qparams(torch.clamp(x_min, max=0.0),
                           torch.clamp(x_max, min=0.0), n_levels)


def _score(x_flat: torch.Tensor, new_min: torch.Tensor, new_max: torch.Tensor,
           n_levels: int) -> torch.Tensor:
    """L^2.4 error of quantizing ``x_flat`` (*, K) to range (new_min,
    new_max) (*,); candidate and channel axes lead, the mean runs over the
    trailing axis."""
    scale, zp = (v[..., None] for v in _pinned_qparams(new_min, new_max, n_levels))
    x_int = torch.round(x_flat / scale)
    x_clamped = torch.clamp(x_int, -zp, n_levels - 1 - zp)
    err = torch.abs(x_clamped * scale - x_flat) ** SEARCH_P
    return torch.sum(err, dim=-1) * _recip(err.shape[-1])


def _candidates_1d(x_min, x_max, one_side, n_levels: int, num: int, dtype):
    """The 1-D candidate windows (..., 2·num): thresholds ``xrange·i/num``
    for i in 1..num; two-sided data tries both clip-window alignments
    (zero-point n/2 and n/2 − 1) of each, one-sided data the one window
    twice, as in the JAX package.

    The float32 steps are those XLA compiles the JAX package's jitted grid
    to: ``i·(xrange·(1/num))`` per tensor, ``xrange·(i·(1/num))`` per
    channel, and each window edge ``thres·c`` with the constant
    ``c = (2·(1/(n−1)))·zp`` folded into one float32.
    """
    xrange = torch.maximum(torch.abs(x_min), x_max)
    steps = torch.arange(1, num + 1, dtype=dtype, device=xrange.device)
    if xrange.dim() == 0:
        thres = steps * (xrange * _recip(num))             # (num,)
    else:
        thres = xrange[..., None] * (steps * _recip(num))  # (C, num)
    side = int(one_side)
    if side in (ONE_SIDE_POS, ONE_SIDE_NEG):
        lo = torch.zeros_like(thres) if side == ONE_SIDE_POS else -thres
        hi = torch.zeros_like(thres) if side == ONE_SIDE_NEG else thres
        new_min, new_max = torch.stack([lo, lo], -1), torch.stack([hi, hi], -1)
    else:
        two_r = torch.tensor(2.0 * _recip(n_levels - 1), dtype=torch.float32)
        hi_zp, lo_zp = float(n_levels // 2), float(n_levels // 2 - 1)
        c = [(two_r * v).item() for v in (-hi_zp, -lo_zp, n_levels - 1 - hi_zp,
                                          n_levels - 1 - lo_zp)]
        new_min = torch.stack([thres * c[0], thres * c[1]], -1)
        new_max = torch.stack([thres * c[2], thres * c[3]], -1)
    return (new_min.reshape(*new_min.shape[:-2], 2 * num),
            new_max.reshape(*new_max.shape[:-2], 2 * num))


# elements of one (channels, candidates, K) score tensor: the per-channel
# search scores its channels in chunks below this (SD's 1280×2560×3×3 conv
# would otherwise take 22 GiB a temporary)
SCORE_ELEMS = 1 << 28


def search_range_1d(x_flat: torch.Tensor, n_levels: int, one_side, num: int = 100,
                    x_min: Optional[torch.Tensor] = None,
                    x_max: Optional[torch.Tensor] = None):
    """1-D symmetric/one-sided threshold search.

    ``x_flat``: (K,) per tensor or (C, K) per channel.  Returns (best_min,
    best_max) shaped () or (C,).  ``x_min``/``x_max`` anchor the candidate
    grid when ``x_flat`` is a subsample (by default its own min and max).
    Channels are searched independently, in chunks of at most
    ``SCORE_ELEMS`` scored elements.
    """
    x_min = torch.amin(x_flat, dim=-1) if x_min is None else x_min
    x_max = torch.amax(x_flat, dim=-1) if x_max is None else x_max
    new_min, new_max = _candidates_1d(x_min, x_max, one_side, n_levels, num,
                                      x_flat.dtype)
    rows = (max(1, SCORE_ELEMS // (new_min.shape[-1] * x_flat.shape[-1]))
            if x_flat.dim() == 2 else 1)
    best = []
    for r in range(0, x_flat.shape[0] if x_flat.dim() == 2 else 1, rows):
        part = (slice(r, r + rows),) if x_flat.dim() == 2 else ()
        lo, hi = new_min[part], new_max[part]
        idx = torch.argmin(_score(x_flat[part][..., None, :], lo, hi, n_levels),
                           dim=-1, keepdim=True)
        best.append((torch.take_along_dim(lo, idx, -1)[..., 0],
                     torch.take_along_dim(hi, idx, -1)[..., 0]))
    if len(best) == 1:
        return best[0]
    return torch.cat([b[0] for b in best]), torch.cat([b[1] for b in best])


def _search_2d(score_fn, x_min, x_max, n_levels: int, num: int, zp_chunk: int,
               dtype):
    """The 2-D (range × zero-point) scan shared by both scorings: ranges
    outer, zero-point chunks inner, a strict ``<`` update."""
    x_min = torch.clamp(x_min, max=0.0)
    x_max = torch.clamp(x_max, min=0.0)
    xrange = x_max - x_min
    n_pad = n_levels + (-n_levels) % zp_chunk
    zps = torch.arange(0, n_pad, dtype=dtype, device=xrange.device)
    valid = zps < n_levels
    best_score = torch.full(xrange.shape, float("inf"), dtype=dtype,
                            device=xrange.device)
    best_min, best_max = x_min.to(dtype).clone(), x_max.to(dtype).clone()
    for i in range(1, num + 1):
        tmp_max = xrange * (torch.tensor(i, dtype=dtype) * _recip(num))
        tmp_delta = tmp_max * _recip(n_levels - 1)
        for c0 in range(0, n_pad, zp_chunk):
            zp_vals, ok = zps[c0:c0 + zp_chunk], valid[c0:c0 + zp_chunk]
            nm = -zp_vals * tmp_delta[..., None]
            nx = tmp_max[..., None] - zp_vals * tmp_delta[..., None]
            sc = torch.where(ok, score_fn(nm, nx), float("inf"))
            j = torch.argmin(sc, dim=-1, keepdim=True)
            sc_b = torch.take_along_dim(sc, j, -1)[..., 0]
            upd = sc_b < best_score
            best_score = torch.where(upd, sc_b, best_score)
            best_min = torch.where(upd, torch.take_along_dim(nm, j, -1)[..., 0], best_min)
            best_max = torch.where(upd, torch.take_along_dim(nx, j, -1)[..., 0], best_max)
    return best_min, best_max


def search_range_2d(x_flat: torch.Tensor, n_levels: int, num: int = 100,
                    zp_chunk: int = 16, x_min: Optional[torch.Tensor] = None,
                    x_max: Optional[torch.Tensor] = None):
    """2-D (range × zero-point) search for asymmetric two-sided tensors:
    for each of ``num`` ranges every integer zero-point in [0, n_levels)
    shifts the clipping window; the best (min, max) over all pairs is
    returned.  ``x_min``/``x_max`` anchor the grid for subsampled input."""
    x_min = torch.amin(x_flat, dim=-1) if x_min is None else x_min
    x_max = torch.amax(x_flat, dim=-1) if x_max is None else x_max
    x = x_flat[..., None, :]
    return _search_2d(lambda nm, nx: _score(x, nm, nx, n_levels), x_min, x_max,
                      n_levels, num, zp_chunk, x_flat.dtype)


def search_range(x_flat: torch.Tensor, n_levels: int, one_side, symmetric: bool,
                 num: int = 100, x_min=None, x_max=None, static_side=None):
    """1-D search when the distribution is one-sided or the quantizer
    symmetric, else the 2-D search.  ``static_side`` (a host int, the side
    frozen after the first calibration batch) takes precedence over
    ``one_side``."""
    side = int(one_side) if static_side is None else static_side
    if symmetric or side != ONE_SIDE_NO:
        return search_range_1d(x_flat, n_levels, one_side, num, x_min, x_max)
    return search_range_2d(x_flat, n_levels, num, x_min=x_min, x_max=x_max)


_HIST_CHUNK = 1 << 28      # sort at most 256M elements at a time


def _exact_histogram(x_flat: torch.Tensor, bins: int, group=None):
    """Exact value histogram of a flat tensor by sort and a ``bins + 1``
    edge ``searchsorted`` (left side), in chunks of 2^28 elements against
    the shared global-range edges, counts summed in int32 (with a
    ``group``: the range and the counts over every rank's part).  Returns
    (centers (bins,), counts (bins,) in x's dtype, x_min, x_max)."""
    size = x_flat.shape[-1]
    x_min, x_max = _extremes(x_flat, group)
    span = torch.clamp(x_max - x_min, min=EPS)
    edges = x_min + span * torch.arange(bins + 1, dtype=x_flat.dtype,
                                        device=x_flat.device) * _recip(bins)

    def chunk_counts(part):
        xs = torch.sort(part).values
        idx = torch.searchsorted(xs, edges, right=False)
        c = torch.diff(idx).to(torch.int32)
        c[-1] += part.shape[-1] - int(idx[-1])       # elements equal to x_max
        return c

    if size <= _HIST_CHUNK:
        counts = chunk_counts(x_flat)
    else:
        counts = torch.zeros((bins,), dtype=torch.int32, device=x_flat.device)
        for start in range(0, size, _HIST_CHUNK):
            counts = counts + chunk_counts(x_flat[..., start:start + _HIST_CHUNK])
    comm.all_reduce_(counts, "sum", group)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, counts.to(x_flat.dtype), x_min, x_max


def _score_hist(centers: torch.Tensor, counts: torch.Tensor, new_min: torch.Tensor,
                new_max: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Histogram-weighted :func:`_score` (same candidate arithmetic)."""
    scale, zp = (v[..., None] for v in _pinned_qparams(new_min, new_max, n_levels))
    x_int = torch.round(centers / scale)
    x_clamped = torch.clamp(x_int, -zp, n_levels - 1 - zp)
    err = torch.abs(x_clamped * scale - centers) ** SEARCH_P * counts
    return torch.sum(err, dim=-1) / torch.clamp(torch.sum(counts), min=1.0)


def search_range_1d_hist(x_flat: torch.Tensor, n_levels: int, one_side,
                         num: int = 100, bins: int = 4096, group=None):
    """1-D search scored on an exact histogram (per-tensor activations),
    on :func:`search_range_1d`'s candidate grid."""
    if x_flat.dim() != 1:
        raise ValueError("histogram search is per-tensor")
    centers, counts, x_min, x_max = _exact_histogram(x_flat, bins, group)
    new_min, new_max = _candidates_1d(x_min, x_max, one_side, n_levels, num,
                                      x_flat.dtype)
    idx = torch.argmin(_score_hist(centers, counts, new_min, new_max, n_levels))
    return new_min[idx], new_max[idx]


def search_range_2d_hist(x_flat: torch.Tensor, n_levels: int, num: int = 100,
                         bins: int = 4096, zp_chunk: int = 16, group=None):
    """2-D search scored on an exact histogram (mirrors
    :func:`search_range_2d`)."""
    if x_flat.dim() != 1:
        raise ValueError("histogram search is per-tensor")
    centers, counts, x_min, x_max = _exact_histogram(x_flat, bins, group)
    return _search_2d(lambda nm, nx: _score_hist(centers, counts, nm, nx, n_levels),
                      x_min, x_max, n_levels, num, zp_chunk, x_flat.dtype)


def search_range_hist(x_flat: torch.Tensor, n_levels: int, one_side,
                      symmetric: bool, num: int = 100, bins: int = 4096,
                      static_side=None, group=None):
    """Histogram-scored dispatch mirroring :func:`search_range`."""
    side = int(one_side) if static_side is None else static_side
    if symmetric or side != ONE_SIDE_NO:
        return search_range_1d_hist(x_flat, n_levels, one_side, num, bins,
                                    group=group)
    return search_range_2d_hist(x_flat, n_levels, num, bins, group=group)


def channelwise_view(x: torch.Tensor, channel_axis: int) -> torch.Tensor:
    """Flatten ``x`` to (C, K) with the quantization-channel axis leading."""
    x = torch.movedim(x, channel_axis, 0)
    return x.reshape(x.shape[0], -1)


def weight_qparams(w: torch.Tensor, n_levels: int, symmetric: bool,
                   channel_axis: Optional[int], num: int = 100,
                   always_zero: bool = False):
    """One-shot (delta, zero_point) for a weight tensor: per-channel MSE
    search on the parameter itself when ``channel_axis`` is given (arrays
    shaped to broadcast against ``w``), else per tensor (scalars).  The
    range becomes (Δ, zp) as ``calculate_qparams`` does, its division by
    ``n_levels − 1`` a product with the reciprocal, as in the jitted JAX
    function."""
    flat = w.reshape(-1) if channel_axis is None else channelwise_view(w, channel_axis)
    one_side = detect_one_side(w)
    best_min, best_max = search_range(flat, n_levels, one_side, symmetric, num)
    delta, zp = range_qparams(best_min, best_max, n_levels)
    if always_zero:
        zp = torch.zeros_like(delta)
    if channel_axis is not None:
        shape = [1] * w.dim()
        shape[channel_axis] = w.shape[channel_axis]
        delta, zp = delta.reshape(shape), zp.reshape(shape)
    return delta, zp
