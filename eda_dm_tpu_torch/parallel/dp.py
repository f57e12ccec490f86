"""Data-parallel activation calibration, sampling and reconstruction (port
of ``eda_dm_tpu/parallel/dp.py``).

The batch axis is sharded over a 1-D ``dp`` mesh (``mesh.make_mesh``);
weights and quant state are replicated.  JAX traces the global shapes and
lets XLA all-reduce the statistics; here every rank runs its rows inside
``rows.sharded_rows``, so that:

* activation calibration: each quantizer's side, range and histogram
  counts are the global batch's (``quant/search.py``), and the state is
  bit-equal to one process's;
* sampling: each rank draws the global batch's noise and keeps its rows,
  and the attention dispatch takes the global batch (``parallel/rows.py``);
* reconstruction: the calibration rows and the captures row-sharded, the
  same rows, masks and loss, the gradients summed over the ranks
  (``calib/recon.py``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn as nn

from ..calib.scale_init import host_sides
from ..quant.config import CALIB_A
from . import rows
from .mesh import axis_group, axis_size, gather_batch, replicate, shard_batch


@torch.no_grad()
def dp_calibrate_acts(model: nn.Module, cali_data: Sequence[torch.Tensor], mesh,
                      batch_size=None, axis: str = "dp") -> nn.Module:
    """``set_act_quantize_params`` with the batch sharded over ``axis``;
    updates the model in place and returns it.

    As in the JAX package, a batch size above the mesh size is rounded
    down to a multiple of it, and a batch that does not shard evenly (the
    tail) is padded by cyclic row repetition to the next multiple: the
    repeated rows leave the batch's range unchanged and re-weight at most
    n − 1 rows of its score.  For asymmetric configs the sides found on the
    first batch are passed to the later ones as ``static_sides``, as the
    single-process path does (the same values: a side is sticky)."""
    n = cali_data[0].shape[0]
    bs = min(batch_size or n, n)
    n_dev = axis_size(mesh, axis)
    if bs > n_dev:
        bs -= bs % n_dev
    replicate(mesh, model)
    group = axis_group(mesh, axis)
    mode = CALIB_A
    aq = getattr(getattr(model, "qc", None), "aq", None)
    hoist = aq is not None and not aq.symmetric
    for start in range(0, n, bs):
        batch = tuple(a[start:start + bs] for a in cali_data)
        r = batch[0].shape[0]
        if r % n_dev:
            pad = torch.arange(-(-r // n_dev) * n_dev, device=batch[0].device) % r
            batch = tuple(a[pad.to(a.device)] for a in batch)
        with rows.sharded_rows(group):
            model(*shard_batch(mesh, batch, axis), mode=mode)
        if hoist and mode.static_sides is None:
            mode = mode.replace(static_sides=host_sides(model))
    return model


@torch.no_grad()
def dp_sample(sample_fn: Callable, model: nn.Module, x_T: torch.Tensor,
              generator, mesh, axis: str = "dp") -> torch.Tensor:
    """``sample_fn(model, x_T, generator)`` with the batch sharded over
    ``axis``: every rank passes the same global ``x_T`` and generator
    state, runs its rows and gets the global samples back (gathered in
    rank order, which is what reading JAX's sharded result gives)."""
    replicate(mesh, model)
    with rows.sharded_rows(axis_group(mesh, axis)):
        out = sample_fn(model, shard_batch(mesh, x_T, axis), generator)
    return gather_batch(mesh, out, axis)


def dp_reconstruct(model: nn.Module, cali_data: Sequence[torch.Tensor], plan, args,
                   generator, mesh, **kw) -> nn.Module:
    """Data-parallel AdaRound/FBR reconstruction over the plan: the single
    process's semantics (the same minibatch rows, input mixing and QDrop
    masks, the gradients of the global mean loss); results match it up to
    float32 summation order.  Every rank passes the global calibration set;
    ``reconstruct`` keeps its contiguous block of the rows
    (``mesh.shard_batch``, as JAX's ``dp.py`` shards it), and its captures
    hold that block of each group's rows (``calib/recon.py``).
    ``args.batch_size`` and the row count must divide over the mesh, so
    that each rank computes an equal block of the minibatch and holds an
    equal block of the rows."""
    from ..calib.recon import reconstruct
    n_dev = axis_size(mesh, "dp")
    if args.batch_size % n_dev:
        raise ValueError(
            f"recon batch_size {args.batch_size} must divide the dp mesh "
            f"size {n_dev}")
    replicate(mesh, model)
    return reconstruct(model, cali_data, plan, args, generator, mesh=mesh, **kw)
