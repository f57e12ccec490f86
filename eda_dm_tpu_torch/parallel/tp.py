"""Tensor- and spatial-parallel serving (port of ``eda_dm_tpu/parallel/tp.py``).

JAX annotates each parameter's output axis with a ``tp`` sharding and
lets GSPMD place the collectives.  Here :func:`shard_params_tp` cuts every
``QConv`` / ``QDense`` whose output axis divides (JAX's rule,
:func:`tp_spec`) down to this rank's block of output channels: the float
weight and bias, the weight quantizer's Δ / zp and AdaRound alphas, the
int8 codes and their sums (the int8 epilogue's per-channel state), so
every mode and every export serves from the slice.  The layer then
all-gathers its output along the channel axis; norms, the per-tensor act
quantizers and attention run on the gathered activation, as on one
device.  Under DEPLOY_INT8 each output channel's int32 sum and float32
epilogue are those of the unsharded layer, so the sharded forward equals
the single-process one bit for bit.  The gather carries no gradient: tp is
for serving.

:func:`shard_spatial` splits an activation's height over the ``tp`` axis
(JAX: the 256²/512² VAE decode's memory-bound stages).  Without GSPMD the
layers do the partitioning themselves inside ``with
spatial.sharded_height(group):`` (``parallel/spatial.py``: the halo
exchange of every 3×3 and stride-2 conv, the norms' statistics over all
ranks, a gather around every attention); :func:`gather_spatial` puts the
rows back together::

    mesh = make_mesh2d(1, n)
    with spatial.sharded_height(axis_group(mesh, "tp")):
        out = model(shard_spatial(mesh, x), t, mode)
    y = gather_spatial(mesh, out)
"""

from __future__ import annotations

import copy
from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..nn.layers import QConv, QDense
from . import comm, rows
from .mesh import (mesh_device_type, axis_group, axis_rank, axis_size, gather_batch,
                   replicate, shard_batch)


def make_mesh2d(n_dp: int, n_tp: int, axes: Tuple[str, str] = ("dp", "tp"),
                device_type=None) -> DeviceMesh:
    """A 2-D (dp, tp) mesh over ``n_dp · n_tp`` ranks, tp the inner axis
    (ranks ``[d·n_tp, (d+1)·n_tp)`` share the rows of dp group d)."""
    world = dist.get_world_size()
    if n_dp * n_tp != world:
        raise ValueError(f"a {n_dp}×{n_tp} mesh over {world} ranks")
    return init_device_mesh(mesh_device_type(device_type), (n_dp, n_tp),
                            mesh_dim_names=tuple(axes))


def tp_spec(shape: Sequence[int], tp_size: int, axis: str = "tp",
            min_shard: int = 2) -> tuple:
    """JAX's rule on a JAX-layout shape, as a PartitionSpec tuple: the
    output axis is the last one of every parameter (conv kernels (H, W,
    C_in, C_out), dense kernels (C_in, C_out), per-channel vectors (C,));
    scalars, indivisible axes and shards under ``min_shard`` replicate
    (``()``)."""
    if len(shape) == 0:
        return ()
    last = shape[-1]
    if last % tp_size or last // tp_size < min_shard:
        return ()
    return (None,) * (len(shape) - 1) + (axis,)


def _jax_shape(weight: torch.Tensor) -> tuple:
    """The JAX layout of a port weight: [Cout, Cin, kh, kw] → (kh, kw, Cin,
    Cout); [out, in] → (in, out)."""
    s = tuple(weight.shape)
    return s[2:] + (s[1], s[0]) if len(s) == 4 else (s[1], s[0])


def _gather_hook(group):
    def hook(module, args, out):
        return comm.all_gather(out, group, dim=-1)
    return hook


@torch.no_grad()
def _shard_layer(m, rank: int, size: int, group) -> None:
    c = m.features // size
    sl = slice(rank * c, (rank + 1) * c)
    m.weight.data = m.weight.data[sl].contiguous()
    if m.bias is not None:
        m.bias.data = m.bias.data[sl].contiguous()
    for part, _, _ in m._parts:
        for leaf in ("delta", "zp", "alpha", "int", "isum"):
            t = getattr(m, f"{part}_{leaf}")
            # (1,) alpha placeholders of a lean export stay as they are
            if t is not None and t.shape[0] == m.features:
                setattr(m, f"{part}_{leaf}", t[sl].contiguous())
    m.features = c
    if isinstance(m, QConv):
        m._border_cache.clear()
    m.tp_shard = (rank, size)
    m.register_forward_hook(_gather_hook(group))


def shard_params_tp(mesh: DeviceMesh, model: nn.Module, axis: str = "tp",
                    min_shard: int = 2) -> nn.Module:
    """Cut every quantized layer whose output axis :func:`tp_spec` shards
    to this rank's output channels, in place (see the module docstring);
    returns the model."""
    size, rank, group = axis_size(mesh, axis), axis_rank(mesh, axis), axis_group(mesh, axis)
    if size == 1:
        return model
    for m in model.modules():
        if (isinstance(m, (QConv, QDense))
                and tp_spec(_jax_shape(m.weight), size, axis, min_shard)):
            _shard_layer(m, rank, size, group)
    return model


def shard_spatial(mesh: DeviceMesh, x: torch.Tensor, axis: str = "tp",
                  dim: int = 1) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s ``dim`` (H of NHWC by
    default) over the mesh axis ``axis``; the axis must divide evenly."""
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} rows of dim {dim} do not shard evenly "
                         f"over {n} devices")
    h = x.shape[dim] // n
    return x.narrow(dim, r * h, h)


def gather_spatial(mesh: DeviceMesh, x: torch.Tensor, axis: str = "tp",
                   dim: int = 1) -> torch.Tensor:
    """The inverse of :func:`shard_spatial`: every rank's block of ``dim``
    in rank order."""
    return comm.all_gather(x, axis_group(mesh, axis), dim=dim)


def tp_layers(model: nn.Module) -> List[str]:
    """Names of the layers :func:`shard_params_tp` cut."""
    return [n for n, m in model.named_modules() if hasattr(m, "tp_shard")]


@torch.no_grad()
def tp_sample(sample_fn: Callable, model: nn.Module, x_T: torch.Tensor, generator,
              mesh: DeviceMesh, dp_axis: str = "dp", tp_axis: str = "tp"):
    """``sample_fn(model, x_T, generator)`` with the batch over ``dp_axis``
    and the parameters over ``tp_axis``, on a sharded copy of the model
    (the caller's stays whole).  Every rank passes the same global ``x_T``
    and generator state and gets the global samples back."""
    model = replicate(mesh, copy.deepcopy(model))
    shard_params_tp(mesh, model, tp_axis)
    with rows.sharded_rows(axis_group(mesh, dp_axis)):
        out = sample_fn(model, shard_batch(mesh, x_T, dp_axis), generator)
    return gather_batch(mesh, out, dp_axis)
