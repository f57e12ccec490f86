"""Device meshes and the movement of rows and weights over them (port of
``eda_dm_tpu/parallel/mesh.py``).

JAX puts a global array on a mesh with a sharding; here each rank holds
its part and the functions below are the collectives that stand for those
placements:

* :func:`make_mesh`: a 1-D ``dp`` mesh over the ranks
  (``init_device_mesh``; the process group is started by
  ``launch.spawn``);
* :func:`shard_batch`: this rank's contiguous block of rows, in JAX's
  device order (rank r holds rows ``[r·b, (r+1)·b)``);
* :func:`replicate`: a broadcast from the mesh's first rank, so that every
  rank holds the same weights and quant state;
* :func:`gather_batch`: the rows gathered back in rank order, what reading
  a sharded global array gives in JAX.

JAX's ``batch_sharding`` (a ``NamedSharding`` object) has no PyTorch
meaning and is not ported: a sharding here is the rows a rank holds.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from . import comm
from .launch import rank_device


def mesh_device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    dev = rank_device()
    if dev is None:
        raise RuntimeError("no device given and not a rank of launch.spawn: "
                           "pass device_type")
    return dev.type


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              device_type: Optional[str] = None) -> DeviceMesh:
    """A 1-D mesh named ``axis`` over the ranks.  ``n_devices`` must be the
    number of ranks (JAX takes the first n devices of one process; here the
    ranks are the devices).  ``device_type`` defaults to the device the
    ranks were started on."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the ranks' process group: start "
                           "them with parallel.launch.spawn")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices over {world} ranks: "
                         "start as many ranks as the mesh has devices")
    return init_device_mesh(mesh_device_type(device_type), (world,),
                            mesh_dim_names=(axis,))


def _dim(mesh: DeviceMesh, axis: str) -> int:
    return mesh.mesh_dim_names.index(axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(_dim(mesh, axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    return mesh.get_local_rank(_dim(mesh, axis))


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(_dim(mesh, axis))


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def shard_batch(mesh: DeviceMesh, tree: Any, axis: str = "dp") -> Any:
    """Every tensor's block of leading-axis rows for this rank of
    ``axis``; the rows must divide evenly, as JAX's sharding requires."""
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)

    def take(x):
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not shard evenly over "
                             f"{n} devices")
        b = x.shape[0] // n
        return x[r * b:(r + 1) * b]
    return _map(take, tree)


def gather_batch(mesh: DeviceMesh, tree: Any, axis: str = "dp") -> Any:
    """Every tensor's rows from all ranks of ``axis``, in rank order."""
    group = axis_group(mesh, axis)
    return _map(lambda x: comm.all_gather(x, group), tree)


@torch.no_grad()
def replicate(mesh: DeviceMesh, tree: Any) -> Any:
    """Every rank's copy made equal to the first rank's: a module's
    parameters and buffers in place (returns the module), or a tree of
    tensors (returns the broadcast copies)."""
    group = mesh.get_group(0) if mesh.ndim == 1 else dist.group.WORLD
    if isinstance(tree, torch.nn.Module):
        comm.broadcast_many_([t.data for t in tree.state_dict(keep_vars=True).values()
                              if isinstance(t, torch.Tensor)], group)
        return tree
    return _map(lambda x: comm.broadcast_(x.clone(), group), tree)
