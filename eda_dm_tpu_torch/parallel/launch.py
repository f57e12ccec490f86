"""Start one process a rank (the port's runner; JAX runs one process over
all its devices and has no counterpart).

``spawn(fn, world_size, backend, device, *args)`` runs
``fn(rank, world_size, device, *args)`` in ``world_size`` processes
started by ``torch.multiprocessing`` and returns their return values in
rank order (tensors come back on the host).  The ranks meet through a
``FileStore`` in a temporary directory, never a TCP port: parallel test
workers would collide on one.

* ``backend`` is the caller's: ``"nccl"`` takes one card a rank
  (``cuda:rank``; it raises with fewer cards than ranks), ``"gloo"`` takes
  the host or ranks that share cards (``cuda:rank % cards``).  Neither is
  switched for the other.
* A rank started on ``"cuda"`` finds a card or raises.
* Each rank takes its share of the parent's CPU threads (or ``threads``).
* The ranks load the kernels the parent built (``ops/_build.py``) and
  never build one: ``EDM_NO_KERNEL_BUILD=1`` makes a missing one an error.
* An exception in any rank ends every rank and is raised in the parent
  with the rank's traceback.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the device the ranks of this process tree were started on
_device: Optional[torch.device] = None


def rank_device() -> Optional[torch.device]:
    """The device ``spawn`` gave this rank (None outside a spawned rank)."""
    return _device


def _host(v: Any) -> Any:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if isinstance(v, dict):
        return {k: _host(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_host(x) for x in v)
    return v


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str,
               device: str, store_dir: str, threads: int, timeout_s: float,
               args: tuple) -> None:
    global _device
    torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: device 'cuda' requested but no CUDA device")
        cards = torch.cuda.device_count()
        if backend == "nccl" and cards < world_size:
            raise RuntimeError(f"nccl takes one card a rank: {world_size} ranks, "
                               f"{cards} cards (use gloo for ranks that share one)")
        dev = torch.device("cuda", rank % cards)
        torch.cuda.set_device(dev)
    _device = dev
    store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world_size, dev, *args)
        torch.save(_host(out), os.path.join(store_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, backend: str, device, *args,
          timeout_s: float = 600.0, threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(rank, world_size, device, *args)`` on ``world_size`` ranks
    (``fn`` and ``args`` must pickle: a module-level function).  Each rank
    runs PyTorch's CPU ops on ``threads`` threads (default: its share of
    this process's).  Returns the ranks' return values in rank order."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    dev = torch.device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend takes card tensors: device='cuda'")
    threads = threads or max(1, torch.get_num_threads() // world_size)
    old = os.environ.get("EDM_NO_KERNEL_BUILD")
    os.environ["EDM_NO_KERNEL_BUILD"] = "1"
    try:
        with tempfile.TemporaryDirectory(prefix="edm_ranks_") as d:
            mp.start_processes(_rank_main, nprocs=world_size, join=True,
                               start_method="spawn",
                               args=(fn, world_size, backend, str(dev), d, threads,
                                     timeout_s, args))
            return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                    for r in range(world_size)]
    finally:
        if old is None:
            os.environ.pop("EDM_NO_KERNEL_BUILD", None)
        else:
            os.environ["EDM_NO_KERNEL_BUILD"] = old
