"""Fused softmax → int8 codes (kernel K3).

Port of ``eda_dm_tpu/ops/pallas_softmax.py::softmax_int8_codes``:

    w = softmax(logits, axis=-1)                       # f32
    q = clip(round(w / delta), -zp, n_levels - 1 - zp)
    codes = q - (n_levels/2 - zp)                      # centered, int8

On a CUDA tensor :func:`softmax_int8_codes` launches
``csrc/softmax_codes.cu`` under the plan of :func:`softmax_plan` (threads a
row, elements a thread, rows a tile); on a CPU tensor it runs the plain
version.  The kernel reads each row once and writes its int8 codes once
(bound on the card: bytes, 5 per float32 element).  It computes what the
plain version computes, operation by operation: libdevice's ``expf``
(PyTorch's ``exp`` on the card), IEEE divisions, and the row sum added in
float64 and rounded once to float32, so that it does not depend on the
order of the reduction (the JAX package adds in float32, in XLA's order).
A code may still flip by one where ``exp`` on the host differs from the
card's, or where the f64 sums of two orders straddle an f32 rounding
boundary.  Logits may be float32 or bfloat16 (upcast in the kernel, as
the JAX kernel upcasts them).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ._build import check_launch, cuda_lib, launch_counts, ptr, stream_ptr
from .gn_int8 import BLOCK_SMEM_MAX
from .int8_einsum import quantize_act_int8
from .serving_policy import use_fused_softmax

# the plan's entries, in the order the kernel's entry point takes them
K3_PLAN_ARGS = ("tpr", "nmax", "rows", "buffers", "threads", "smem")
_K3_SIG = {"edm_softmax_codes": [ctypes.c_void_p] * 4 + [ctypes.c_int] * (4 + len(K3_PLAN_ARGS))
           + [ctypes.c_void_p],
           "edm_softmax_check_arith": [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                                              ctypes.c_void_p]}
# K3's fixed sizes (``csrc/softmax_codes.cu``, held equal by a test): threads
# a block, and below the widest element count; the elements a thread may
# hold (a template constant each)
K3_MAX_THREADS = 1024
K3_WIDE_THREADS = 256
K3_NMAX = (1, 2, 4, 6, 8, 10, 12, 16, 24, 32)
# the plan's choices: the elements a thread aims at (so that a row's
# reductions are shared by about 16 of them); the least threads a row (four
# rows of 16-byte vectors fill a warp's banks); the tile a block aims at
# (two in flight); the tiles that fill the card (two an SM of the H100's
# 132; timed by probes/softmax_plans.py, PERF.md §6)
K3_PER_THREAD = 16
K3_MIN_TPR = 4
K3_TILE_BYTES = 16 * 1024
K3_MIN_BLOCKS = 264
_WARPS_MAX = K3_MAX_THREADS // 32


def _pow2(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def k3_stride(s: int, esz: int, tpr: int) -> int:
    """The tile's row stride in elements (the kernel's ``k3_stride``): S,
    or for float32 rows of whole 16-byte vectors that share a warp, S padded
    to tpr words past a multiple of 32."""
    return s + (tpr - s) % 32 if esz == 4 and s % 4 == 0 and tpr < 32 else s


def k3_smem_bytes(rows: int, s: int, esz: int, tpr: int, buffers: int) -> int:
    """K3's dynamic shared bytes (the kernel's ``k3_layout``): ``buffers``
    tiles in the input's dtype at :func:`k3_stride` and the codes, each
    shifted by up to 15 bytes, the warps' f32 row maxima and f64 row sums,
    and a dump byte (16)."""
    tile = (rows * k3_stride(s, esz, tpr) * esz + 31) // 16 * 16
    return buffers * tile + (rows * s + 31) // 16 * 16 + _WARPS_MAX * 12 + 16


def k3_launch_plan(r: int, s: int, esz: int, per_thread: int = K3_PER_THREAD,
                   tile_bytes: int = K3_TILE_BYTES) -> dict:
    """K3's launch for ``r`` rows of ``s`` elements of ``esz`` bytes, aiming
    at ``per_thread`` elements a thread and ``tile_bytes`` a tile
    (:func:`softmax_plan` takes the defaults)."""
    if s > K3_MAX_THREADS * K3_NMAX[-1]:
        raise ValueError(f"softmax_int8_codes: rows of {s} exceed the kernel's "
                         f"{K3_MAX_THREADS * K3_NMAX[-1]} elements")
    tpr = min(_pow2(s), max(K3_MIN_TPR, _pow2(-(-s // per_thread))))
    if s > K3_WIDE_THREADS * K3_NMAX[-1]:    # past a block of the widest threads
        tpr, nmax = _pow2(-(-s // K3_NMAX[-1])), K3_NMAX[-1]
    else:
        tpr = min(tpr, K3_WIDE_THREADS)
        nmax = next(n for n in K3_NMAX if n * tpr >= s)
    threads = max(K3_WIDE_THREADS, tpr)
    rpi = threads // tpr
    rows = max(1, tile_bytes // (k3_stride(s, esz, tpr) * esz) // rpi) * rpi
    filling = -(-r // K3_MIN_BLOCKS)                # rows a tile at K3_MIN_BLOCKS tiles
    rows = min(rows, -(-filling // rpi) * rpi)
    buffers = 2 if k3_smem_bytes(rows, s, esz, tpr, 2) <= BLOCK_SMEM_MAX else 1
    return dict(tpr=tpr, nmax=nmax, rows=rows, buffers=buffers, threads=threads,
                smem=k3_smem_bytes(rows, s, esz, tpr, buffers))


@functools.lru_cache(maxsize=None)
def softmax_plan(r: int, s: int, dtype: torch.dtype = torch.float32) -> dict:
    """K3's launch plan for ``r`` rows of ``s`` logits of ``dtype``:

    * ``tpr`` threads a row: the power of two that leaves each about
      ``K3_PER_THREAD`` elements, at least ``K3_MIN_TPR`` (at most S), at
      most a block of ``K3_WIDE_THREADS``; rows past that block's 32
      elements a thread take up to 1024 threads;
    * ``nmax`` elements a thread, the least of ``K3_NMAX`` with
      tpr·nmax ≥ S;
    * ``threads`` a block, ``K3_WIDE_THREADS`` or the row's;
    * ``rows`` a tile: whole iterations of threads / tpr rows, filling
      ``K3_TILE_BYTES``, or fewer where the tiles would number under
      ``K3_MIN_BLOCKS``;
    * ``buffers``: 2 (a persistent grid whose blocks walk the tiles, the
      next one loading under this one) where two tiles fit a block's shared
      memory, else 1 (a block a tile);
    * ``smem``, the dynamic shared bytes.

    Cached, so a launch pays no search.  Raises past 32,768 elements a row."""
    return k3_launch_plan(r, s, torch.empty((), dtype=dtype).element_size())


def softmax_int8_codes_plain(logits: torch.Tensor, delta: torch.Tensor,
                             zp: torch.Tensor, n_levels: int) -> torch.Tensor:
    x = logits.float()
    e = torch.exp(x - x.amax(-1, keepdim=True))
    w = e / e.double().sum(-1, keepdim=True).float()
    q = torch.clamp(torch.round(w / delta), -zp, float(n_levels - 1) - zp)
    return (q - (n_levels / 2 - zp)).to(torch.int8)


def _softmax_codes_cuda(logits, delta, zp, n_levels):
    dev = logits.device
    if logits.dtype not in (torch.float32, torch.bfloat16) or logits.numel() == 0:
        raise ValueError(f"softmax_int8_codes takes non-empty float32 or bfloat16 logits, "
                         f"not {logits.dtype} {tuple(logits.shape)}")
    for t, what in ((delta, "delta"), (zp, "zp")):
        if t.numel() != 1 or t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{what} must be a float32 scalar on {dev}")
    s = logits.shape[-1]
    x = logits.contiguous().reshape(-1, s)
    r = x.shape[0]
    plan = softmax_plan(r, s, x.dtype)
    out = torch.empty((r, s), dtype=torch.int8, device=dev)
    lib = cuda_lib("softmax_codes", _K3_SIG)
    err = lib.edm_softmax_codes(
        ptr(x), ptr(delta), ptr(zp), ptr(out), int(x.dtype == torch.bfloat16), r, s,
        n_levels, *(plan[k] for k in K3_PLAN_ARGS), stream_ptr(dev))
    check_launch(lib, err, "softmax_codes")
    launch_counts["softmax_codes"] += 1
    return out.reshape(logits.shape)


def softmax_check_arith(sigma: float, delta: float, zp: float, n_levels: int,
                        device="cuda") -> dict:
    """K3's divisions against IEEE's on the card (test use; the kernel
    library's ``edm_softmax_check_arith``): at every float e in [0, 1],
    how many quotients e/σ on the fast path (e ≥ 2⁻⁸⁰) differ from
    ``__fdiv_rn``'s, and how many codes differ from those of ``__fdiv_rn``
    → ``__fdiv_rn`` → ``rintf`` with this quantizer (0 each expected)."""
    bad = torch.zeros(2, dtype=torch.int64, device=device)
    lib = cuda_lib("softmax_codes", _K3_SIG)
    check_launch(lib, lib.edm_softmax_check_arith(sigma, delta, zp, n_levels, ptr(bad),
                                                  stream_ptr(bad.device)),
                 "softmax_check_arith")
    return dict(zip(("quotients", "codes"), bad.tolist()))


def softmax_int8_codes(logits: torch.Tensor, delta: torch.Tensor,
                       zp: torch.Tensor, n_levels: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax over the last axis, quantized to centered int8 codes.
    Returns ``(codes, c)`` with ``(codes + c)·delta == fake_quant(softmax)``.
    On a CUDA tensor this launches kernel K3; on a CPU tensor it runs the
    plain version."""
    if n_levels > 256:
        raise ValueError("int8 codes require sm_abit <= 8")
    if logits.is_cuda:
        codes = _softmax_codes_cuda(logits, delta, zp, n_levels)
    elif logits.device.type == "cpu":
        codes = softmax_int8_codes_plain(logits, delta, zp, n_levels)
    else:
        raise ValueError(f"softmax_int8_codes: unsupported device {logits.device}")
    return codes, n_levels / 2 - zp


def softmax_codes(logits: torch.Tensor, delta: torch.Tensor, zp: torch.Tensor,
                  n_levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The einsum attention branch's softmax → ``(codes, c)``, chosen as the
    JAX package's attention sites choose it: :func:`softmax_int8_codes`
    unless ``EDM_FUSED_SOFTMAX=0``, then a float32 softmax in
    ``jax.nn.softmax``'s steps (``exp(x − max) / Σ``) quantized by
    ``quantize_act_int8``."""
    if use_fused_softmax():
        return softmax_int8_codes(logits, delta, zp, n_levels)
    x = logits.float()
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return quantize_act_int8(e / e.sum(-1, keepdim=True), delta, zp, n_levels)
