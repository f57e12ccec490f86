"""Fused GroupNorm (+swish) (+int8 act quantize and pad) (kernel K6).

Port of ``eda_dm_tpu/ops/pallas_gn.py`` (``gn_swish_int8``, ``gn_norm``).
Per (batch element, group of g = C / 32 channels), in float32:

    μ    = Σx / (hw·g)
    σ²   = Σ(x − μ)² / (hw·g)                  (two-pass variance)
    inv  = 1 / sqrt(σ² + eps)
    y    = (x − μ)·(inv·scale) + bias          (scale folded into inv first)
    y    = y·sigmoid(y)                        (optional swish)

``gn_swish_int8`` quantizes y, from float32, to centered int8 act codes
``clip(round(y/Δ), −zp, L−1−zp) − (L/2 − zp)`` and writes them already
padded, the rim holding the code of 0 (−c), so the next conv (K1) runs
VALID over them with no border correction.  ``gn_norm`` returns y in the
input's dtype, for norms with several consumers (attention input,
``norm_out``).

Both sums are taken in float64 and rounded once to float32 before the
float32 division by the count, so the statistics do not depend on the
order in which the kernel's threads add (the JAX kernel adds in float32,
in XLA's order).  Every later step is one IEEE float32 operation in the
order above, ``1/sqrt`` as a division by a square root and sigmoid as
``1/(1 + exp(−y))``: the kernel and the plain version run the same
operations, and the kernel contracts none of them into an FMA.

On a CUDA tensor the functions launch ``csrc/gn_int8.cu`` under the plan
of :func:`gn_plan` (the tile's span of groups, the blocks of a cluster, the
pixels and threads of a block); on a CPU tensor they run the plain version.
Activations are NHWC.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from ..utils.run import span
from ._build import check_launch, cuda_lib, launch_counts, ptr, stream_ptr

Pads = Tuple[Tuple[int, int], Tuple[int, int]]
NO_PADS: Pads = ((0, 0), (0, 0))

# the plan's entries, in the order the kernel's entry point takes them
K6_PLAN_ARGS = ("span", "r", "pix", "lanes", "threads", "smem")
_GN_SIG = {"edm_gn_int8": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
           + [ctypes.c_float] + [ctypes.c_int] * len(K6_PLAN_ARGS) + [ctypes.c_void_p],
           "edm_gn_check_arith": [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p]}
# K6's fixed sizes (``csrc/gn_int8.cu``, held equal by a test): threads a
# block, the largest cluster, bytes of a thread's vector, the widest span
# (in vectors) whose lanes add by shuffles
K6_MAX_THREADS, K6_R_MAX, K6_VEC, K6_SHFL_MAX_V = 512, 8, 16, 32
# the plan's choices, timed on an H100 80GB HBM3 at 700 W by
# probes/gn_plans.py (PERF.md §6): threads a block it aims at (256:
# at CIFAR's conv1 site 0.205 ms against 0.260 with 128); cluster sizes in
# order of preference; a span's least bytes; the tile a block holds where a
# cluster of at most 8 allows (64 KB: three blocks an SM); the blocks that
# fill the card (one an SM of the H100's 132: at SD's 8 rows, 256 blocks of
# one-group spans, one block a slice took 0.0127 ms against 0.0202 with
# clusters of 4); the least pixels a block takes when the cluster grows for
# the blocks' sake
K6_THREADS = 256
K6_CLUSTERS = (1, 2, 4, 8)
K6_SPAN_MIN_BYTES = 64
K6_TILE_BYTES = 64 * 1024
K6_MIN_BLOCKS = 132
K6_MIN_PIX = 32
# the H100's shared memory a block: the opt-in maximum
BLOCK_SMEM_MAX = 232_448


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def gn_span(c: int, num_groups: int, esz: int) -> Optional[int]:
    """Channels of K6's tile span: the fewest whole groups whose bytes are
    a multiple of 16 and at least ``K6_SPAN_MIN_BYTES`` (the widest aligned
    span where C holds no such one), or None where no whole groups fill
    16-byte vectors."""
    g = c // num_groups
    aligned = [k * g for k in range(1, num_groups + 1)
               if num_groups % k == 0 and k * g * esz % K6_VEC == 0]
    wide = [span for span in aligned if span * esz >= K6_SPAN_MIN_BYTES]
    return wide[0] if wide else (aligned[-1] if aligned else None)


def gn_partials(span: int, g: int, esz: int) -> int:
    """Partials a thread keeps a vector (the kernel's ``ng``): 2 where no
    vector of the span touches more than two groups, else one a slot."""
    e = K6_VEC // esz
    most = max((v * e + e - 1) // g - (v * e) // g + 1 for v in range(span // e))
    return 2 if most <= 2 else e


def gn_lanes(v: int, pix: int) -> int:
    """Threads a vector (pixel lanes): as many as fill ``K6_THREADS``, at
    most about one a pixel of the block; where the span has at most
    ``K6_SHFL_MAX_V`` vectors, a multiple that fills whole warps (within
    ``K6_MAX_THREADS``)."""
    if v <= K6_SHFL_MAX_V:
        p0 = 32 // math.gcd(v, 32)
        if v * p0 <= K6_MAX_THREADS:
            return p0 * max(1, min(K6_THREADS // (v * p0), -(-pix // p0)))
    return max(1, min(K6_THREADS // min(v, K6_THREADS), pix))


def gn_smem_bytes(pix: int, span: int, esz: int, v: int, hv: int, ng: int, k: int) -> int:
    """K6's dynamic shared bytes (the kernel's ``gn_layout``): the tile in
    the input's dtype, the holders' f64 partials, the two passes' f64 group
    sums and the groups' f32 means and inverse deviations."""
    return (_round_up(pix * span * esz, 16) + v * hv * ng * 8 + 2 * _round_up(k * 8, 16)
            + 2 * _round_up(k * 4, 16))


def gn_launch_plan(h: int, w: int, c: int, esz: int, span: int, r: int,
                   num_groups: int = 32, lanes: Optional[int] = None) -> Optional[dict]:
    """K6's launch with tiles of ``span`` channels, clusters of ``r``
    blocks and ``lanes`` threads a vector (default :func:`gn_lanes`'), or
    None where a block would take no pixel or its shared memory or threads
    do not fit."""
    npix, g = h * w, c // num_groups
    pix = -(-npix // r)
    if (r - 1) * pix >= npix or span % g or c % span or span * esz % K6_VEC:
        return None
    v = span * esz // K6_VEC
    lanes = lanes or gn_lanes(v, pix)
    threads = _round_up(lanes * min(v, K6_MAX_THREADS), 32)
    hv = threads // 32 if v <= K6_SHFL_MAX_V else lanes
    smem = gn_smem_bytes(pix, span, esz, v, hv, gn_partials(span, g, esz), span // g)
    if smem > BLOCK_SMEM_MAX or threads > K6_MAX_THREADS or hv > 32:
        return None
    return dict(span=span, r=r, pix=pix, lanes=lanes, threads=threads, smem=smem)


@functools.lru_cache(maxsize=None)
def gn_plan(b: int, h: int, w: int, c: int, dtype: torch.dtype,
            num_groups: int = 32) -> dict:
    """K6's launch plan for a (b, h, w, c) input of ``dtype``: the span of
    :func:`gn_span`, and the smallest cluster whose blocks hold at most
    ``K6_TILE_BYTES`` of the tile while the grid reaches ``K6_MIN_BLOCKS``
    blocks (or a block would fall under ``K6_MIN_PIX`` pixels with twice
    the cluster); else the largest cluster that fits.  Returns ``span``,
    ``r``, ``pix``, ``lanes``, ``threads`` and ``smem`` (the dynamic shared
    bytes); cached, so a launch pays no search.  Raises where no plan
    fits."""
    esz = torch.empty((), dtype=dtype).element_size()
    span = gn_span(c, num_groups, esz) if c % num_groups == 0 else None
    fits = []
    for r in K6_CLUSTERS if span else ():
        plan = gn_launch_plan(h, w, c, esz, span, r, num_groups)
        if plan is None:
            continue
        fits.append(plan)
        if (plan["pix"] * span * esz <= K6_TILE_BYTES
                and (b * (c // span) * r >= K6_MIN_BLOCKS or -(-h * w // (2 * r)) < K6_MIN_PIX)):
            return plan
    if not fits:
        raise ValueError(f"gn_int8: no plan fits ({b}, {h}, {w}, {c}) {dtype} in "
                         f"{num_groups} groups")
    return fits[-1]


def gn_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             delta: Optional[torch.Tensor], zp: Optional[torch.Tensor],
             n_levels: int, pads: Pads, swish: bool, num_groups: int,
             eps: float) -> torch.Tensor:
    """K6's arithmetic in plain PyTorch.  With ``delta`` the padded int8
    codes, else y in ``x.dtype``.  Divisions are tensor by tensor: on the
    card PyTorch divides by a Python number as a product with its
    reciprocal, which rounds differently."""
    b, h, w, c = x.shape
    g = c // num_groups
    xg = x.float().reshape(b, h * w, num_groups, g)
    cnt = torch.tensor(float(h * w * g), dtype=torch.float32, device=x.device)
    mean = xg.double().sum((1, 3), keepdim=True).float() / cnt
    xc = xg - mean
    var = (xc * xc).double().sum((1, 3), keepdim=True).float() / cnt
    inv = 1.0 / torch.sqrt(var + eps)
    y = xc * (inv * scale.float().reshape(1, 1, num_groups, g)) \
        + bias.float().reshape(1, 1, num_groups, g)
    if swish:
        y = y * (1.0 / (1.0 + torch.exp(-y)))
    y = y.reshape(b, h, w, c)
    if delta is None:
        return y.to(x.dtype)
    cc = n_levels / 2 - zp
    q = torch.clamp(torch.round(y / delta), -zp, float(n_levels - 1) - zp)
    (pt, pb), (pl, pr) = pads
    out = (-cc).to(torch.int8).expand(b, h + pt + pb, w + pl + pr, c).contiguous()
    out[:, pt:pt + h, pl:pl + w, :] = (q - cc).to(torch.int8)
    return out


def _f32_param(t: torch.Tensor, c: int, dev, what: str) -> torch.Tensor:
    if t.shape != (c,) or t.device != dev:
        raise ValueError(f"{what} must be ({c},) on {dev}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.float().contiguous()


def _gn_cuda(x, scale, bias, delta, zp, n_levels, pads, swish, num_groups,
             eps):
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise ValueError(f"gn_int8 takes a float32 or bfloat16 NHWC tensor, "
                         f"not {x.dtype} {tuple(x.shape)}")
    b, h, w, c = x.shape
    if c % num_groups or x.numel() == 0:
        raise ValueError(f"gn_int8: {tuple(x.shape)} is not {num_groups} whole groups "
                         f"of a non-empty input")
    plan = gn_plan(b, h, w, c, x.dtype, num_groups)
    x = x.contiguous()
    if x.data_ptr() % 16:                 # the kernel reads 16-byte vectors
        x = x.clone()
    scale = _f32_param(scale, c, dev, "scale")
    bias = _f32_param(bias, c, dev, "bias")
    (pt, pb), (pl, pr) = pads
    if delta is None:
        out = torch.empty_like(x)
    else:
        for t, what in ((delta, "delta"), (zp, "zp")):
            if t.numel() != 1 or t.dtype != torch.float32 or t.device != dev:
                raise ValueError(f"{what} must be a float32 scalar on {dev}")
        out = torch.empty((b, h + pt + pb, w + pl + pr, c), dtype=torch.int8,
                          device=dev)
    lib = cuda_lib("gn_int8", _GN_SIG)
    err = lib.edm_gn_int8(
        ptr(x), ptr(scale), ptr(bias), ptr(delta), ptr(zp),
        ptr(out), int(x.dtype == torch.bfloat16), int(swish), b, h, w, c,
        num_groups, n_levels, pt, pb, pl, pr, eps, *(plan[k] for k in K6_PLAN_ARGS),
        stream_ptr(dev))
    check_launch(lib, err, "gn_int8")
    launch_counts["gn_int8"] += 1
    return out


def gn_check_arith(delta: float, zp: float, n_levels: int, device="cuda") -> dict:
    """K6's write-pass arithmetic against IEEE's on the card (test use; the
    kernel library's ``edm_gn_check_arith``): how many floats in [1, ∞]
    take another reciprocal than ``__frcp_rn``, how many y take another
    code than ``__fdiv_rn`` → ``rintf`` → ``__float2int_rn`` with this
    quantizer, and how many quotients on the fast path differ (0 each
    expected)."""
    bad = torch.zeros(3, dtype=torch.int64, device=device)
    lib = cuda_lib("gn_int8", _GN_SIG)
    check_launch(lib, lib.edm_gn_check_arith(delta, zp, n_levels, ptr(bad),
                                             stream_ptr(bad.device)), "gn_check_arith")
    return dict(zip(("reciprocals", "codes", "quotients"), bad.tolist()))


def _gn(x, *args):
    if x.is_cuda:
        return _gn_cuda(x, *args)
    if x.device.type != "cpu":
        raise ValueError(f"gn_int8: unsupported device {x.device}")
    return gn_plain(x, *args)


def gn_swish_int8(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  delta: torch.Tensor, zp: torch.Tensor, n_levels: int,
                  pads: Pads = NO_PADS, swish: bool = True,
                  num_groups: int = 32, eps: float = 1e-6
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm → (swish) → centered int8 act codes → pad, in one pass.
    Returns ``(padded codes, c)`` with the ``quantize_act_int8`` contract;
    the rim carries the code of x = 0 (−c), as padding x with zeros before
    the quantizer would."""
    with span("edm.op.gn_swish_int8"):
        if n_levels > 256:
            raise ValueError("int8 act codes require act_bit <= 8")
        pads = tuple(tuple(p) for p in pads)
        codes = _gn(x, scale, bias, delta, zp, n_levels, pads, swish, num_groups,
                    eps)
        return codes, n_levels / 2 - zp


def gn_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            swish: bool = False, num_groups: int = 32,
            eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm (+ swish) in one pass, returned in ``x.dtype``."""
    with span("edm.op.gn_norm"):
        return _gn(x, scale, bias, None, None, 0, NO_PADS, swish, num_groups, eps)
