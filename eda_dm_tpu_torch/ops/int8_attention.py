"""Fused int8 attention (kernels K4 and K5) and the applicability gates
(port of ``eda_dm_tpu/ops/pallas_attention.py``: ``int8_fused_attention``,
``int8_fused_attention_heads``, ``int8_flash_attention``,
``int8_flash_attention_heads``, ``fused_attention_applicable``,
``flash_attention_applicable``).

Semantics, in ``_kernel``'s operation order (each f32 step rounded):

    logits = (((Q·Kᵀ + ck·Σq) + cq·Σk) + cq·ck·C) · (dq·dk·attn_scale)
    w      = exp(logits − rowmax) / rowsum     (rowsum: f64, rounded to f32)
    W      = clip(round(w/dw), −zw, Lw−1−zw) − (Lw/2 − zw)     (codes)
    out    = (((W·V + cv·ΣW) + cw·ΣV) + cw·cv·S) · (dw·dv)

This is the unfused chain's function (K2 → K3 → K2), but the chain scales
its logits after the einsum epilogue and so rounds differently: the plain
version here follows the fused order.  The kernel and the plain version
add each row's exponentials in float64 and round the sum once to float32
(the JAX package adds them in float32, in XLA's order): the f32 sum then
does not depend on the order in which the threads add, unless the f64
sums of two orders straddle an f32 rounding boundary (under S·2⁻³⁰ of
rows).  So a kernel may add its rows in any order, and still a
probability on a rounding tie of its code takes the plain version's code.

K5 (:func:`int8_flash_attention`, ``csrc/int8_flash_attention.cu``)
computes the same function for a query length other than the key length
and for key lengths whose (S, S) logits K4 cannot hold.  It splits a row
tile's keys over a thread-block cluster whose blocks hold their slice's
logits, and computes each logit once; the row max is exact in any order
and the f64 row sum is added in rank order, so its plain version is K4's
plain function chunked over query rows, and the two agree bit for bit.
Where its two W·V buffers do not fit (wide heads, ImageNet's C = 384),
the ``"one_pass_wide"`` route runs the same kernel with one.  Where a
shape's logits or head do not fit even so (:func:`flash_plan`'s
``"sweep"`` route), the wrapper launches ``csrc/int8_flash_sweep.cu``,
which sweeps the key tiles three times (row max, f64 row sum, codes and
W·V), each sweep independent of the tile order, and takes a head of any
width the gate admits in chunks of columns.  (The JAX kernel keeps a
running f32 max and rescaled normalizer instead, whose sum depends on the
tile order.)

On a CUDA tensor :func:`int8_fused_attention` launches
``csrc/int8_attention.cu`` and :func:`int8_flash_attention` the route of
its plan; on a CPU tensor each runs its plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.run import span
from ._build import check_launch, cuda_lib, launch_counts, ptr, stream_ptr
from .int8_einsum import int8_bmm_acc_plain

_ATTN_SIG = {"edm_int8_fused_attention": [ctypes.c_void_p] * 6
             + [ctypes.c_int] * 10 + [ctypes.c_void_p]}
_FLASH_SIG = {name: [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
              for name in ("edm_int8_flash_attention", "edm_int8_flash_attention_wide")}
_SWEEP_SIG = {"edm_int8_flash_sweep": [ctypes.c_void_p] * 6
              + [ctypes.c_int] * 5 + [ctypes.c_void_p]}
# query rows per chunk of K5's plain version: bounds its (N, rows, Skv)
# temporaries (1 GiB of f32 logits at the SD 64×64 shape)
FLASH_PLAIN_ROWS = 1024
# the widest head K5 takes: the sweep route's blocks a (b·h, query tile)
# walk C in 64-column chunks along the grid's y dimension (at most 65,535)
FLASH_MAX_C = 64 * 65535

# the gates' working-set budget (bytes), as the TPU kernels' VMEM budget
GATE_BYTES = 6 * 1024 * 1024


def _head_width_ok(c: int, narrow_lanes: bool) -> bool:
    return c % 128 == 0 or (narrow_lanes and c % 8 == 0)


def fused_attention_applicable(s: int, c: int, narrow_lanes: bool = False) -> bool:
    """The whole-attention kernel's gate, as the JAX package has it: S a
    multiple of 8, C a multiple of 128 (any multiple of 8 with
    ``narrow_lanes``, the LDM zoos' heads), one element's working set
    within 6 MiB."""
    if s % 8 != 0 or not _head_width_ok(c, narrow_lanes):
        return False
    return 3 * s * c + 4 * s * s + 4 * s * c <= GATE_BYTES


def flash_attention_applicable(sq: int, skv: int, c: int,
                               narrow_lanes: bool = False) -> bool:
    """The two-pass tiled kernel's (K5) gate, as the JAX package has it."""
    tq, tk = min(sq, 256), min(skv, 512)
    if sq % tq != 0 or skv % tk != 0 or skv % 128 != 0:
        return False
    if not _head_width_ok(c, narrow_lanes):
        return False
    return 2 * skv * c + 4 * tq * c * 3 + 4 * tq * tk <= GATE_BYTES


# the plan's entries, in the order the kernel's entry point takes them
K4_PLAN_ARGS = ("tq", "threads", "cq", "tj", "tv", "smem")
# K4's fixed sizes (``csrc/int8_attention.cu``, held equal by a test): query
# rows and warps a block, ring slots, output columns a phase-3 chunk, n8 key
# tiles a warp in phase 1 at a time, header bytes
K4_TQ, K4_WARPS, K4_STAGES, K4_CB, K4_NI_MAX, K4_HDR = 32, 16, 2, 256, 4, 4096
# K4's tile sizes in keys (K and V tiles each): on the H100 a pipeline step
# costs about as much again in barriers and dependent latency as in work,
# so the plan takes the fewest, largest tiles that fit
K4_TILE_KEYS = (64, 128, 256, 512, 1024)
# the H100's shared memory a block: the opt-in maximum
BLOCK_SMEM_MAX = 232_448


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def k4_cq(c: int) -> int:
    """Bytes of C a phase-1 step: C rounded up to 32 up to 256, else 128."""
    return _round_up(c, 32) if c <= K4_CB else 128


def k4_smem_bytes(s: int, c: int, tj: int, tv: int):
    """K4's dynamic shared bytes (the kernel's ``k4_layout``) with K tiles
    of ``tj`` keys and V tiles of ``tv``, or None where that pair does not
    fit a block or a warp's split: header, f32 logits rows of S + 4 (the
    codes overwrite them), the int32 W·V sums, the Q tile, and the ring,
    whose slot holds a K tile (with its Q chunk where C takes several) or a
    V tile (rows of the chunk's columns rounded up to 32, plus 8).  A warp
    takes a K tile's n8 key tiles ``K4_NI_MAX`` at a time, so a K tile
    holds several such chunks only where C is one step."""
    cq, cb0 = k4_cq(c), min(c, K4_CB)
    ni1 = tj // (8 * K4_WARPS // (K4_TQ // 16))      # n8 key tiles a warp
    if tj % (8 * K4_WARPS // (K4_TQ // 16)) or ni1 < 1 or (
            ni1 > K4_NI_MAX and (ni1 % K4_NI_MAX or c > cq)):
        return None
    slot1 = (tj + (K4_TQ if c > cq else 0)) * (cq + 16)
    slot3 = tv * (_round_up(cb0, 32) + 8)
    smem = (K4_HDR + K4_TQ * 4 * (s + 4) + K4_TQ * 4 * cb0 + K4_TQ * (cq + 16)
            + K4_STAGES * max(slot1, slot3))
    return smem if smem <= BLOCK_SMEM_MAX else None


@functools.lru_cache(maxsize=None)
def attention_plan(s: int, c: int) -> dict:
    """K4's launch plan at (S, C): ``K4_TQ`` = 32 query rows in one block
    of 16 warps (rows past S zero-filled), C in steps of ``cq`` bytes, and
    the K and V tile sizes in keys with the fewest steps, then the least
    shared memory, that fit.  Returns ``tq``, ``threads``, ``cq``, ``tj``,
    ``tv`` and ``smem`` (the dynamic shared bytes); cached, so a launch
    pays no search."""
    best = None
    for tj in K4_TILE_KEYS:
        for tv in K4_TILE_KEYS:
            smem = k4_smem_bytes(s, c, tj, tv)
            key = (-(-s // tj) + -(-s // tv), smem)
            if smem is not None and (best is None or key < best[0]):
                best = key, dict(tq=K4_TQ, threads=32 * K4_WARPS, cq=k4_cq(c), tj=tj,
                                 tv=tv, smem=smem)
    if best is None:
        raise ValueError(f"int8_fused_attention: no plan fits S={s}, C={c}")
    return best[1]


# the plan's entries, in the order K5's entry point takes them
K5_PLAN_ARGS = ("tq", "threads", "r", "kb", "smem")
# K5's fixed sizes (``csrc/int8_flash_attention.cu``, held equal by a
# test): the most warps a block (a warp takes two rows of an item: 16
# warps for 32-row items, 32 for 64-row ones), the largest cluster, the
# step of a block's keys, the widest head of the one-pass route, header
# bytes
K5_WARPS_MAX, K5_R_MAX, K5_KB_STEP, K5_MAX_C, K5_HDR = 32, 8, 64, 512, 3328
# cluster sizes, and query rows a work item, in the plan's order of
# preference: 64-row items (in 32-warp blocks) pay the cluster's barriers
# half as often as 32-row ones (in 16 warps): 4.68 against 5.83 ms at SD's
# 64×64 shape on an H100 80GB HBM3 at 700 W (probes/flash_plans.py,
# PERF.md §6)
K5_CLUSTERS = (1, 2, 4, 8)
K5_TQS = (64, 32)
# K5's routes by W·V buffers: two (the item's epilogue overlaps the next
# item's barrier), or one where two do not fit a block (wide heads:
# ImageNet's (1024, 1024, 384) at 8 blocks of 128 keys), each with its
# entry point
K5_ROUTES = {2: "one_pass", 1: "one_pass_wide"}
K5_ENTRY = {"one_pass": "edm_int8_flash_attention",
            "one_pass_wide": "edm_int8_flash_attention_wide"}
# the sweep route's fixed sizes (``csrc/int8_flash_sweep.cu``): query rows
# and keys a tile, output columns a block, threads, words of row padding,
# columns of the query and key tiles resident a chunk
SWEEP_FQ, SWEEP_FJ, SWEEP_FCH, SWEEP_THREADS, SWEEP_FPAD = 64, 64, 64, 256, 4
SWEEP_FCC = 1024


def k5_smem_bytes(tq: int, c: int, kb: int, nbuf: int = 2):
    """K5's dynamic shared bytes (the kernel's ``k5_layout``) with ``tq``
    query rows and ``kb`` keys a block, or None where that does not fit a
    block: header, f32 logits rows of kb + 4 (the codes overwrite them), the
    int32 W·V sums of ``nbuf`` items (rows of C rounded up to 8, plus 8
    with one buffer), ΣV (the block's and the cluster's, of two elements),
    the Σk terms, the Q tile and the K slice (rows of C rounded up to 32,
    plus 16), and the V slice transposed (C rounded up to 8 rows of
    kb + 16)."""
    cp, c8 = _round_up(c, 32), _round_up(c, 8)
    red_ld = c8 + 8 if nbuf == 1 else c8
    smem = (K5_HDR + tq * 4 * (kb + 4) + nbuf * tq * 4 * red_ld + 4 * 4 * c8 + 4 * kb
            + tq * (cp + 16) + kb * (cp + 16) + c8 * (kb + 16))
    return smem if smem <= BLOCK_SMEM_MAX else None


def sweep_smem_bytes(c: int) -> int:
    """The sweep route's dynamic shared bytes (``int8_flash_sweep.cu``):
    the query and key tiles hold a chunk of at most ``SWEEP_FCC`` columns
    (a wider head walks C chunk by chunk), then the V tile, the codes and
    the code sums."""
    cw = min(c, SWEEP_FCC) // 4
    return 4 * (cw * (SWEEP_FQ + SWEEP_FPAD) + cw * (SWEEP_FJ + SWEEP_FPAD)
                + (SWEEP_FJ // 4) * (SWEEP_FCH + SWEEP_FPAD)
                + SWEEP_FQ * (SWEEP_FJ // 4 + 1) + SWEEP_FQ + SWEEP_FJ + SWEEP_FCH)


def k5_plan(r: int, tq: int, skv: int, c: int, nbuf: int = 2):
    """K5's one-pass plan with ``r`` blocks a cluster, ``tq`` rows a work
    item and ``nbuf`` W·V buffers (the route ``K5_ROUTES[nbuf]``), or None
    where a block's logits, slices and head do not fit: each block takes
    ``kb`` keys, Skv / r rounded up to ``K5_KB_STEP``."""
    kb = _round_up(-(-skv // r), K5_KB_STEP)
    smem = k5_smem_bytes(tq, c, kb, nbuf) if c <= K5_MAX_C else None
    if smem is None:
        return None
    return dict(route=K5_ROUTES[nbuf], tq=tq, threads=16 * tq, r=r, kb=kb, smem=smem)


@functools.lru_cache(maxsize=None)
def flash_plan(sq: int, skv: int, c: int) -> dict:
    """K5's launch plan at (Sq, Skv, C): the one-pass route with the
    smallest cluster (``r`` blocks, each ``kb`` keys) whose blocks hold
    their slice, with 64 query rows a work item where they fit and Sq
    exceeds 32, else 32; where two W·V buffers fit no cluster, the same
    search with one (the ``one_pass_wide`` route); else the sweep route
    (``int8_flash_sweep.cu``: one block covers the keys in three sweeps,
    and C in chunks of at most ``SWEEP_FCC`` columns).  Returns ``route``,
    ``tq``, ``threads``, ``r``, ``kb`` and ``smem`` (the dynamic shared
    bytes); cached, so a launch pays no search."""
    for nbuf in K5_ROUTES:
        for r in K5_CLUSTERS:
            for tq in K5_TQS:
                plan = k5_plan(r, tq, skv, c, nbuf) if tq == 32 or sq > 32 else None
                if plan is not None:
                    return plan
    return dict(route="sweep", tq=SWEEP_FQ, threads=SWEEP_THREADS, r=1, kb=skv,
                smem=sweep_smem_bytes(c))


def attention_scalars(cq, dq, ck, dk, cv, dv, attn_scale: float, dw, zw,
                      device) -> torch.Tensor:
    """``[cq, ck, cv, dq·dk·attn_scale, dw, zw, dw·dv]`` as float32, formed
    as the JAX wrapper forms them."""
    def f(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())
    return torch.stack([f(cq), f(ck), f(cv), f(dq) * f(dk) * attn_scale,
                        f(dw), f(zw), f(dw) * f(dv)])


def int8_fused_attention_plain(Q, K, V, sc: torch.Tensor, n_levels_w: int,
                               return_codes: bool = False):
    """K4's arithmetic in plain PyTorch, in ``_kernel``'s operation order,
    the softmax row sums in float64 as in the kernel (module docstring).
    Q is (N, Sq, C), K and V (N, Skv, C); Sq = Skv for K4."""
    cq, ck, cv, lsc, dw, zw, dwdv = sc.unbind()
    s, c = K.shape[1], Q.shape[2]
    acc = int8_bmm_acc_plain(Q, K).float()
    sum_q = Q.sum(-1, dtype=torch.int32).float()[..., None]
    sum_k = K.sum(-1, dtype=torch.int32).float()[:, None, :]
    logits = (acc + ck * sum_q + cq * sum_k + cq * ck * float(c)) * lsc
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    w = e / e.double().sum(-1, keepdim=True).float()
    cw = n_levels_w / 2 - zw
    wc = torch.clamp(torch.round(w / dw), -zw, float(n_levels_w - 1) - zw) - cw
    W = wc.to(torch.int8)
    acc2 = int8_bmm_acc_plain(W, V.transpose(1, 2).contiguous()).float()
    sum_w = W.sum(-1, dtype=torch.int32).float()[..., None]
    sum_v = V.sum(1, dtype=torch.int32).float()[:, None, :]
    out = (acc2 + cv * sum_w + cw * sum_v + cw * cv * float(s)) * dwdv
    return (out, W) if return_codes else out


def _int8_fused_attention_cuda(Q, K, V, sc, n_levels_w, return_codes):
    dev = Q.device
    if any(t.dtype != torch.int8 or t.device != dev for t in (K, V)) \
            or Q.dtype != torch.int8:
        raise ValueError("int8_fused_attention takes int8 Q/K/V on one device")
    if Q.dim() != 3 or K.shape != Q.shape or V.shape != Q.shape:
        raise ValueError(f"Q/K/V must share one (N, S, C) shape, got "
                         f"{tuple(Q.shape)}, {tuple(K.shape)}, {tuple(V.shape)}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (Q, K, V)):
        raise ValueError("int8_fused_attention takes contiguous, aligned operands")
    n, s, c = Q.shape
    if not fused_attention_applicable(s, c, narrow_lanes=True):
        raise ValueError(f"int8_fused_attention: S={s}, C={c} is outside the "
                         "kernel's gate (S, C multiples of 8, 3SC+4S²+4SC ≤ 6 MiB)")
    if n_levels_w > 256:
        raise ValueError("int8 codes require sm_abit <= 8")
    out = torch.empty((n, s, c), dtype=torch.float32, device=dev)
    codes = (torch.empty((n, s, s), dtype=torch.int8, device=dev)
             if return_codes else None)
    plan = attention_plan(s, c)
    lib = cuda_lib("int8_attention", _ATTN_SIG)
    err = lib.edm_int8_fused_attention(
        ptr(Q), ptr(K), ptr(V), ptr(sc.contiguous()), ptr(out), ptr(codes),
        n, s, c, n_levels_w, *(plan[k] for k in K4_PLAN_ARGS), stream_ptr(dev))
    check_launch(lib, err, "int8_fused_attention")
    launch_counts["int8_attention"] += 1
    return (out, codes) if return_codes else out


def int8_fused_attention(Q: torch.Tensor, cq, dq, K: torch.Tensor, ck, dk,
                         V: torch.Tensor, cv, dv, attn_scale: float, dw, zw,
                         n_levels_w: int, return_codes: bool = False):
    """Attention over centered int8 codes, fused end to end.

    Q/K/V: (N, S, C) int8 codes with offsets cq/ck/cv and steps dq/dk/dv
    (the contract of ``quantize_act_int8``); ``attn_scale`` scales the
    logits; dw/zw/n_levels_w are the softmax quantizer's.  Returns f32
    (N, S, C), and with ``return_codes`` also the int8 codes W (N, S, S).
    On a CUDA tensor this launches kernel K4; on a CPU tensor it runs the
    plain version."""
    with span("edm.op.int8_fused_attention"):
        sc = attention_scalars(cq, dq, ck, dk, cv, dv, attn_scale, dw, zw, Q.device)
        if Q.is_cuda:
            return _int8_fused_attention_cuda(Q, K, V, sc, n_levels_w, return_codes)
        if Q.device.type != "cpu":
            raise ValueError(f"int8_fused_attention: unsupported device {Q.device}")
        return int8_fused_attention_plain(Q, K, V, sc, n_levels_w, return_codes)


def int8_flash_attention_plain(Q, K, V, sc: torch.Tensor, n_levels_w: int,
                               return_codes: bool = False,
                               rows: int = FLASH_PLAIN_ROWS):
    """K5's function in plain PyTorch: K4's plain function over
    ``rows`` query rows at a time (each row's result does not depend on
    the others)."""
    parts = [int8_fused_attention_plain(Q[:, r:r + rows], K, V, sc,
                                        n_levels_w, return_codes)
             for r in range(0, Q.shape[1], rows)]
    if not return_codes:
        return torch.cat(parts, 1)
    return (torch.cat([p[0] for p in parts], 1),
            torch.cat([p[1] for p in parts], 1))


def flash_shape_check(n: int, sq: int, skv: int, c: int) -> None:
    """Raise unless K5 takes (N, Sq, Skv, C) on the card: C a multiple of
    4 and at most ``FLASH_MAX_C``, N, Sq and Skv positive."""
    if c % 4 or c > FLASH_MAX_C or min(n, sq, skv, c) <= 0:
        raise ValueError(f"int8_flash_attention: C={c} must be a positive multiple "
                         f"of 4 and at most {FLASH_MAX_C}, N, Sq, Skv positive")


def _int8_flash_attention_cuda(Q, K, V, sc, n_levels_w, return_codes):
    dev = Q.device
    if any(t.dtype != torch.int8 or t.device != dev for t in (Q, K, V)):
        raise ValueError("int8_flash_attention takes int8 Q/K/V on one device")
    if (Q.dim() != 3 or K.dim() != 3 or V.shape != K.shape
            or K.shape[0] != Q.shape[0] or K.shape[2] != Q.shape[2]):
        raise ValueError(f"Q must be (N, Sq, C) and K/V (N, Skv, C), got "
                         f"{tuple(Q.shape)}, {tuple(K.shape)}, {tuple(V.shape)}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (Q, K, V)):
        raise ValueError("int8_flash_attention takes contiguous, aligned operands")
    n, sq, c = Q.shape
    skv = K.shape[1]
    flash_shape_check(n, sq, skv, c)
    if n_levels_w > 256:
        raise ValueError("int8 codes require sm_abit <= 8")
    out = torch.empty((n, sq, c), dtype=torch.float32, device=dev)
    codes = (torch.empty((n, sq, skv), dtype=torch.int8, device=dev)
             if return_codes else None)
    plan = flash_plan(sq, skv, c)
    args = (ptr(Q), ptr(K), ptr(V), ptr(sc.contiguous()), ptr(out), ptr(codes),
            n, sq, skv, c, n_levels_w)
    if plan["route"] in K5_ENTRY:
        lib = cuda_lib("int8_flash_attention", _FLASH_SIG)
        err = getattr(lib, K5_ENTRY[plan["route"]])(
            *args, *(plan[k] for k in K5_PLAN_ARGS), stream_ptr(dev))
        check_launch(lib, err, "int8_flash_attention")
        launch_counts["int8_flash_attention"] += 1
    else:
        lib = cuda_lib("int8_flash_sweep", _SWEEP_SIG)
        err = lib.edm_int8_flash_sweep(*args, stream_ptr(dev))
        check_launch(lib, err, "int8_flash_sweep")
        launch_counts["int8_flash_sweep"] += 1
    return (out, codes) if return_codes else out


def int8_flash_attention(Q: torch.Tensor, cq, dq, K: torch.Tensor, ck, dk,
                         V: torch.Tensor, cv, dv, attn_scale: float, dw, zw,
                         n_levels_w: int, return_codes: bool = False):
    """Tiled int8 attention: Q (N, Sq, C), K/V (N, Skv, C) centered int8
    codes, the rest as :func:`int8_fused_attention`.  Returns f32
    (N, Sq, C), and with ``return_codes`` also the codes W (N, Sq, Skv).
    On a CUDA tensor this launches kernel K5 (the route of
    :func:`flash_plan`); on a CPU tensor it runs the plain version."""
    with span("edm.op.int8_flash_attention"):
        sc = attention_scalars(cq, dq, ck, dk, cv, dv, attn_scale, dw, zw, Q.device)
        if Q.is_cuda:
            return _int8_flash_attention_cuda(Q, K, V, sc, n_levels_w, return_codes)
        if Q.device.type != "cpu":
            raise ValueError(f"int8_flash_attention: unsupported device {Q.device}")
        return int8_flash_attention_plain(Q, K, V, sc, n_levels_w, return_codes)


def heads_to_batched(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, C) → (B·H, S, C), contiguous."""
    b, s, h, c = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, c)


def int8_fused_attention_heads(Q: torch.Tensor, cq, dq, K: torch.Tensor, ck,
                               dk, V: torch.Tensor, cv, dv, attn_scale: float,
                               dw, zw, n_levels_w: int) -> torch.Tensor:
    """Heads layout: Q/K/V (B, S, H, C) codes → f32 (B, S, H, C); heads are
    flattened into the batch, one (S, C) attention per (b, h)."""
    b, s, h, c = Q.shape
    out = int8_fused_attention(heads_to_batched(Q), cq, dq, heads_to_batched(K),
                               ck, dk, heads_to_batched(V), cv, dv, attn_scale,
                               dw, zw, n_levels_w)
    return out.reshape(b, h, s, c).permute(0, 2, 1, 3)


def int8_flash_attention_heads(Q: torch.Tensor, cq, dq, K: torch.Tensor, ck,
                               dk, V: torch.Tensor, cv, dv, attn_scale: float,
                               dw, zw, n_levels_w: int) -> torch.Tensor:
    """Heads layout: Q (B, Sq, H, C), K/V (B, Skv, H, C) codes → f32
    (B, Sq, H, C); heads are flattened into the batch, one attention per
    (b, h)."""
    b, sq, h, c = Q.shape
    out = int8_flash_attention(heads_to_batched(Q), cq, dq, heads_to_batched(K),
                               ck, dk, heads_to_batched(V), cv, dv, attn_scale,
                               dw, zw, n_levels_w)
    return out.reshape(b, h, sq, c).permute(0, 2, 1, 3)
