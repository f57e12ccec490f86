"""Native int8 attention einsums and the int8 dense (port of
``eda_dm_tpu/ops/int8_einsum.py`` and the int8 branch of ``QDense``).

Each operand's fake-quant value is ``code·Δ`` with an integer code in
[−zp, L−1−zp]; recentering by ``c = L/2 − zp`` puts the codes in int8
range and the product expands exactly:

    einsum(â, b̂) = Δa·Δb · [ einsum(A, B)      (int8×int8 → int32)
                            + c_b·Σ_K A + c_a·Σ_K B + c_a·c_b·K ]

The int8 product runs in the hand-written kernel ``csrc/int8_bmm.cu``
(kernel K2: tensor-core products through the shared mainloop
``csrc/int8_gemm.cuh``) on a CUDA tensor and in its plain PyTorch version
on a CPU tensor; the rank-reduced code sums are ``torch.sum`` beside it,
as XLA computed them beside the einsum.  :func:`bmm_plan` chooses the
kernel's tile and load route.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from ._build import check_launch, cuda_lib, launch_counts, ptr, stream_ptr

_BMM_SIG = {"edm_int8_bmm_nt": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
            + [ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int] * 2
            + [ctypes.c_void_p]}

# the mainloop's load routes (csrc/int8_gemm.cuh): 16-byte and 8-byte
# cp.async copies, or the byte gather for any K
ROUTE_16, ROUTE_8, ROUTE_GATHER = 16, 8, 1
# K2's tiles: 128 x 128 (8 warps), and 64 x 64 (4 warps) for few columns
TILE_LARGE, TILE_SMALL = 0, 1
SMALL_N_MAX = 80


def load_route(k: int, *ptrs: int) -> int:
    """The widest copy that every K-contiguous row of these operands
    allows: 16 bytes where K and every base address are multiples of 16, 8
    bytes likewise, else the byte gather."""
    for width in (ROUTE_16, ROUTE_8):
        if k % width == 0 and all(p % width == 0 for p in ptrs):
            return width
    return ROUTE_GATHER


def bmm_plan(n: int, k: int, a_ptr: int, b_ptr: int) -> Tuple[int, int]:
    """K2's (tile, route) for A (batch, M, K) and B (batch, N, K) at these
    base addresses: the 64 x 64 tile where N is at most 80 (the logits of
    CIFAR's 16-token mid block, SD's 77 context tokens and 40-channel
    heads), else 128 x 128, also for few rows (on the H100 the large tile
    served CIFAR's mid-block W·V, M = 16 and N = 256, faster); the route
    by :func:`load_route`."""
    tile = TILE_SMALL if n <= SMALL_N_MAX else TILE_LARGE
    return tile, load_route(k, a_ptr, b_ptr)


@contextlib.contextmanager
def tf32_off():
    """Full-precision float32 products and convolutions on the card (cuDNN
    convolutions default to TF32, which keeps ~3 decimal digits)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def exact_float(bound: int) -> torch.dtype:
    """A float type in which integer sums up to ``bound`` are exact in any
    summation order: float32 below 2**24, else float64."""
    return torch.float32 if bound < 2 ** 24 else torch.float64


def quantize_act_int8(x: torch.Tensor, delta: torch.Tensor, zp: torch.Tensor,
                      n_levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centered int8 activation codes and the offset ``c``:
    ``(codes + c)·Δ`` == fake_quant(x).  Requires n_levels ≤ 256."""
    if n_levels > 256:
        raise ValueError("int8 act codes require act_bit <= 8")
    q = torch.clamp(torch.round(x.float() / delta), -zp, n_levels - 1 - zp)
    c = n_levels / 2 - zp
    return (q - c).to(torch.int8), c


# --------------------------------------------------------------------------
# K2: out[b,m,n] = epilogue(sum_k A[b,m,k]·B[b,n,k])


def _epilogue(acc, row_add, col_add, k_add, scale, bias):
    """f32 epilogue in the JAX operation order (each step rounded)."""
    v = acc.float()
    if row_add is not None:
        v = v + row_add[..., None]
    if col_add is not None:
        v = v + (col_add[:, None, :] if col_add.dim() == 2 else col_add)
    if k_add is not None:
        v = v + k_add
    v = v * scale
    if bias is not None:
        v = v + bias
    return v


def int8_matmul_acc_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ b`` of int8-valued operands (any batch) in plain
    PyTorch: a float product in a type in which every partial sum is
    exact."""
    dt = exact_float(128 * 128 * a.shape[-1])
    with tf32_off():
        return (a.to(dt) @ b.to(dt)).to(torch.int32)


def int8_bmm_acc_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``sum_k A[b,m,k]·B[b,n,k]`` in plain PyTorch."""
    return int8_matmul_acc_plain(A, B.transpose(1, 2))


def int8_bmm_nt_plain(A, B, row_add=None, col_add=None, k_add=None,
                      scale=None, bias=None):
    return _epilogue(int8_bmm_acc_plain(A, B), row_add, col_add, k_add,
                     scale, bias)


def _f32_on(t: Optional[torch.Tensor], dev, what: str):
    if t is None:
        return None
    if t.dtype != torch.float32 or t.device != dev:
        raise ValueError(f"{what} must be float32 on {dev}, got "
                         f"{t.dtype} on {t.device}")
    return t.contiguous()


def _int8_bmm_nt_cuda(A, B, row_add, col_add, k_add, scale, bias):
    dev = A.device
    if A.dtype != torch.int8 or B.dtype != torch.int8 or B.device != dev:
        raise ValueError("int8_bmm_nt takes int8 operands on one device")
    if not (A.is_contiguous() and B.is_contiguous()):
        raise ValueError("int8_bmm_nt takes contiguous operands")
    batch, m, k = A.shape
    if B.shape[0] != batch or B.shape[2] != k:
        raise ValueError(f"shape mismatch {tuple(A.shape)} x {tuple(B.shape)}")
    if batch > 65535:
        raise ValueError("int8_bmm_nt takes at most 65535 batches")
    n = B.shape[1]
    row_add = _f32_on(row_add, dev, "row_add")
    col_add = _f32_on(col_add, dev, "col_add")
    k_add = _f32_on(k_add, dev, "k_add")
    scale = _f32_on(scale, dev, "scale")
    bias = _f32_on(bias, dev, "bias")
    if row_add is not None and row_add.shape != (batch, m):
        raise ValueError("row_add must be (batch, M)")
    if col_add is not None and col_add.shape not in ((batch, n), (n,)):
        raise ValueError("col_add must be (batch, N) or (N,)")
    if k_add is not None and k_add.numel() != 1:
        raise ValueError("k_add must be a scalar")
    if scale.numel() not in (1, n) or (bias is not None and bias.shape != (n,)):
        raise ValueError("scale must be a scalar or (N,), bias (N,)")
    out = torch.empty((batch, m, n), dtype=torch.float32, device=dev)
    tile, route = bmm_plan(n, k, A.data_ptr(), B.data_ptr())
    lib = cuda_lib("int8_bmm", _BMM_SIG)
    err = lib.edm_int8_bmm_nt(
        ptr(A), ptr(B), ptr(out), batch, m, n, k, ptr(row_add), ptr(col_add),
        int(col_add is not None and col_add.dim() == 2), ptr(k_add),
        ptr(scale), int(scale.numel() != 1), ptr(bias), tile, route,
        stream_ptr(dev))
    check_launch(lib, err, "int8_bmm_nt")
    launch_counts["int8_bmm"] += 1
    return out


def int8_bmm_nt(A: torch.Tensor, B: torch.Tensor,
                row_add: Optional[torch.Tensor] = None,
                col_add: Optional[torch.Tensor] = None,
                k_add: Optional[torch.Tensor] = None,
                scale: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched int8 GEMM with int32 accumulation and the f32 epilogue
    ``((((acc + row_add[b,m]) + col_add[b,n]) + k_add) · scale[n]) + bias[n]``.

    A: (batch, M, K) int8; B: (batch, N, K) int8 (both K-contiguous; any
    K: the load route follows K's alignment, :func:`bmm_plan`);
    returns (batch, M, N) float32.  On a CUDA tensor this launches kernel
    K2; on a CPU tensor it runs the plain version.
    """
    if scale is None:
        scale = torch.ones((), dtype=torch.float32, device=A.device)
    if A.is_cuda:
        return _int8_bmm_nt_cuda(A, B, row_add, col_add, k_add, scale, bias)
    if A.device.type != "cpu":
        raise ValueError(f"int8_bmm_nt: unsupported device {A.device}")
    return int8_bmm_nt_plain(A, B, row_add, col_add, k_add, scale, bias)


# --------------------------------------------------------------------------
# callers

_HEADS_ALIASES = {"bihd,bjhd->bhij": "bthc,bshc->bhts",
                  "bhij,bjhd->bihd": "bhts,bshc->bthc"}


def int8_code_einsum(eq: str, A: torch.Tensor, ca, da,
                     B: torch.Tensor, cb, db) -> torch.Tensor:
    """einsum over precomputed centered int8 codes (the ``(codes, c)``
    contract of :func:`quantize_act_int8` / ``softmax_int8_codes``), for the
    attention equations: the (n, ·, ·) forms and the LDM heads layout
    (``bthc,bshc->bhts``, ``bhts,bshc->bthc``; the SD cross-attention's
    ``bihd,bjhd->bhij`` and ``bhij,bjhd->bihd`` are the same products, with
    other key and query lengths), whose heads become K2's batch.  Returns
    float32."""
    eq = _HEADS_ALIASES.get(eq, eq)
    if eq in ("bthc,bshc->bhts", "bhts,bshc->bthc"):
        b, h = B.shape[0], B.shape[2]
        Bh = B.permute(0, 2, 1, 3).reshape(b * h, B.shape[1], B.shape[3])
        if eq == "bthc,bshc->bhts":
            Ah = A.permute(0, 2, 1, 3).reshape(b * h, A.shape[1], A.shape[3])
            out = int8_code_einsum("nic,njc->nij", Ah, ca, da, Bh, cb, db)
            return out.reshape(b, h, out.shape[1], out.shape[2])
        out = int8_code_einsum("nij,njc->nic", A.reshape(b * h, *A.shape[2:]),
                               ca, da, Bh, cb, db)
        return out.reshape(b, h, *out.shape[1:]).permute(0, 2, 1, 3)
    if eq == "nic,njc->nij":
        Bt = B
        sum_a, sum_b = A.sum(-1, dtype=torch.int32), B.sum(-1, dtype=torch.int32)
    elif eq == "nij,njc->nic":
        Bt = B.transpose(1, 2).contiguous()      # V once to (n, c, j)
        sum_a, sum_b = A.sum(-1, dtype=torch.int32), B.sum(1, dtype=torch.int32)
    else:
        raise NotImplementedError(f"int8_code_einsum: equation {eq!r}")
    k_total = A.shape[-1]
    return int8_bmm_nt(A.contiguous(), Bt.contiguous(),
                       row_add=cb * sum_a.float(), col_add=ca * sum_b.float(),
                       k_add=ca * cb * float(k_total), scale=da * db)


def int8_act_einsum(eq: str, a: torch.Tensor, qa, b: torch.Tensor, qb):
    """einsum(fake_quant(a), fake_quant(b)) on int8 codes; ``qa``/``qb`` are
    (delta, zero_point, n_levels)."""
    da, zpa, la = qa
    db, zpb, lb = qb
    A, ca = quantize_act_int8(a, da, zpa, la)
    B, cb = quantize_act_int8(b, db, zpb, lb)
    return int8_code_einsum(eq, A, ca, da, B, cb, db)


def int8_dense(codes: torch.Tensor, w_codes: torch.Tensor,
               col_add: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``(codes @ w_codesᵀ + col_add) · scale + bias`` for (M, K) act codes
    and (N, K) weight codes: K2 with batch 1.  Returns (M, N) float32."""
    return int8_bmm_nt(codes.contiguous()[None], w_codes[None],
                       col_add=col_add, scale=scale, bias=bias)[0]
