"""The two serving matmuls of ``eda_dm_tpu/ops/pallas_quant.py``: the
fake-quant matmul (kernel K7) and the int8 quantized matmul with its
weight packing (kernel K8).

K7, the serving matmul with the activation fake-quant fused into the tile
load: on bf16 x and w (the serving carrier) a tensor-core GEMM whose
blocks take ``fq_plan``'s columns, on float32 or mixed operands a float32
FMA GEMM (bf16 products would break float32's tolerance).

Port of ``eda_dm_tpu/ops/pallas_quant.py::fakequant_matmul``, which the
DEPLOY_FUSED mode runs for every 1×1 conv and dense:

    out = (clip(round(x/Δ_k), −zp_k, L−1−zp_k)·Δ_k).to(w.dtype) @ w + bias

with per-input-channel rows Δ_k, zp_k (a split layer's two quantizers
give two channel ranges), products accumulated in float32 and the output
in ``x.dtype``.  The layout is the JAX package's: x (M, K), w (K, N).  The
port stores weights ``[out, in]``, so callers pass the transposed view
(``weight.t()``): the wrapper hands the kernel w's two strides, and takes
any strided (K, N) view without a copy.

K8, port of ``quantized_matmul``: x is quantized to int8 codes inside the
kernel, multiplied with pre-quantized int8 weights into int32, and the
rank-1 dequant corrections end it:

    xq8 = clip(round(x/s_x) + z_x, 0, 255) − 128
    out = s_x·(xq8 @ w_q + (128 − z_x)·colsum) ·s_w + s_x·row·w_deq_off (+ bias)

with ``row = Σ_k (xq8 + 128 − z_x)``, everything after the int32 product
in float32 in this order, and the output in ``x.dtype``.  Weights come
from :func:`pack_dense_weights` in the JAX layout (K, N), beside a K-major
(N, K) copy of the codes that the kernel reads (:func:`quantized_matmul`
transposes once per call where the caller passes none).  The row term
``s_x·row`` follows the JAX package's type promotion
(:func:`jax_row_term`).

On a CUDA tensor :func:`fakequant_matmul` launches
``csrc/fakequant_matmul.cu`` and :func:`quantized_matmul`
``csrc/quantized_matmul.cu``; on a CPU tensor each runs its plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._build import check_launch, cuda_lib, launch_counts, ptr, stream_ptr
from .int8_einsum import int8_matmul_acc_plain, load_route, tf32_off

_FQ_SIG = {"edm_fakequant_matmul": [ctypes.c_void_p] * 6
           + [ctypes.c_int] * 9 + [ctypes.c_void_p]}
# K7's tensor-core route (``csrc/fakequant_matmul.cu``, held equal by a
# test): rows a block, and the columns a block may take
FQ_BM = 64
FQ_BNS = (64, 128, 256)
# the H100's SMs: fewer row tiles than this split N into 64-wide tiles
FQ_SMS = 132
_QM_SIG = {"edm_quantized_matmul": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
           + [ctypes.c_void_p]}


def fakequant_rows(x: torch.Tensor, delta_k: torch.Tensor, zp_k: torch.Tensor,
                   n_levels: int, dtype: torch.dtype) -> torch.Tensor:
    """The fake-quantized x in ``dtype``: level boundaries in float32, the
    product ``q·Δ`` in float32, then one rounding to ``dtype``."""
    q = torch.clamp(torch.round(x.float() / delta_k), -zp_k,
                    float(n_levels - 1) - zp_k)
    return (q * delta_k).to(dtype)


def fq_error(out, x, w, delta_k, zp_k, n_levels, bias) -> Tuple[bool, float]:
    """(within K7's tolerance?, max |Δ|) of an output against the float64
    product of the same fake-quantized operand: |Δ| ≤ 1e-5·(|xq|·|w| +
    |bias|), plus one bf16 step at |ref| for a bf16 output (the kernels and
    the plain version add in other orders)."""
    xq = fakequant_rows(x, delta_k, zp_k, n_levels, w.dtype).double()
    b64 = (torch.zeros(w.shape[1], dtype=torch.float64, device=x.device) if bias is None
           else bias.double())
    ref = xq @ w.double() + b64
    slack = 1e-5 * (xq.abs() @ w.double().abs() + b64.abs())
    if out.dtype == torch.bfloat16:
        slack += torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    e = (out.double() - ref).abs()
    return bool((e <= slack).all()), float(e.max())


def fakequant_matmul_plain(x, w, delta_k, zp_k, n_levels, bias):
    xq = fakequant_rows(x, delta_k, zp_k, n_levels, w.dtype)
    with tf32_off():
        acc = xq.float() @ w.float()
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(x.dtype)


def fq_plan(m: int, n: int) -> int:
    """Columns a block of K7's tensor-core route takes for an (M, ·)·(·, N)
    product: all of N (rounded up to 64, 128 or 256; N past 256 in tiles of
    256), so each element of x is fake-quantized once, where the M rows
    give at least ``FQ_SMS`` row tiles of ``FQ_BM``; else 64, so that more
    blocks share the card (the temb dense, M = 500)."""
    if -(-m // FQ_BM) < FQ_SMS:
        return FQ_BNS[0]
    return next((bn for bn in FQ_BNS if n <= bn), FQ_BNS[-1])


def _fakequant_matmul_cuda(x, w, delta_k, zp_k, n_levels, bias, bn=None):
    dev = x.device
    for t, what in ((x, "x"), (w, "w")):
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dim() != 2:
            raise ValueError(f"fakequant_matmul takes a float32 or bfloat16 "
                             f"matrix {what}, not {t.dtype} {tuple(t.shape)}")
    m, k = x.shape
    if w.shape[0] != k or w.device != dev:
        raise ValueError(f"shape mismatch {tuple(x.shape)} x {tuple(w.shape)}")
    n = w.shape[1]
    rows = []
    for t, shape, what in ((delta_k, (k,), "delta_k"), (zp_k, (k,), "zp_k"),
                           (bias, (n,), "bias")):
        if t is not None and (t.shape != shape or t.device != dev):
            raise ValueError(f"{what} must be {shape} on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
        rows.append(None if t is None else t.float().contiguous())
    x = x.contiguous()
    tensor_cores = x.dtype == w.dtype == torch.bfloat16
    if tensor_cores and 1 not in w.stride():
        w = w.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    lib = cuda_lib("fakequant_matmul", _FQ_SIG)
    err = lib.edm_fakequant_matmul(
        ptr(x), ptr(w), ptr(rows[0]), ptr(rows[1]), ptr(rows[2]), ptr(out),
        int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
        m, n, k, w.stride(0), w.stride(1), n_levels, bn or fq_plan(m, n), stream_ptr(dev))
    check_launch(lib, err, "fakequant_matmul")
    launch_counts["fakequant_matmul"] += 1
    return out


def fakequant_matmul(x: torch.Tensor, w: torch.Tensor, delta_k: torch.Tensor,
                     zp_k: torch.Tensor, n_levels: int = 256,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``fq(x) @ w (+ bias)``: x (M, K) float32/bf16, w (K, N) folded
    weights (any strides), delta_k / zp_k (K,) and bias (N,) float32.
    Returns (M, N) in ``x.dtype``."""
    if x.is_cuda:
        return _fakequant_matmul_cuda(x, w, delta_k, zp_k, n_levels, bias)
    if x.device.type != "cpu":
        raise ValueError(f"fakequant_matmul: unsupported device {x.device}")
    return fakequant_matmul_plain(x, w, delta_k, zp_k, n_levels, bias)


# --------------------------------------------------------------------------
# K8: the int8 quantized matmul and its weight packing

# the kernel's plan (csrc/quantized_matmul.cu): a block quantizes a stripe
# of 128 rows into shared memory where round_up(K, 64) is at most
# RESIDENT_K_MAX (two blocks an SM); beyond, x is quantized once into
# device memory and both operands stream
RESIDENT_K_MAX = 512


def qm_plan(k: int, w_ptr: int) -> Tuple[int, int]:
    """K8's (streamed, route): streamed = 1 where K is too large for the
    resident stripe; the route of the K-major weight copy by
    :func:`~eda_dm_tpu_torch.ops.int8_einsum.load_route`."""
    return int(-(-k // 64) * 64 > RESIDENT_K_MAX), load_route(k, w_ptr)


def quantize_weights_int8(w: torch.Tensor, delta: torch.Tensor, zp: torch.Tensor,
                          n_levels: int = 256):
    """Storage int8 codes ``clip(round(w/Δ) + zp, 0, L−1) − L/2`` and the
    dequant offset ``(L/2 − zp)·Δ``: ``w ≈ codes·Δ + offset``."""
    half = n_levels // 2
    q = torch.clamp(torch.round(w / delta) + zp, 0, n_levels - 1) - half
    return q.to(torch.int8), (half - zp) * delta


def pack_dense_weights(kernel: torch.Tensor, delta: torch.Tensor, zp: torch.Tensor,
                       n_levels: int = 256):
    """A dense kernel (K, N) with per-output-channel (or scalar) Δ, zp
    prepared for :func:`quantized_matmul`: int8 codes (K, N) as the JAX
    package packs them, their K-major copy ``w_qt`` (N, K) that the kernel
    reads, scales, float32 column sums of the codes and the per-channel
    dequant offsets."""
    delta, zp = delta.reshape(1, -1), zp.reshape(1, -1)
    w_q, deq_off = quantize_weights_int8(kernel, delta, zp, n_levels)
    return {"w_q": w_q, "w_qt": w_q.t().contiguous(), "s_w": delta.reshape(-1),
            "w_colsum": w_q.sum(0, dtype=torch.int32).to(torch.float32),
            "w_deq_off": torch.broadcast_to(deq_off, kernel.shape)[0].contiguous()}


def _f32_scalar(v, dev) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(())


def quantize_x_int8(x: torch.Tensor, s_x, z_x) -> torch.Tensor:
    """The kernel's activation codes ``clip(round(x/s_x) + z_x, 0, 255) −
    128`` as float32, computed in float32 whatever x's type, as the JAX
    package's kernel computes them (its s_x and z_x are float32 arrays).

    The JAX package's row-sum pass outside its kernel divides in x's type
    where s_x is a Python number (weak typing): for a bf16 x it rounds the
    quotient to bf16 before ``round``, so its row sums may count other
    codes than its kernel's product.  :func:`jax_row_term` reproduces that
    pass and the port's row term follows it; these codes stay the
    kernel's.  On the CPU the row term equals XLA's bit for bit, and the
    output then equals the JAX package's
    (``tests/test_torch_quantized_matmul.py::test_bf16_row_term_follows_jax``
    counts the codes on which the two divisions disagree)."""
    s_x, z_x = _f32_scalar(s_x, x.device), _f32_scalar(z_x, x.device)
    return torch.clamp(torch.round(x.float() / s_x) + z_x, 0.0, 255.0) - 128.0


def _jax_type(dtype: torch.dtype, v) -> torch.dtype:
    """The type of ``a ∘ v`` for ``a`` of ``dtype`` under the JAX package's
    promotion: a Python number is weakly typed and takes ``dtype``; an
    array promotes (float64 narrowed to float32, as JAX runs without x64)."""
    if type(v) in (int, float):
        return dtype
    vt = torch.as_tensor(v).dtype
    return torch.promote_types(dtype, torch.float32 if vt == torch.float64 else vt)


def jax_row_term(x: torch.Tensor, s_x, z_x) -> Optional[torch.Tensor]:
    """``s_x·row`` (M,) float32 as the JAX package's outside pass computes
    it, ``row = sum(clip(round(x/s_x) + z_x, 0, 255) − 128 + (128 − z_x))``,
    each step rounded to the type JAX's promotion gives it (a weakly typed
    s_x or z_x takes x's type; ``jnp.sum`` adds in float32 and rounds
    once).  None where every step is float32: then it is the kernel's own
    row term (exact integer sums), which the kernel computes itself."""
    d_div = _jax_type(x.dtype, s_x)
    d_add = _jax_type(d_div, z_x)
    d_scale = _jax_type(d_add, s_x)
    if d_div == d_add == d_scale == torch.float32:
        return None
    f32 = torch.float32

    def rnd(t, dtype):
        return t.to(dtype).to(f32)

    def as_type(v, dtype):
        return rnd(torch.as_tensor(v, dtype=f32, device=x.device), dtype)
    q = torch.round(rnd(x.float() / as_type(s_x, d_div), d_div))
    q = torch.clamp(rnd(q + as_type(z_x, d_add), d_add), 0.0, 255.0) - 128.0
    row = rnd(rnd(q + as_type(128.0 - z_x, d_add), d_add).sum(dim=1), d_add)
    return rnd(as_type(s_x, d_scale) * row, d_scale)


def quantized_matmul_acc_plain(x, w_q, s_x, z_x) -> torch.Tensor:
    """The exact int32 product ``xq8 @ w_q``."""
    return int8_matmul_acc_plain(quantize_x_int8(x, s_x, z_x), w_q)


def quantized_matmul_epilogue(acc, xq8, z_x, s_x, s_w, w_colsum, w_deq_off, bias,
                              dtype, row_term=None):
    """The dequant epilogue in float32, in the JAX package's order;
    ``row_term`` (M,) in place of ``s_x·row`` where JAX's outside pass
    rounds it (:func:`jax_row_term`)."""
    if row_term is None:
        row_term = s_x * torch.sum(xq8 + (128.0 - z_x), dim=1)
    out = s_x * (acc.float() + (128.0 - z_x) * w_colsum[None, :]) * s_w[None, :] \
        + row_term[:, None] * w_deq_off[None, :]
    if bias is not None:
        out = out + bias[None, :]
    return out.to(dtype)


def quantized_matmul_plain(x, w_q, s_x, z_x, s_w, w_colsum, w_deq_off, bias=None):
    row_term = jax_row_term(x, s_x, z_x)
    s_x, z_x = _f32_scalar(s_x, x.device), _f32_scalar(z_x, x.device)
    acc = quantized_matmul_acc_plain(x, w_q, s_x, z_x)
    return quantized_matmul_epilogue(acc, quantize_x_int8(x, s_x, z_x), z_x, s_x,
                                     s_w, w_colsum, w_deq_off, bias, x.dtype, row_term)


def _quantized_matmul_cuda(x, w_q, s_x, z_x, s_w, w_colsum, w_deq_off, bias,
                           w_qt=None, acc_only=False):
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise ValueError(f"quantized_matmul takes a float32 or bfloat16 matrix x, "
                         f"not {x.dtype} {tuple(x.shape)}")
    if w_q.dtype != torch.int8 or w_q.dim() != 2 or w_q.device != dev:
        raise ValueError(f"w_q must be an int8 matrix on {dev}")
    m, k = x.shape
    if w_q.shape[0] != k or k == 0:
        raise ValueError(f"shape mismatch {tuple(x.shape)} x {tuple(w_q.shape)}")
    if k >= 1 << 16:
        raise ValueError("quantized_matmul takes K < 65536 (exact float32 row sums)")
    n = w_q.shape[1]
    if w_qt is None:
        w_qt = w_q.t().contiguous()                  # once per call: (N, K)
    elif w_qt.shape != (n, k) or w_qt.dtype != torch.int8 or w_qt.device != dev:
        raise ValueError(f"w_qt must be the ({n}, {k}) int8 transpose of w_q on {dev}")
    row_term = None if acc_only else jax_row_term(x, s_x, z_x)
    scalars = [_f32_scalar(v, dev) for v in (s_x, z_x)]
    rows = []
    for t, what in ((s_w, "s_w"), (w_colsum, "w_colsum"), (w_deq_off, "w_deq_off"),
                    (bias, "bias")):
        if acc_only or t is None:
            rows.append(None)
            continue
        if t.shape != (n,) or t.device != dev:
            raise ValueError(f"{what} must be ({n},) on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
        rows.append(t.float().contiguous())
    x, w_qt = x.contiguous(), w_qt.contiguous()
    streamed, route = qm_plan(k, w_qt.data_ptr())
    codes = row_scratch = None
    if streamed:
        codes = torch.empty((m, -(-k // 16) * 16), dtype=torch.int8, device=dev)
        row_scratch = torch.empty((m,), dtype=torch.float32, device=dev)
    out = torch.empty((m, n), dtype=torch.int32 if acc_only else x.dtype, device=dev)
    lib = cuda_lib("quantized_matmul", _QM_SIG)
    err = lib.edm_quantized_matmul(
        ptr(x), ptr(w_qt), ptr(scalars[0]), ptr(scalars[1]), *map(ptr, rows),
        ptr(row_term), ptr(out), ptr(codes), ptr(row_scratch),
        int(x.dtype == torch.bfloat16), int(acc_only), m, n, k, streamed, route,
        stream_ptr(dev))
    check_launch(lib, err, "quantized_matmul")
    launch_counts["quantized_matmul"] += 1
    return out


def quantized_matmul(x: torch.Tensor, w_q: torch.Tensor, s_x, z_x, s_w: torch.Tensor,
                     w_colsum: torch.Tensor, w_deq_off: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     w_qt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``quantize(x) @ dequant(w_q) (+ bias)``: x (M, K) float32/bf16, w_q
    (K, N) int8 codes, s_x / z_x float32 scalars or Python numbers (z_x
    integer-valued), s_w, w_colsum, w_deq_off and bias (N,) float32;
    ``w_qt``, the (N, K) copy of w_q from :func:`pack_dense_weights` (the
    kernel's layout; without it a CUDA call transposes w_q).  Returns
    (M, N) in ``x.dtype``."""
    if x.is_cuda:
        return _quantized_matmul_cuda(x, w_q, s_x, z_x, s_w, w_colsum, w_deq_off, bias,
                                      w_qt)
    if x.device.type != "cpu":
        raise ValueError(f"quantized_matmul: unsupported device {x.device}")
    return quantized_matmul_plain(x, w_q, s_x, z_x, s_w, w_colsum, w_deq_off, bias)


def quantized_matmul_acc(x: torch.Tensor, w_q: torch.Tensor, s_x, z_x,
                         w_qt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8's int32 accumulators ``xq8 @ w_q`` alone (the kernel's store in
    place of its epilogue on a CUDA tensor, the plain product on a CPU
    tensor)."""
    if x.is_cuda:
        return _quantized_matmul_cuda(x, w_q, s_x, z_x, None, None, None, None, w_qt,
                                      acc_only=True)
    if x.device.type != "cpu":
        raise ValueError(f"quantized_matmul_acc: unsupported device {x.device}")
    return quantized_matmul_acc_plain(x, w_q, s_x, z_x)
