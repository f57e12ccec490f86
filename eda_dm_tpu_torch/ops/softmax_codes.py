"""Fused softmax → int8 codes (kernel K3, Triton).

Port of ``eda_dm_tpu/ops/pallas_softmax.py::softmax_int8_codes``:

    w = softmax(logits, axis=-1)                       # f32
    q = clip(round(w / delta), -zp, n_levels - 1 - zp)
    codes = q - (n_levels/2 - zp)                      # centered, int8

The kernel reads each f32 row once and writes its int8 codes once: one
program per block of rows, the row length masked up to the next power of
two.  Bound on the card: bytes (5 per element), far below the compute
ridge.  It computes what the plain version computes, operation by
operation: libdevice's ``expf`` (PyTorch's ``exp`` on the card) rather
than Triton's approximate ``exp``, IEEE divisions, and the row sum added
in float64 and rounded once to float32, so that it does not depend on the
order of the reduction (the JAX package adds in float32, in XLA's order).
A code may still flip by one where ``exp`` on the host differs from the
card's, or where the f64 sums of two orders straddle an f32 rounding
boundary.

``triton`` is imported only when a CUDA tensor is launched: the module
imports on machines without it.
"""

# annotations stay strings, so ``tl.constexpr`` below is not evaluated at
# import; triton reads them when the kernel is compiled
from __future__ import annotations

from typing import Tuple

import torch

from ._build import import_triton, launch_counts
from .int8_einsum import quantize_act_int8
from .serving_policy import use_fused_softmax

tl = None            # triton.language, bound at the first launch
libdevice = None     # triton.language.extra.libdevice, likewise
_jit_kernel = None


def _softmax_codes_kernel(x_ptr, out_ptr, d_ptr, z_ptr, R, S, hi, half,
                          ROWS: tl.constexpr, BLOCK_S: tl.constexpr):
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_S)
    mask = (rows[:, None] < R) & (cols[None, :] < S)
    offs = rows[:, None].to(tl.int64) * S + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=-1e30)
    m = tl.max(x, axis=1)
    e = libdevice.exp(x - m[:, None])
    e = tl.where(mask, e, 0.0)
    total = tl.sum(e.to(tl.float64), axis=1).to(tl.float32)
    w = libdevice.div_rn(e, tl.broadcast_to(total[:, None], (ROWS, BLOCK_S)))
    d = tl.load(d_ptr)
    z = tl.load(z_ptr)
    r = libdevice.div_rn(w, tl.broadcast_to(d, (ROWS, BLOCK_S)))
    # round half to even: adding 1.5*2^23 leaves no fraction bits, and the
    # add rounds to nearest-even; r >= 0, and r above 2^22 is clipped below
    r = (r + 12582912.0) - 12582912.0
    q = tl.minimum(tl.maximum(r, -z), hi - z)
    tl.store(out_ptr + offs, (q - (half - z)).to(tl.int8), mask=mask)


def _kernel():
    global tl, libdevice, _jit_kernel
    if _jit_kernel is None:
        triton = import_triton()
        import triton.language as language
        from triton.language.extra import libdevice as extra
        tl, libdevice = language, extra
        _jit_kernel = triton.jit(_softmax_codes_kernel)
    return _jit_kernel


def softmax_int8_codes_plain(logits: torch.Tensor, delta: torch.Tensor,
                             zp: torch.Tensor, n_levels: int) -> torch.Tensor:
    x = logits.float()
    e = torch.exp(x - x.amax(-1, keepdim=True))
    w = e / e.double().sum(-1, keepdim=True).float()
    q = torch.clamp(torch.round(w / delta), -zp, float(n_levels - 1) - zp)
    return (q - (n_levels / 2 - zp)).to(torch.int8)


def _softmax_codes_triton(logits, delta, zp, n_levels):
    dev = logits.device
    if logits.dtype != torch.float32:
        raise ValueError(f"softmax_int8_codes takes f32 logits, not {logits.dtype}")
    for t, what in ((delta, "delta"), (zp, "zp")):
        if t.numel() != 1 or t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{what} must be a float32 scalar on {dev}")
    kernel = _kernel()
    s = logits.shape[-1]
    x = logits.contiguous().reshape(-1, s)
    r = x.shape[0]
    block_s = max(16, 1 << (s - 1).bit_length())
    rows = max(1, 4096 // block_s)
    out = torch.empty((r, s), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        kernel[((r + rows - 1) // rows,)](
            x, out, delta.contiguous(), zp.contiguous(), r, s,
            float(n_levels - 1), float(n_levels / 2),
            ROWS=rows, BLOCK_S=block_s, num_warps=4)
    launch_counts["softmax_codes"] += 1
    return out.reshape(logits.shape)


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
        codes = _softmax_codes_triton(logits, delta, zp, n_levels)
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
