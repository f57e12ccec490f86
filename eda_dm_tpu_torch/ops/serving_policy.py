"""Serving gates for the quantized deployment path (port of
``eda_dm_tpu/ops/serving_policy.py`` and the int8 gates beside it:
``int8_conv_serving`` of ``eda_dm_tpu/nn/layers.py``,
``int8_attention_serving`` of ``eda_dm_tpu/ops/int8_einsum.py``).

Every branch is chosen as the JAX package chooses it, from the same
environment switches with the same defaults and meanings, so that one
setting puts both packages on the same branch.  The switches are the
user's explicit choices; with all of them unset the policy decides:

``EDM_FUSED_ATTN``        0 = every int8 attention site on the einsum
                          branch (K2 → K3 → K2); 1 = the fused kernel (K4)
                          where it applies, else the tiled one (K5) where
                          it applies, else einsum; unset = the policy's
                          shape rule (:func:`attention_impl`).
``EDM_FUSED_ATTN_NARROW`` 0 = the attention kernels take only head widths
                          that are multiples of 128; unset or 1 = any
                          multiple of 8.
``EDM_FUSED_SOFTMAX``     0 = the einsum branch quantizes a float32
                          ``torch.softmax`` (``quantize_act_int8``) in
                          place of the softmax-codes kernel (K3).
``EDM_INT8_CONV``         0 = every conv and dense on the folded DEPLOY
                          numerics even under DEPLOY_INT8 (the int8 export
                          keeps the folded weights too).
``EDM_INT8_ATTN``         0 = the attention products on the fake-quant
                          branch even under DEPLOY_INT8.
``EDM_FUSED_GN``          1 = the fused GroupNorm (K6) where
                          :func:`fused_gn_applicable` admits the shape
                          (default off); ``EDM_FUSED_GN_NARROW=1`` admits
                          widths that are not multiples of 128.
``EDM_SERVE_KIND``        ``int8`` | ``bf16``: the export
                          :func:`preferred_export_kind` names.

The JAX package's ``EDM_INT8_ACC=f32`` asks the TPU's matrix unit for a
float32 accumulator; the card's int8 kernels accumulate in int32 exactly,
so the port has no such choice and ignores the variable.  The thresholds
of :func:`attention_impl` are the JAX package's; retuning them for the
card is measured work of its own.
"""

from __future__ import annotations

import os
from typing import Optional

from .int8_attention import (flash_attention_applicable,
                             fused_attention_applicable)

# the batch·heads above which the batched einsums serve small-S attention
BATCH_HEADS_EINSUM_MIN = 128
# the einsum path's logits bytes beyond which a fused kernel serves instead
LOGITS_BYTES_MAX = 256 * 1024 * 1024


def _env3(name: str) -> Optional[bool]:
    """Tri-state switch: None (unset: the policy decides), True ('1'),
    False (anything else)."""
    v = os.environ.get(name)
    return None if v is None else v == "1"


def int8_serving(mode) -> bool:
    """'This forward is the int8 deployment graph'.  It reads no switch,
    so that choices that are not about int8 (the fused GroupNorm sites)
    do not move when one is set.  Never a calibration, reconstruction or
    capture forward."""
    return (mode.int8 and mode.a_quant and not mode.calib_a
            and not mode.w_quant and not mode.training and not mode.capture
            and not mode.soft_targets)


def int8_attention_serving(mode) -> bool:
    """The int8 attention branch (K2 → K3 → K2, K4 or K5) of a site;
    ``EDM_INT8_ATTN=0`` keeps the fake-quant branch."""
    if os.environ.get("EDM_INT8_ATTN", "1") != "1":
        return False
    return int8_serving(mode)


def int8_conv_serving(mode, wq, aq, disable_act_quant: bool = False,
                      split: int = 0) -> bool:
    """Gate for the native int8 conv/dense path.  8-bit-weight layers (the
    first/last policy) keep the folded path, since their centered codes can
    leave int8 range; split dual-quantizer layers stay folded too (one conv
    per half would be needed); activations must fit int8 after the L/2
    recentering (act_bit ≤ 8).  ``EDM_INT8_CONV=0`` keeps every layer on
    the folded path."""
    if os.environ.get("EDM_INT8_CONV", "1") != "1":
        return False
    return (int8_serving(mode) and not disable_act_quant and split == 0
            and wq.n_bits <= 7 and aq.n_bits <= 8)


def narrow_lanes_allowed() -> bool:
    """Head widths that are not multiples of 128 in the attention kernels
    (allowed unless ``EDM_FUSED_ATTN_NARROW=0``)."""
    return os.environ.get("EDM_FUSED_ATTN_NARROW", "1") == "1"


def attention_impl(batch: int, heads: int, sq: int, skv: int, c: int) -> str:
    """The int8 serving branch of one attention site: ``'einsum'`` (K2 →
    K3 → K2), ``'fused'`` (K4: self-attention whose (S, S) logits fit the
    gate) or ``'flash'`` (K5: the tiled kernel, SD's 4096-token
    self-attention; the 77-token text context is not tileable and keeps
    the einsum branch).  ``batch`` is the global batch: under a dp mesh
    the callers pass ``parallel/rows.py::global_rows`` of their rows, as
    JAX's traced shapes are the global ones."""
    narrow = narrow_lanes_allowed()
    can_fuse = sq == skv and fused_attention_applicable(sq, c, narrow_lanes=narrow)
    can_flash = flash_attention_applicable(sq, skv, c, narrow_lanes=narrow)
    force = _env3("EDM_FUSED_ATTN")
    if force is False:
        return "einsum"
    if force is True:
        return "fused" if can_fuse else ("flash" if can_flash else "einsum")
    bh = batch * heads
    if bh >= BATCH_HEADS_EINSUM_MIN and 4 * bh * sq * skv <= LOGITS_BYTES_MAX:
        return "einsum"
    if can_fuse:
        return "fused"
    if can_flash:
        return "flash"
    return "einsum"


def use_fused_softmax() -> bool:
    """The softmax-codes kernel (K3) on the einsum branch, unless
    ``EDM_FUSED_SOFTMAX=0``."""
    force = _env3("EDM_FUSED_SOFTMAX")
    return True if force is None else force


def fused_gn_applicable(h: int, w: int, c: int, num_groups: int = 32) -> bool:
    """The JAX package's shape gate of the fused GroupNorm: whole groups,
    widths that are multiples of 128 (narrower multiples of 8 behind
    ``EDM_FUSED_GN_NARROW=1``), ``h·w`` a multiple of 8, and one batch
    element under 5 MiB at 12 bytes an element.  On the card the last
    clause bounds one (batch, group) slice at 13,653 elements, 54.6 KB in
    float32: K6 holds it in one block's shared memory."""
    if c % num_groups != 0:
        return False
    if c % 128 != 0 and not (
            os.environ.get("EDM_FUSED_GN_NARROW", "0") == "1" and c % 8 == 0):
        return False
    if (h * w) % 8 != 0:
        return False
    return h * w * c * 12 <= 5 * 1024 * 1024


def use_fused_gn(h: int, w: int, c: int) -> bool:
    """The fused GroupNorm(+swish)(+quantize) kernel at one norm site: only
    where ``EDM_FUSED_GN=1`` and the shape passes the gate."""
    if os.environ.get("EDM_FUSED_GN") != "1":
        return False
    return fused_gn_applicable(h, w, c)


def preferred_export_kind(use_spatial_transformer: bool) -> str:
    """The quantized serving export the JAX package names per family:
    native int8 for the conv and legacy-attention UNets (CIFAR DDPM,
    bedroom and church LDMs), the folded bf16 export for the
    spatial-transformer UNets (ImageNet cin256-v2, SD v1.4), by its TPU
    measurement; ``EDM_SERVE_KIND`` (``int8`` | ``bf16``) overrides.  On
    the card native int8 beat the folded export at SD's 8 rows (PERF.md
    §6); this function keeps the JAX package's answer so that one setting
    names one export in both packages."""
    force = os.environ.get("EDM_SERVE_KIND")
    if force in ("int8", "bf16"):
        return force
    return "bf16" if use_spatial_transformer else "int8"
