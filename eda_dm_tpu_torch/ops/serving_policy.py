"""Serving gates for the quantized deployment path (port of
``eda_dm_tpu/ops/serving_policy.py`` and the int8 gates beside it).

With the serving modes (FP, DEPLOY, DEPLOY_FUSED, DEPLOY_INT8) the JAX
package's ``int8_serving`` and ``int8_attention_serving`` are the same
predicate.  ``attention_impl`` keeps the JAX package's default thresholds
and reads no environment switch, so the port takes the branch JAX takes at
every shape; retuning them for the card is measured work of its own.

The fused GroupNorm (kernel K6) is chosen as the JAX package chooses it,
from the same environment switches, so that one setting puts both packages
on the same branch: ``EDM_FUSED_GN=1`` turns it on where
:func:`fused_gn_applicable` admits the shape (default off), and
``EDM_FUSED_GN_NARROW=1`` admits widths that are not multiples of 128.
"""

from __future__ import annotations

import os

from .int8_attention import (flash_attention_applicable,
                             fused_attention_applicable)

# the batch·heads above which the batched einsums serve small-S attention
BATCH_HEADS_EINSUM_MIN = 128
# the einsum path's logits bytes beyond which a fused kernel serves instead
LOGITS_BYTES_MAX = 256 * 1024 * 1024


def int8_serving(mode) -> bool:
    """'This forward is the int8 deployment graph' (also the attention
    einsum gate)."""
    return mode.int8 and mode.a_quant


def int8_conv_serving(mode, wq, aq, disable_act_quant: bool = False,
                      split: int = 0) -> bool:
    """Gate for the native int8 conv/dense path.  8-bit-weight layers (the
    first/last policy) keep the folded path, since their centered codes can
    leave int8 range; split dual-quantizer layers stay folded too (one conv
    per half would be needed); activations must fit int8 after the L/2
    recentering (act_bit ≤ 8)."""
    return (int8_serving(mode) and not disable_act_quant and split == 0
            and wq.n_bits <= 7 and aq.n_bits <= 8)


def attention_impl(batch: int, heads: int, sq: int, skv: int, c: int) -> str:
    """The int8 serving branch of one attention site: ``'einsum'`` (K2 →
    K3 → K2), ``'fused'`` (K4: self-attention whose (S, S) logits fit the
    gate) or ``'flash'`` (K5: the tiled kernel, SD's 4096-token
    self-attention; the 77-token text context is not tileable and keeps
    the einsum branch)."""
    can_fuse = sq == skv and fused_attention_applicable(sq, c)
    bh = batch * heads
    if bh >= BATCH_HEADS_EINSUM_MIN and 4 * bh * sq * skv <= LOGITS_BYTES_MAX:
        return "einsum"
    if can_fuse:
        return "fused"
    if flash_attention_applicable(sq, skv, c):
        return "flash"
    return "einsum"


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
