"""Serving gates for the quantized deployment path (port of
``eda_dm_tpu/ops/serving_policy.py`` and the int8 gates beside it).

The TPU package's thresholds and environment switches do not carry over:
each dispatch choice is measured anew on the card.  With the serving
slice's modes (FP, DEPLOY, DEPLOY_INT8) the JAX package's
``int8_serving`` and ``int8_attention_serving`` are the same predicate.
"""

from __future__ import annotations


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
