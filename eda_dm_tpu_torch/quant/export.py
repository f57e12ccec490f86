"""Deployment export on the port's module state (port of
``eda_dm_tpu/quant/export.py``, serving part).

The JAX package rewrites a ``variables`` tree; here the functions update a
model's ``QConv``/``QDense`` modules in place and return the model:

* :func:`fold_quantized_weights` bakes the hard-AdaRound dequantized
  weights into ``weight``;
* :func:`export_serving` folds, then casts every floating parameter to the
  serving carrier dtype (quantizer buffers stay float32);
* :func:`export_serving_int8` additionally stores, for every layer whose
  weight width gives ≤ 128 levels, the centered integer codes
  ``w{i}_int`` (int8, kernel layout) and their per-channel sums
  ``w{i}_isum`` (float32), computed from the unfolded weights.

Weight widths come from each layer's spec (the bridge checks them against
the JAX tree's ``w{i}_bits``).  The serving modes DEPLOY / DEPLOY_INT8 are
in ``quant/config.py``; DEPLOY_FUSED, which serves the ``export_serving``
weights, is re-exported here, where the JAX package defines it.
"""

from __future__ import annotations

import torch

from ..nn.layers import QConv, QDense
from .config import DEPLOY_FUSED, QuantConfig  # noqa: F401  (re-export)


def _quant_layers(model: torch.nn.Module):
    return [m for m in model.modules() if isinstance(m, (QConv, QDense))]


@torch.no_grad()
def fold_quantized_weights(model: torch.nn.Module, qc: QuantConfig = None):
    del qc  # widths come from the per-layer specs
    for m in _quant_layers(model):
        m.weight.data = m.folded_weight()
    return model


@torch.no_grad()
def export_serving(model: torch.nn.Module, qc: QuantConfig = None,
                   dtype: torch.dtype = torch.bfloat16):
    fold_quantized_weights(model, qc)
    for p in model.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return model


@torch.no_grad()
def export_serving_int8(model: torch.nn.Module, qc: QuantConfig = None,
                        dtype: torch.dtype = torch.bfloat16):
    codes = {m: m.weight_codes() for m in _quant_layers(model)
             if m.wq.n_levels <= 128}            # centered codes fit int8
    export_serving(model, qc, dtype)
    for m, parts in codes.items():
        for name, q, isum in parts:
            setattr(m, f"{name}_int", q)
            setattr(m, f"{name}_isum", isum)
    return model
