"""Quantizer scale initialization over a calibration set (port of
``eda_dm_tpu/calib/scale_init.py``).

``CALIB_W`` computes every weight quantizer's (delta, zp, alpha) from the
weights in one forward; ``CALIB_A`` streams the calibration batches, each
forward running every act quantizer's range search and EMA update on the
live batch and writing its buffers.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..device import model_device
from ..nn.layers import ActQuantizer
from ..quant.config import CALIB_A, CALIB_W


def name_quantizers(model: nn.Module) -> None:
    """Give every act quantizer its module name (what ``static_sides`` keys
    on)."""
    for name, m in model.named_modules():
        if isinstance(m, ActQuantizer):
            m.name = name


@torch.no_grad()
def set_weight_quantize_params(model: nn.Module, cali_data: Sequence[torch.Tensor],
                               batch_size: int = 32, device=None) -> nn.Module:
    """Initialize all weight quantizers: one CALIB_W forward on the first
    ``batch_size`` rows (the weight scales depend on the weights alone)."""
    model_device(model, device)
    model(*(a[:batch_size] for a in cali_data), mode=CALIB_W)
    return model


def host_sides(model: nn.Module) -> tuple:
    """Every act quantizer's frozen ``one_side``, ``((name, side), ...)``,
    for ``QuantMode.static_sides``."""
    name_quantizers(model)
    return tuple(sorted((m.name, int(m.one_side)) for m in model.modules()
                        if isinstance(m, ActQuantizer)))


@torch.no_grad()
def set_act_quantize_params(model: nn.Module, cali_data: Sequence[torch.Tensor],
                            batch_size: int = 256, device=None) -> nn.Module:
    """Initialize the act quantizers by streaming the calibration set in
    batches of ``batch_size`` rows, the last one ragged (no row is
    dropped).  For asymmetric (``a_sym``) configs the sides decided on the
    first batch are passed to the later ones as ``static_sides``."""
    model_device(model, device)
    n = cali_data[0].shape[0]
    batch_size = min(batch_size, n)
    mode = CALIB_A
    aq = getattr(getattr(model, "qc", None), "aq", None)
    hoist = aq is not None and not aq.symmetric
    for start in range(0, n, batch_size):
        model(*(a[start:start + batch_size] for a in cali_data), mode=mode)
        if hoist and mode.static_sides is None:
            mode = mode.replace(static_sides=host_sides(model))
    return model
