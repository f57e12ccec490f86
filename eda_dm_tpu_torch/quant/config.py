"""Static quantization configuration (port of ``eda_dm_tpu/quant/config.py``).

Frozen dataclasses select which forward a module runs; they never hold
runtime state.  Quantizer state (scales, zero-points, AdaRound alphas, EMA
ranges, integer weight codes) lives in buffers on the modules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QuantizerSpec:
    """Static description of one uniform affine quantizer."""

    n_bits: int = 8
    symmetric: bool = False      # symmetric *search range*; zero-point stays affine
    channel_wise: bool = False   # per-output-channel (weights) vs per-tensor (acts)
    scale_method: str = "mse"    # 'mse' (search) or 'max'
    leaf_param: bool = False     # activation quantizer: EMA running range
    always_zero: bool = False    # force zero_point = 0 (softmax outputs)
    prob: float = 1.0            # QDrop bypass probability during reconstruction
    num_candidates: int = 100    # thresholds in the MSE grid search
    # activations with more than 4·search_bins elements are scored on an
    # exact histogram of search_bins bins (0 = always on the raw tensor)
    search_bins: int = 4096

    @property
    def n_levels(self) -> int:
        return 2 ** self.n_bits

    def with_bits(self, n_bits: int) -> "QuantizerSpec":
        return dataclasses.replace(self, n_bits=n_bits)


@dataclasses.dataclass(frozen=True)
class QuantMode:
    """Which forward runs.  Calibration: CALIB_W (weight scales and AdaRound
    alphas from the weights), CALIB_A (act-range search and EMA on the live
    batch), WQ / WAQ (weight / weight+act fake-quant), and in
    reconstruction ``soft_targets`` (soft AdaRound), ``training`` (QDrop)
    and ``capture``.  Serving: FP (all False), DEPLOY (act fake-quant on
    folded weights), DEPLOY_FUSED (DEPLOY with the act fake-quant of every
    1×1 conv and dense fused into its matmul, kernel K7) and DEPLOY_INT8
    (native int8 on exported codes)."""

    w_quant: bool = False        # fake-quantize weights
    a_quant: bool = False        # fake-quantize activations
    calib_w: bool = False        # weight-scale MSE search, writes the buffers
    calib_a: bool = False        # act-scale MSE search + EMA, writes the buffers
    soft_targets: bool = False   # AdaRound soft rounding (target under reconstruction)
    training: bool = False       # QDrop stochastic bypass (needs a generator)
    capture: bool = False        # a capture forward (taps are forward hooks)
    fused: bool = False          # serving: fused quantize+matmul (K7)
    int8: bool = False           # serving: native int8 on exported codes
    # ((quantizer name, side), ...): act one-sidedness frozen after the
    # first calibration batch (calib/scale_init.py::host_sides)
    static_sides: Optional[tuple] = None

    def replace(self, **kw) -> "QuantMode":
        return dataclasses.replace(self, **kw)


FP = QuantMode()
CALIB_W = QuantMode(w_quant=True, calib_w=True)
CALIB_A = QuantMode(w_quant=True, a_quant=True, calib_a=True)
WQ = QuantMode(w_quant=True)
WAQ = QuantMode(w_quant=True, a_quant=True)
# serving after folding: activations quantize, weights are pre-baked
DEPLOY = QuantMode(a_quant=True)
# folded weights; 1×1 convs and denses quantize their input inside the
# matmul's tile load (requires export_serving)
DEPLOY_FUSED = QuantMode(a_quant=True, fused=True)
# native int8 path: integer weight codes + int8 act codes feed the int8
# conv / matmul kernels (requires export_serving_int8)
DEPLOY_INT8 = QuantMode(a_quant=True, int8=True)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Model-level quantization settings (the reference CLI's knob names)."""

    weight_bit: int = 4
    act_bit: int = 8
    sm_abit: int = 8             # softmax-output activation bits
    a_sym: bool = False          # if True quantizers use the asymmetric (2-D) search
    quant_act: bool = True
    split: bool = True           # split shortcut-concat quantization
    prob: float = 0.5            # QDrop probability for act quantizers

    @property
    def wq(self) -> QuantizerSpec:
        return QuantizerSpec(n_bits=self.weight_bit, symmetric=not self.a_sym,
                             channel_wise=True, scale_method="mse")

    @property
    def aq(self) -> QuantizerSpec:
        return QuantizerSpec(n_bits=self.act_bit, symmetric=not self.a_sym,
                             channel_wise=False, scale_method="mse",
                             leaf_param=self.quant_act, prob=self.prob)

    def aq_softmax(self, always_zero: bool = True,
                   symmetric: Optional[bool] = None) -> QuantizerSpec:
        """Quantizer spec for softmax attention weights (sm_abit bits)."""
        spec = self.aq.with_bits(self.sm_abit)
        sym = spec.symmetric if symmetric is None else symmetric
        return dataclasses.replace(spec, always_zero=always_zero, symmetric=sym)
