"""Static quantization configuration (port of ``eda_dm_tpu/quant/config.py``).

Frozen dataclasses select which forward a module runs; they never hold
runtime state.  Quantizer state (scales, zero-points, AdaRound alphas,
integer weight codes) lives in buffers on the modules.  The serving slice
carries only the fields serving reads; the calibration knobs (search
method, QDrop probability, EMA, the calibration modes) come with the
calibration slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QuantizerSpec:
    """Static description of one uniform affine quantizer."""

    n_bits: int = 8
    always_zero: bool = False    # force zero_point = 0

    @property
    def n_levels(self) -> int:
        return 2 ** self.n_bits

    def with_bits(self, n_bits: int) -> "QuantizerSpec":
        return dataclasses.replace(self, n_bits=n_bits)


@dataclasses.dataclass(frozen=True)
class QuantMode:
    """Which forward runs: FP (all False), DEPLOY (act fake-quant on
    folded weights), DEPLOY_FUSED (DEPLOY with the act fake-quant of every
    1×1 conv and dense fused into its matmul, kernel K7) or DEPLOY_INT8
    (native int8 on exported codes)."""

    a_quant: bool = False
    fused: bool = False
    int8: bool = False


FP = QuantMode()
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
    split: bool = True           # split shortcut-concat quantization

    @property
    def wq(self) -> QuantizerSpec:
        return QuantizerSpec(n_bits=self.weight_bit)

    @property
    def aq(self) -> QuantizerSpec:
        return QuantizerSpec(n_bits=self.act_bit)

    def aq_softmax(self, always_zero: bool = True) -> QuantizerSpec:
        """Quantizer spec for softmax attention weights (sm_abit bits)."""
        return QuantizerSpec(n_bits=self.sm_abit, always_zero=always_zero)
