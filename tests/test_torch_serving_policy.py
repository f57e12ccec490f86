"""The port's serving policy (``ops/serving_policy.py``) against the JAX
package's under one environment.

Each case sets the JAX package's serving switches with
``monkeypatch.setenv`` (nothing of the port's policy is patched) and asks
both packages the same questions: the attention branch of every serving
site of the CIFAR, bedroom and SD UNets and of a few edge shapes
(``attention_impl``), whether the softmax-codes kernel serves
(``use_fused_softmax``), whether a conv or dense takes the int8 path
(``int8_conv_serving``, over modes, bit widths, a disabled act quantizer
and a split layer), whether an attention site does
(``int8_attention_serving``), and which export a family serves
(``preferred_export_kind``).  Every answer must be JAX's.
"""

import pytest

from eda_dm_tpu.nn import layers as jlayers
from eda_dm_tpu.ops import int8_einsum as jeinsum
from eda_dm_tpu.ops import serving_policy as jpolicy
from eda_dm_tpu.quant import FP as JFP
from eda_dm_tpu.quant import QuantizerSpec as JSpec
from eda_dm_tpu.quant import export as jexport
from eda_dm_tpu_torch.ops import serving_policy as policy
from eda_dm_tpu_torch.quant import (DEPLOY, DEPLOY_FUSED, DEPLOY_INT8, FP,
                                    QuantizerSpec)

SWITCHES = ["EDM_FUSED_ATTN", "EDM_FUSED_ATTN_NARROW", "EDM_FUSED_SOFTMAX",
            "EDM_INT8_CONV", "EDM_INT8_ATTN", "EDM_SERVE_KIND", "EDM_FUSED_GN",
            "EDM_FUSED_GN_NARROW"]

SETTINGS = [
    {},
    {"EDM_FUSED_ATTN": "0"},
    {"EDM_FUSED_ATTN": "1"},
    {"EDM_FUSED_ATTN_NARROW": "0"},
    {"EDM_FUSED_ATTN": "1", "EDM_FUSED_ATTN_NARROW": "0"},
    {"EDM_FUSED_SOFTMAX": "0"},
    {"EDM_FUSED_SOFTMAX": "1"},
    {"EDM_INT8_CONV": "0"},
    {"EDM_INT8_ATTN": "0"},
    {"EDM_SERVE_KIND": "int8"},
    {"EDM_SERVE_KIND": "bf16"},
]

# (batch, heads, sq, skv, head width): CIFAR at batch 500 and 8 (16x16 and
# the 4x4 mid block), the tiny test models, the bedroom's three levels at
# batch 50, SD's self- and cross-attention levels at 8 rows, and shapes
# past each kernel's gate
SITES = [(500, 1, 256, 256, 256), (500, 1, 16, 16, 256), (8, 1, 256, 256, 256),
         (4, 1, 64, 64, 64), (2, 4, 256, 256, 8), (50, 7, 1024, 1024, 32),
         (50, 14, 256, 256, 32), (50, 28, 64, 64, 32), (8, 8, 4096, 4096, 40),
         (8, 8, 4096, 77, 40), (8, 8, 1024, 1024, 80), (8, 8, 256, 256, 160),
         (8, 8, 64, 64, 160), (2, 1, 4096, 4096, 128), (2, 1, 1024, 512, 128),
         (1, 1, 77, 77, 128), (2, 1, 8192, 8192, 128)]

MODES = [(FP, JFP), (DEPLOY, jexport.DEPLOY), (DEPLOY_FUSED, jexport.DEPLOY_FUSED),
         (DEPLOY_INT8, jexport.DEPLOY_INT8)]


@pytest.mark.parametrize("setting", SETTINGS,
                         ids=lambda s: ",".join(f"{k}={v}" for k, v in s.items()) or "unset")
def test_policy_matches_jax(setting, monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in setting.items():
        monkeypatch.setenv(name, value)
    branches = {site: policy.attention_impl(*site) for site in SITES}
    assert branches == {site: jpolicy.attention_impl(*site) for site in SITES}
    assert policy.use_fused_softmax() == jpolicy.use_fused_softmax()
    assert policy.narrow_lanes_allowed() == jpolicy.narrow_lanes_allowed()
    for mode, jmode in MODES:
        assert policy.int8_attention_serving(mode) == jeinsum.int8_attention_serving(jmode)
        assert policy.int8_serving(mode) == jpolicy.int8_serving(jmode)
        for wbits in (4, 8):
            for abits in (8, 16):
                for disable in (False, True):
                    for split in (0, 32):
                        got = policy.int8_conv_serving(
                            mode, QuantizerSpec(n_bits=wbits), QuantizerSpec(n_bits=abits),
                            disable, split)
                        want = jlayers.int8_conv_serving(
                            jmode, JSpec(n_bits=wbits), JSpec(n_bits=abits), disable, split)
                        assert got == want, (mode, wbits, abits, disable, split)
    for tx in (False, True):
        assert policy.preferred_export_kind(tx) == jpolicy.preferred_export_kind(tx)
    # what each switch does, beyond agreeing
    if setting.get("EDM_FUSED_ATTN") == "0" or setting.get("EDM_INT8_ATTN") == "0":
        if "EDM_FUSED_ATTN" in setting:
            assert set(branches.values()) == {"einsum"}
        else:
            assert not policy.int8_attention_serving(DEPLOY_INT8)
    if setting == {"EDM_FUSED_ATTN": "0"}:
        assert branches[(4, 1, 64, 64, 64)] == "einsum"     # batch·heads < 128
    if setting == {}:
        assert branches[(4, 1, 64, 64, 64)] == "fused"
        assert branches[(8, 8, 4096, 4096, 40)] == "flash"
    if setting.get("EDM_FUSED_ATTN_NARROW") == "0":
        assert branches[(50, 7, 1024, 1024, 32)] != "fused"
    if setting == {"EDM_INT8_CONV": "0"}:
        assert not policy.int8_conv_serving(DEPLOY_INT8, QuantizerSpec(n_bits=4),
                                            QuantizerSpec(n_bits=8))
        assert policy.int8_attention_serving(DEPLOY_INT8)
