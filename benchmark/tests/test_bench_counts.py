"""The operation and byte counts behind ``mfu`` and
``int8_conv_roofline``, held to a hand count of a tiny DDPM UNet's
forward: the shape hooks on the program's served model, as a traced run
installs them, against the layers listed by hand."""

import pytest
import torch

from benchmark.lib import counts

N = 2
TABLE = {"QConv": "conv", "QDense": "dense", "AttnBlockD": "pixel_attention"}
# ch 32, ch_mult (1, 2), one res block, attention at 4x4, 8x8 images.
# (h_out, w_out, cin, cout, k, on K1): every conv of the forward in order
CONVS = [
    (8, 8, 3, 32, 3, True),                                  # conv_in
    (8, 8, 32, 32, 3, True), (8, 8, 32, 32, 3, True),        # down 0 block 0
    (4, 4, 32, 32, 3, True),                                 # down 0 downsample (stride 2)
    (4, 4, 32, 64, 3, True), (4, 4, 64, 64, 3, True), (4, 4, 32, 64, 1, True),  # down 1 block 0
    *[(4, 4, 64, 64, 1, True)] * 4,                          # down 1 attention q k v proj_out
    (4, 4, 64, 64, 3, True), (4, 4, 64, 64, 3, True),        # mid block 1
    *[(4, 4, 64, 64, 1, True)] * 4,                          # mid attention
    (4, 4, 64, 64, 3, True), (4, 4, 64, 64, 3, True),        # mid block 2
    (4, 4, 128, 64, 3, True), (4, 4, 64, 64, 3, True), (4, 4, 128, 64, 1, False),  # up 1 block 0 (split)
    *[(4, 4, 64, 64, 1, True)] * 4,
    (4, 4, 96, 64, 3, True), (4, 4, 64, 64, 3, True), (4, 4, 96, 64, 1, False),    # up 1 block 1
    *[(4, 4, 64, 64, 1, True)] * 4,
    (8, 8, 64, 64, 3, True),                                 # up 1 upsample
    (8, 8, 96, 32, 3, True), (8, 8, 32, 32, 3, True), (8, 8, 96, 32, 1, False),    # up 0 block 0
    (8, 8, 64, 32, 3, True), (8, 8, 32, 32, 3, True), (8, 8, 64, 32, 1, False),    # up 0 block 1
    (8, 8, 32, 3, 3, False),                                 # conv_out (8-bit, input unquantized)
]
DENSES = [(32, 128), (128, 128)] + [(128, c) for c in (32, 64, 64, 64, 64, 64, 32, 32)]
ATTENTION = [(16, 64)] * 4                                   # (tokens, width), one head


def hand_macs():
    conv = sum(N * h * w * cout * k * k * cin for h, w, cin, cout, k, _ in CONVS)
    dense = sum(N * i * o for i, o in DENSES)
    attn = sum(2 * N * s * s * d for s, d in ATTENTION)
    return conv + dense + attn


def hand_k1_bytes():
    total = 0
    for h, w, cin, cout, k, on in CONVS:
        if not on:
            continue
        stride = 2 if (h, w, cin, cout, k) == (4, 4, 32, 32, 3) else 1
        hin, win = h * stride, w * stride
        total += (N * hin * win * cin + cout * k * k * cin + 12 * cout
                  + (4 * h * w * cout if k == 3 else 0) + 2 * N * h * w * cout)
    return total


@pytest.fixture(scope="module")
def calls():
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
    from eda_dm_tpu_torch.quant import DEPLOY_INT8
    from eda_dm_tpu_torch.quant.export import export_serving_int8
    torch.manual_seed(0)
    cfg = DDPMConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(4,), resolution=8)
    model = DDPMUNet(cfg, device="cpu", seed=0)
    export_serving_int8(model)
    log = counts.ShapeLog(model, TABLE)
    log.on = True
    with torch.no_grad():
        model(torch.randn(N, 8, 8, 3).bfloat16(), torch.full((N,), 10.0), DEPLOY_INT8)
    log.remove()
    return log.calls


def test_layers_seen(calls):
    assert [(c["ho"], c["wo"], c["cin"], c["cout"], c["kh"], c["k1"])
            for c in calls if c["kind"] == "conv"] == [tuple(v) for v in CONVS]


def test_macs_match_hand_count(calls):
    assert sum(counts.macs(c) for c in calls) == hand_macs()


def test_k1_bytes_match_hand_count(calls):
    assert sum(counts.k1_bytes(c) for c in counts.k1_calls(calls)) == hand_k1_bytes()


def test_attention_macs_count_both_products():
    assert counts.attention_macs(2, 8, 4096, 77, 40) == 2 * 2 * 8 * 4096 * 77 * 40
