"""The port's serving bundle against the JAX package, on the CPU (a tiny
DDPM calibrated by the port; the JAX package gets its tree through
``models/bridge.py``).

* ``pack_int4_codes``: JAX's bytes, an odd count included; ``unpack``
  inverts it, as JAX's does.
* ``serving_bundle`` → ``restore_serving_bundle`` (and ``api.save_bundle``
  → ``api.load_bundle`` through a file) serves DEPLOY_INT8 bit-equal to the
  in-memory ``export_serving_int8``, and leaves the calibrated model as it
  was.
* ``strip_alphas`` replaces every alpha with a ``(1,)`` placeholder and
  changes no DEPLOY_INT8 output.
* The bundle's ``tree_nbytes``, the fp32 bytes and the compression ratio
  equal JAX's on the same calibrated tree.
"""

import copy

import numpy as np
import pytest
import torch

from eda_dm_tpu.quant import QuantConfig as JQC
from eda_dm_tpu.quant import export as jexport
from eda_dm_tpu_torch import api
from eda_dm_tpu_torch.models.bridge import to_jax_variables
from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
from eda_dm_tpu_torch.quant import DEPLOY_INT8, QuantConfig
from eda_dm_tpu_torch.quant import export as texport

TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=16)


@pytest.mark.parametrize("shape", [(5, 3), (4, 3, 3, 7), (1,)])
def test_pack_int4_matches_jax(shape):
    rng = np.random.default_rng(0)
    zp = rng.integers(0, 16, (shape[0],) + (1,) * (len(shape) - 1)).astype(np.float32)
    codes = (rng.integers(0, 16, shape) - zp).astype(np.int8)
    got, gshape = texport.pack_int4_codes(codes, zp)
    want, wshape = jexport.pack_int4_codes(codes, zp)
    assert gshape == wshape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert got.size == -(-int(np.prod(shape)) // 2)
    np.testing.assert_array_equal(texport.unpack_int4_codes(got, gshape, zp), codes)
    np.testing.assert_array_equal(texport.unpack_int4_codes(got, gshape, zp),
                                  jexport.unpack_int4_codes(want, wshape, zp))


@pytest.fixture(scope="module")
def calibrated():
    """A tiny model calibrated by the port, and its JAX tree (the bridge):
    both packages bundle the same state."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 16, 16, 3)).astype(np.float32))
    t = torch.full((4,), 20.0)
    port = DDPMUNet(DDPMConfig(**TINY), QuantConfig(weight_bit=4, act_bit=8),
                    device="cpu", seed=0)
    api.calibrate(port, (x, t), device="cpu")
    return dict(v=to_jax_variables(port), port=port, x=x, t=t)


def _int8(model, c, dtype=torch.bfloat16):
    with torch.no_grad():
        return model(c["x"].to(dtype), c["t"], DEPLOY_INT8)


def test_bundle_serves_like_the_export(calibrated, tmp_path):
    c = calibrated
    before = {k: v.clone() for k, v in c["port"].state_dict().items()}
    ref = _int8(texport.export_serving_int8(copy.deepcopy(c["port"])), c)
    bundle, stats = texport.serving_bundle(c["port"])
    assert all(torch.equal(v, before[k]) for k, v in c["port"].state_dict().items())
    restored = texport.restore_serving_bundle(bundle, device="cpu")
    assert torch.equal(_int8(restored, c), ref)
    assert restored.conv_in.w0_int.dtype == torch.int8
    assert "conv_in.weight" not in bundle["params"] and "conv_in.w0_pack" in bundle["quant"]
    assert "temb_dense_0.weight" in bundle["params"]          # 8-bit: folded only
    # through a file, by the api verbs
    saved = api.save_bundle(c["port"], c["port"].qc, str(tmp_path / "b.pt"))
    assert saved == stats
    loaded, mode = api.load_bundle(str(tmp_path / "b.pt"), device="cpu")
    assert mode == DEPLOY_INT8 and torch.equal(_int8(loaded, c), ref)
    exported, mode = api.export_for_serving(c["port"], c["port"].qc, kind="int8")
    assert mode == DEPLOY_INT8 and torch.equal(_int8(exported, c), ref)


def test_strip_alphas(calibrated):
    c = calibrated
    model = texport.export_serving_int8(copy.deepcopy(c["port"]))
    ref = _int8(model, c)
    texport.strip_alphas(model)
    assert all(getattr(m, f"{n}_alpha").shape == (1,) for m in texport._quant_layers(model)
               for n, _, _ in m._parts)
    assert torch.equal(_int8(model, c), ref)
    lean, _ = api.export_for_serving(c["port"], c["port"].qc, kind="bf16")
    assert lean.conv_in.w0_alpha.shape == (1,)
    assert c["port"].conv_in.w0_alpha.shape == c["port"].conv_in.weight.shape


def test_bundle_bytes_match_jax(calibrated):
    c = calibrated
    jb, jstats = jexport.serving_bundle(c["v"], JQC(weight_bit=4, act_bit=8))
    tb, tstats = texport.serving_bundle(c["port"])
    assert tstats["fp32_bytes"] == jstats["fp32_bytes"]
    assert tstats["bundle_bytes"] == jstats["bundle_bytes"] == jexport.tree_nbytes(jb)
    assert tstats["compression"] == pytest.approx(jstats["compression"], rel=1e-12)
    assert texport.tree_nbytes({k: tb[k] for k in ("params", "quant")}) == tstats["bundle_bytes"]


def test_calibration_entry_points_need_the_card_or_cpu():
    """The calibration entry points take ``device=None`` as the card: on a
    host without one they raise unless given ``"cpu"``; a checkpoint path
    goes through the converters (a missing file raises), and reconstruct
    an ``LDMUNet`` over its own plan."""
    from eda_dm_tpu_torch.calib.recon import ReconArgs
    from eda_dm_tpu_torch.calib.scale_init import set_weight_quantize_params
    from eda_dm_tpu_torch.models.ldm_unet import LDMUNet, LDMUNetConfig
    from eda_dm_tpu_torch.pipelines.cifar import CifarConfig, CifarPipeline
    tiny = DDPMConfig(ch=32, ch_mult=(1,), num_res_blocks=1, attn_resolutions=(),
                      resolution=8)
    model = api.quantize_model("ddpm", tiny, device="cpu")
    cali = (torch.zeros(2, 8, 8, 3), torch.zeros(2))
    if not torch.cuda.is_available():
        for call in (lambda: CifarPipeline(CifarConfig(arch=tiny)),
                     lambda: api.quantize_model("ddpm", tiny),
                     lambda: api.calibrate(model, cali),
                     lambda: api.reconstruct(model, cali),
                     lambda: set_weight_quantize_params(model, cali)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    ldm = api.quantize_model("ldm", LDMUNetConfig(image_size=8, model_channels=32,
                                                  channel_mult=(1,), num_res_blocks=1,
                                                  attention_resolutions=(),
                                                  num_head_channels=8), device="cpu")
    assert isinstance(ldm, LDMUNet)
    done = []
    api.reconstruct(ldm, cali, args=ReconArgs(iters=1, batch_size=2), device="cpu",
                    progress=lambda name, loss: done.append(name))
    assert done[0] == "time_embed_0" and done[-1] == "out_2"
    with pytest.raises(FileNotFoundError):
        api.quantize_model("ddpm", tiny, ckpt_path="x.ckpt", device="cpu")
    with pytest.raises(FileNotFoundError):
        CifarPipeline(CifarConfig(arch=tiny, ckpt_path="x.ckpt"), device="cpu").init_variables()
