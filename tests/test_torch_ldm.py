"""The port's LDM UNet vs the JAX package on a JAX-calibrated tiny model.

Tiny config: image 16, 32 channels, channel_mult (1, 2), one res block per
level, attention at both levels (heads of 8 channels).  The JAX tree goes
CALIB_W → CALIB_A → export once per module; the port gets it through
``models/bridge.py`` and runs on the CPU (the kernels' plain versions).

Tolerances, as in ``tests/test_torch_ddpm.py``: the FP forward atol 1e-4;
in the quantized modes every act quantizer, GroupNorm, conv and dense on
JAX's input, and the ops between them, within rtol = atol = 2e-5 of JAX
(the attention output may differ where a softmax code flips on a tie:
``_against_jax(..., attn_code_flips=True)``); run freely, the
first act code that differs sits on a rounding tie (its quantizer's input
within 2e-5 of JAX's); the whole output median |Δ| < 2e-4 and max < 0.15,
and the share with |Δ| < 2e-4 above 0.7 where no code flips, else the mean
drift no larger than JAX's own DEPLOY-vs-DEPLOY_INT8 drift.  DEPLOY_INT8
is held on both attention branches: at batch 2 both packages take the
fused one (K4's plain version, the Pallas kernel in interpret mode); the
einsum one (K2 → K3 → K2 on the heads layout) by ``EDM_FUSED_ATTN=0``, set
once for both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.models import ldm_unet as jldm
from eda_dm_tpu.quant import CALIB_A, CALIB_W, FP as JFP, QuantConfig as JQC
from eda_dm_tpu.quant import export as jexport
from eda_dm_tpu_torch.models import ldm_unet as tldm
from eda_dm_tpu_torch.models.bridge import load_jax_variables, to_jax_variables
from eda_dm_tpu_torch.quant import DEPLOY, DEPLOY_INT8, FP, QuantConfig
from eda_dm_tpu_torch.quant.export import export_serving_int8

from test_torch_ddpm import _against_jax, _flip_gate, _np

TINY = dict(image_size=16, in_channels=3, model_channels=32, out_channels=3,
            num_res_blocks=1, attention_resolutions=(1, 2),
            channel_mult=(1, 2), num_head_channels=8)
CFG, JCFG = tldm.LDMUNetConfig(**TINY), jldm.LDMUNetConfig(**TINY)
QC, JQC_ = QuantConfig(weight_bit=4, act_bit=8), JQC(weight_bit=4, act_bit=8)


def _calibrate(module, *args, jit_init=False):
    """JAX init → CALIB_W → CALIB_A on ``args``; returns the tree.  With
    ``jit_init`` the init is one compiled program: the tiny UNet's tree
    equals the op-by-op init's bit for bit, in a third of the time."""
    if jit_init:
        v = jax.jit(lambda k, *a: module.init(k, *a, mode=JFP))(jax.random.PRNGKey(0),
                                                                *args)
    else:
        v = module.init(jax.random.PRNGKey(0), *args, mode=JFP)
    for mode in (CALIB_W, CALIB_A):
        _, upd = jax.jit(lambda v: module.apply(v, *args, mode=mode,
                                                mutable=["quant"]))(v)
        v = {**v, "quant": upd["quant"]}
    return v


@pytest.fixture(scope="module")
def calibrated():
    model = jldm.LDMUNet(cfg=JCFG, qc=JQC_)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 16, 16, 3)), jnp.float32)
    t = jnp.asarray([20.0, 600.0])
    v = _calibrate(model, x, t, jit_init=True)
    return dict(model=model, v=v, x=x, t=t,
                int8=jexport.export_serving_int8(v, JQC_, dtype=jnp.float32))


def _port(tree):
    return load_jax_variables(tldm.LDMUNet(CFG, QC, device="cpu"), _np(tree))


def test_fp_forward(calibrated):
    c = calibrated
    ref = np.asarray(c["model"].apply(c["v"], c["x"], c["t"], mode=JFP))
    with torch.no_grad():
        out = _port(c["v"])(torch.from_numpy(np.array(c["x"])),
                            torch.from_numpy(np.array(c["t"])), mode=FP)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_deploy_forward(calibrated):
    c = calibrated
    tree = jexport.export_serving(c["v"], JQC_, dtype=jnp.float32)
    ref, out, flips = _against_jax(c["model"], tree, _port(tree), c["x"],
                                   c["t"], jexport.DEPLOY, DEPLOY)
    _flip_gate(out, ref, 0.15, share=flips == 0)
    jax_int8 = np.asarray(c["model"].apply(c["int8"], c["x"], c["t"],
                                           mode=jexport.DEPLOY_INT8))
    assert np.abs(out - ref).mean() <= np.abs(jax_int8 - ref).mean()


@pytest.mark.parametrize("branch", ["fused", "einsum"])
def test_deploy_int8_forward(calibrated, branch, monkeypatch):
    """DEPLOY_INT8 on each attention branch: the default (fused at batch
    2) and ``EDM_FUSED_ATTN=0`` (einsum), set once for both packages;
    spies count each package's attention-kernel calls."""
    c = calibrated
    port = _port(c["int8"])
    seen = {}
    for side, module, names in (
            ("jax", jldm, ("int8_fused_attention_heads", "int8_flash_attention_heads",
                           "softmax_int8_codes")),
            ("port", tldm, ("int8_fused_attention_heads", "int8_flash_attention_heads",
                            "softmax_codes"))):
        for name in names:
            impl = "einsum" if "softmax" in name else name.split("_")[1]
            fn = getattr(module, name)

            def spy(*a, _fn=fn, _key=(side, impl), **k):
                seen[_key] = seen.get(_key, 0) + 1
                return _fn(*a, **k)
            monkeypatch.setattr(module, name, spy)
    if branch == "einsum":
        monkeypatch.setenv("EDM_FUSED_ATTN", "0")
    ref, out, flips = _against_jax(c["model"], c["int8"], port, c["x"],
                                   c["t"], jexport.DEPLOY_INT8, DEPLOY_INT8,
                                   attn_code_flips=True)
    # seven attention sites; the port runs twice (forced, then free)
    assert seen == {("jax", branch): 7, ("port", branch): 14}, seen
    assert out.shape == ref.shape and np.isfinite(out).all()
    _flip_gate(out, ref, 0.15, share=flips == 0)
    if flips:
        folded = np.asarray(c["model"].apply(
            jexport.export_serving(c["v"], JQC_, dtype=jnp.float32), c["x"],
            c["t"], mode=jexport.DEPLOY))
        assert np.abs(out - ref).mean() <= np.abs(folded - ref).mean()


@pytest.mark.parametrize("updown", ["down", "up"])
def test_resblock_scale_shift_updown(updown):
    """One ResBlockL with scale-shift norm and a resampling path, its own
    JAX calibration and int8 export, on a shared input: DEPLOY_INT8 within
    rtol = atol = 2e-5 (f32 association only)."""
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((2, 8, 8, 32)), jnp.float32)
    emb = jnp.asarray(rng.standard_normal((2, 128)), jnp.float32)
    jblk = jldm.ResBlockL(64, JQC_.wq, JQC_.aq, use_scale_shift_norm=True,
                          updown=updown)
    tree = jexport.export_serving_int8(_calibrate(jblk, x, emb), JQC_,
                                       dtype=jnp.float32)
    ref = jblk.apply(tree, x, emb, mode=jexport.DEPLOY_INT8)
    blk = tldm.ResBlockL(32, 64, 128, QC.wq, QC.aq, use_scale_shift_norm=True,
                         updown=updown)
    load_jax_variables(blk, _np(tree))
    with torch.no_grad():
        out = blk(torch.from_numpy(np.array(x)), torch.from_numpy(np.array(emb)),
                  DEPLOY_INT8)
    assert out.shape == ref.shape == (2, 4 if updown == "down" else 16,
                                      4 if updown == "down" else 16, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_bridge_round_trip(calibrated):
    """The port's own export of the calibrated tree equals JAX's export
    leaf by leaf, and a dumped tree loads back to the same module state."""
    c = calibrated
    ref = _np(jexport.export_serving_int8(c["v"], JQC_, dtype=jnp.bfloat16))
    port = _port(c["v"])
    export_serving_int8(port, QC, torch.bfloat16)
    got = to_jax_variables(port)

    def walk(g, r, path):
        for k, rv in r.items():
            if isinstance(rv, dict):
                walk(g[k], rv, f"{path}/{k}")
            elif k not in ("running_min", "running_max", "one_side", "inited"):
                rv = np.asarray(rv)
                np.testing.assert_array_equal(
                    g[k], rv.astype(np.float32) if rv.dtype.name == "bfloat16"
                    else rv, err_msg=f"{path}/{k}")

    walk(got["params"], ref["params"], "params")
    walk(got["quant"], ref["quant"], "quant")
    assert "w0_int" in got["quant"]["input_blocks_1_0"]["in_layers_2"]
    assert "w0_int" not in got["quant"]["time_embed_0"]        # 8-bit first
    assert "w0_int" not in got["quant"]["out_2"]               # 8-bit last
    back = load_jax_variables(tldm.LDMUNet(CFG, QC, device="cpu"), got)
    state = dict(back.state_dict())
    for name, t in port.state_dict().items():
        assert state[name] is not None and torch.equal(
            state[name].float(), t.float()), name


def test_misplaced_mode_and_flash_site_raise(calibrated, monkeypatch):
    """A QuantMode passed where ``context`` goes raises.  A site forced onto
    K5 (``'flash'``, whose plain version is K4's plain function chunked
    over query rows) gives the fused branch's output bit for bit."""
    model = tldm.LDMUNet(CFG, QC, device="cpu")
    x, t = torch.zeros(1, 16, 16, 3), torch.zeros(1)
    with pytest.raises(TypeError, match="positional order"):
        model(x, t, DEPLOY_INT8)
    port = _port(calibrated["int8"])
    x = torch.from_numpy(np.array(calibrated["x"]))
    t = torch.from_numpy(np.array(calibrated["t"]))
    seen = []

    def forced(impl):
        def spy(*site):
            seen.append(impl)
            return impl
        return spy
    with torch.no_grad():
        monkeypatch.setattr(tldm, "attention_impl", forced("fused"))
        fused = port(x, t, mode=DEPLOY_INT8)
        monkeypatch.setattr(tldm, "attention_impl", forced("flash"))
        flash = port(x, t, mode=DEPLOY_INT8)
    assert seen.count("flash") == seen.count("fused") == 7
    assert torch.equal(flash, fused)


def test_bedroom_layout():
    """The full LSUN-Bedroom UNet's layout, built without weights: its
    attention sites and their branches at the task batch of 50."""
    from eda_dm_tpu_torch.models.latent_diffusion import bedroom_config
    cfg = bedroom_config().unet
    lay = tldm.build_layout(cfg, True)
    jlay = jldm.build_layout(jldm.LDMUNetConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__}), True)
    for part in ("input_blocks", "middle_block", "output_blocks"):
        assert ([vars(i) for i in getattr(lay, part)]
                == [vars(i) for i in getattr(jlay, part)])
    res = {224: 64, 448: 32, 672: 16, 896: 8}
    sites = [(it.heads, res[it.out_ch], it.dim_head)
             for part in ("input_blocks", "middle_block", "output_blocks")
             for it in getattr(lay, part) if it.kind == "attn"]
    branches = [tldm.attention_impl(50, h, r * r, r * r, d) for h, r, d in sites]
    assert branches.count("fused") == 10 and branches.count("einsum") == 6


def test_sd_layout():
    """The full SD v1.4 UNet's layout, built without weights: its 16
    spatial-transformer sites against the JAX layout, and their self-
    attention branches at the CFG batch of 8 rows (4 prompts): K5 at the
    five 64×64 sites, K4 at the 32×32, 16×16 and 8×8 ones; every
    cross-attention over the 77 text tokens takes K2 → K3 → K2, in both
    packages' policies."""
    from eda_dm_tpu.models.latent_diffusion import sd_v1_config as jsd
    from eda_dm_tpu.ops import serving_policy as jpolicy
    from eda_dm_tpu_torch.models.latent_diffusion import sd_v1_config
    cfg = sd_v1_config().unet
    assert cfg == tldm.LDMUNetConfig(**{
        f: getattr(jsd().unet, f) for f in cfg.__dataclass_fields__})
    lay = tldm.build_layout(cfg, True)
    jlay = jldm.build_layout(jsd().unet, True)
    for part in ("input_blocks", "middle_block", "output_blocks"):
        assert ([vars(i) for i in getattr(lay, part)]
                == [vars(i) for i in getattr(jlay, part)])
    res = {320: 64, 640: 32, 1280: 16}
    sites = [(it.heads, it.dim_head, 8 if part == "middle_block" else res[it.out_ch])
             for part in ("input_blocks", "middle_block", "output_blocks")
             for it in getattr(lay, part) if it.kind == "tx"]
    assert len(sites) == 16 and all(h == 8 for h, _, _ in sites)
    self_attn = [tldm.attention_impl(8, h, r * r, r * r, d) for h, d, r in sites]
    assert self_attn == [jpolicy.attention_impl(8, h, r * r, r * r, d)
                         for h, d, r in sites]
    assert self_attn.count("flash") == 5 and self_attn.count("fused") == 11
    assert {tldm.attention_impl(8, h, r * r, 77, d) for h, d, r in sites} \
        == {jpolicy.attention_impl(8, h, r * r, 77, d) for h, d, r in sites} \
        == {"einsum"}
