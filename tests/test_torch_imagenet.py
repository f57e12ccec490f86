"""The port's class-conditional pieces (ImageNet cin256-v2) vs the JAX
package, on the CPU.

* ``ClassEmbedder``: the JAX embedder's table through the bridge, the
  (B, 1, embed_dim) contexts equal, the unconditional label included;
  the table back through ``to_jax_variables`` equal.
* A tiny class-conditional spatial-transformer UNet (one head, a
  one-token context of 16 from the embedder, 11 labels), JAX-calibrated
  once per file with the contexts of [uncond; cond] rows: FP within 1e-4;
  DEPLOY and DEPLOY_INT8 through ``_against_jax`` of
  ``tests/test_torch_ddpm.py`` (every act quantizer, norm, conv and dense
  on JAX's input within rtol = atol = 2e-5, the flip-aware whole-output
  gate), the cross-attention over the one key through K2 → K3 → K2 with
  rows of width 1.
* A tiny ``num_classes`` UNet (``label_emb`` added to the timestep
  embedding): FP within 1e-4 and DEPLOY_INT8 through ``_against_jax``,
  its tree (``label_emb.embedding``) both ways through the bridge.
* ``imagenet_config()`` equal to JAX's field by field, and the full UNet's
  layout and attention routes at the task's 100 UNet rows (50 labels
  under guidance), built without weights.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.models import encoders as jenc
from eda_dm_tpu.models import latent_diffusion as jld
from eda_dm_tpu.models import ldm_unet as jldm
from eda_dm_tpu.ops import serving_policy as jpolicy
from eda_dm_tpu.quant import CALIB_A, CALIB_W, FP as JFP, QuantConfig as JQC
from eda_dm_tpu.quant import export as jexport
from eda_dm_tpu_torch.models import latent_diffusion as tld
from eda_dm_tpu_torch.models import ldm_unet as tldm
from eda_dm_tpu_torch.models.bridge import load_jax_variables, to_jax_variables
from eda_dm_tpu_torch.models.encoders import ClassEmbedder
from eda_dm_tpu_torch.quant import DEPLOY, DEPLOY_INT8, FP, QuantConfig

from test_torch_ddpm import _against_jax, _against_jax_args, _flip_gate, _np

QC, JQC_ = QuantConfig(weight_bit=4, act_bit=8), JQC(weight_bit=4, act_bit=8)
N_CLASSES, EMBED = 11, 16
TINY = dict(image_size=8, in_channels=3, model_channels=32, out_channels=3,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_heads=1, use_spatial_transformer=True, context_dim=EMBED)
LABELED = dict(image_size=8, in_channels=3, model_channels=32, out_channels=3,
               num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
               num_head_channels=16, num_classes=N_CLASSES)
LABELS = np.array([3, 7], np.int32)
UNCOND = np.full((2,), N_CLASSES - 1, np.int32)


def _jit_calibrate(module, *args):
    """JAX init → CALIB_W → CALIB_A on ``args`` (jitted, the inputs as
    arguments); returns the tree."""
    v = jax.jit(lambda k, *a: module.init(k, *a, mode=JFP))(jax.random.PRNGKey(0),
                                                            *args)
    for mode in (CALIB_W, CALIB_A):
        _, upd = jax.jit(lambda v, *a: module.apply(v, *a, mode=mode,
                                                    mutable=["quant"]))(v, *args)
        v = {**v, "quant": upd["quant"]}
    return v


@pytest.fixture(scope="module")
def embedder():
    jemb = jenc.ClassEmbedder(EMBED, N_CLASSES)
    tree = jemb.init(jax.random.PRNGKey(1), jnp.zeros((1,), jnp.int32))
    port = load_jax_variables(ClassEmbedder(EMBED, N_CLASSES, device="cpu"), _np(tree))
    return jemb, tree, port


@pytest.fixture(scope="module")
def calibrated(embedder):
    """The tiny class-conditional UNet calibrated on the doubled rows
    [x; x], [t; t], [uncond; cond] of two labels."""
    jemb, etree, _ = embedder
    model = jldm.LDMUNet(cfg=jldm.LDMUNetConfig(**TINY), qc=JQC_)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 8, 8, 3)), jnp.float32)
    x2, t2 = jnp.concatenate([x, x]), jnp.asarray([20.0, 600.0, 20.0, 600.0])
    c2 = jemb.apply(etree, jnp.concatenate([jnp.asarray(UNCOND), jnp.asarray(LABELS)]))
    v = _jit_calibrate(model, x2, t2, c2)
    return dict(model=model, v=v, x=x2, t=t2, c=c2,
                int8=jexport.export_serving_int8(v, JQC_, dtype=jnp.float32))


def _port(tree, cfg=TINY):
    return load_jax_variables(tldm.LDMUNet(tldm.LDMUNetConfig(**cfg), QC, device="cpu"),
                              _np(tree))


def test_class_embedder_matches_jax(embedder):
    jemb, tree, port = embedder
    labels = np.array([0, 3, 10, 10, 7], np.int32)        # 10: the uncond row
    ref = np.asarray(jemb.apply(tree, jnp.asarray(labels)))
    with torch.no_grad():
        out = port(torch.from_numpy(labels))
    assert out.shape == (5, 1, EMBED) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    back = to_jax_variables(port)
    np.testing.assert_array_equal(back["params"]["embedding"]["embedding"],
                                  np.asarray(tree["params"]["embedding"]["embedding"]))


def test_latent_diffusion_class_conditioning(embedder):
    """``cond="class"`` builds the embedder as the conditioning stage;
    ``get_learned_conditioning`` takes labels (a list, numpy or a tensor)."""
    jemb, tree, _ = embedder
    mc = tld.LatentDiffusionConfig(
        unet=tldm.LDMUNetConfig(**TINY),
        vae=tld.VAEConfig(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
                          attn_resolutions=(), in_channels=3, resolution=16,
                          z_channels=3, double_z=False, embed_dim=3, n_embed=64),
        cond="class", n_classes=N_CLASSES, class_embed_dim=EMBED)
    ld = tld.LatentDiffusion(mc, QC, device="cpu")
    assert isinstance(ld.cond_stage, ClassEmbedder)
    load_jax_variables(ld.cond_stage, _np(tree))
    ref = np.asarray(jemb.apply(tree, jnp.asarray(LABELS)))
    for labels in (LABELS.tolist(), LABELS, torch.from_numpy(LABELS)):
        np.testing.assert_array_equal(ld.get_learned_conditioning(labels).numpy(), ref)


def test_fp_forward(calibrated):
    c = calibrated
    ref = np.asarray(c["model"].apply(c["v"], c["x"], c["t"], c["c"], mode=JFP))
    with torch.no_grad():
        out = _port(c["v"])(*(torch.from_numpy(np.array(a))
                              for a in (c["x"], c["t"], c["c"])), mode=FP)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["DEPLOY", "DEPLOY_INT8"])
def test_deploy_forward(calibrated, mode, monkeypatch):
    """The quantized forwards; in DEPLOY_INT8 the spies count each
    package's K2 → K3 → K2 softmax calls: one for every cross-attention
    over the one key (four sites, rows of width 1), and the
    self-attentions on their default branch."""
    c = calibrated
    seen = {"jax": 0, "port": 0}
    widths = []
    for side, module, name in (("jax", jldm, "softmax_int8_codes"),
                               ("port", tldm, "softmax_codes")):
        fn = getattr(module, name)

        def spy(w, *a, _fn=fn, _side=side, **k):
            seen[_side] += 1
            widths.append((_side, int(w.shape[-1])))
            return _fn(w, *a, **k)
        monkeypatch.setattr(module, name, spy)
    if mode == "DEPLOY":
        tree = jexport.export_serving(c["v"], JQC_, dtype=jnp.float32)
        jmode, tmode = jexport.DEPLOY, DEPLOY
    else:
        tree, jmode, tmode = c["int8"], jexport.DEPLOY_INT8, DEPLOY_INT8
    # one head: a softmax code flipped on a tie moves its query row's C
    # values, 1/64 of the elements at the middle block's 4 rows of 4×4
    # tokens; two such flips a site are admitted
    ref, out, flips = _against_jax(c["model"], tree, _port(tree), c["x"], c["t"],
                                   jmode, tmode, attn_code_flips=True, context=c["c"],
                                   attn_flip_share=2 / 64)
    assert out.shape == ref.shape and np.isfinite(out).all()
    _flip_gate(out, ref, 0.15, share=flips == 0)
    if mode == "DEPLOY_INT8":
        # four transformer sites; the port runs twice (forced, then free)
        assert seen["jax"] >= 4 and seen["port"] == 2 * seen["jax"], seen
        assert widths.count(("port", 1)) == 2 * widths.count(("jax", 1)) == 8, widths
    if flips:
        other = (jexport.export_serving_int8(c["v"], JQC_, dtype=jnp.float32)
                 if mode == "DEPLOY" else
                 jexport.export_serving(c["v"], JQC_, dtype=jnp.float32))
        omode = jexport.DEPLOY_INT8 if mode == "DEPLOY" else jexport.DEPLOY
        own = np.asarray(c["model"].apply(other, c["x"], c["t"], c["c"], mode=omode))
        assert np.abs(out - ref).mean() <= np.abs(own - ref).mean()


@pytest.fixture(scope="module")
def labeled():
    model = jldm.LDMUNet(cfg=jldm.LDMUNetConfig(**LABELED), qc=JQC_)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 8, 8, 3)), jnp.float32)
    t, y = jnp.asarray([20.0, 600.0]), jnp.asarray([4, N_CLASSES - 1], jnp.int32)
    v = _jit_calibrate(model, x, t, None, y)
    return dict(model=model, v=v, x=x, t=t, y=y,
                int8=jexport.export_serving_int8(v, JQC_, dtype=jnp.float32))


def test_label_emb_fp_and_bridge(labeled):
    c = labeled
    ref = np.asarray(c["model"].apply(c["v"], c["x"], c["t"], None, c["y"], mode=JFP))
    port = _port(c["v"], LABELED)
    assert port.label_emb.embedding.shape == (N_CLASSES, 4 * 32)
    with torch.no_grad():
        out = port(torch.from_numpy(np.array(c["x"])), torch.from_numpy(np.array(c["t"])),
                   None, torch.from_numpy(np.array(c["y"])), mode=FP)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)
    back = to_jax_variables(port)["params"]["label_emb"]["embedding"]
    np.testing.assert_array_equal(back, np.asarray(c["v"]["params"]["label_emb"]["embedding"]))


def test_label_emb_deploy_int8(labeled):
    c = labeled
    ref, out, flips = _against_jax_args(
        c["model"], c["int8"], _port(c["int8"], LABELED), (c["x"], c["t"], None, c["y"]),
        jexport.DEPLOY_INT8, DEPLOY_INT8, tag="label_emb")
    assert out.shape == ref.shape and np.isfinite(out).all()
    _flip_gate(out, ref, 0.15, share=flips == 0)
    if flips:
        folded = np.asarray(c["model"].apply(
            jexport.export_serving(c["v"], JQC_, dtype=jnp.float32), c["x"], c["t"],
            None, c["y"], mode=jexport.DEPLOY))
        assert np.abs(out - ref).mean() <= np.abs(folded - ref).mean()


def test_imagenet_config_matches_jax():
    """Every field of the port's ``imagenet_config()`` equal to JAX's; the
    full UNet's layout equal, and its attention routes at 100 rows: the
    32×32 self-attention (S = 1024, C = 384) on K5 (its one-pass-wide
    route), the 16×16 and 8×8 ones (C = 576, 960) on K4, every
    cross-attention over the one class token on K2 → K3 → K2, in both
    packages' policies."""
    from eda_dm_tpu_torch.ops.int8_attention import flash_plan
    got, want = dataclasses.asdict(tld.imagenet_config()), \
        dataclasses.asdict(jld.imagenet_config())
    want["unet"].pop("conv_resample")
    assert got == want
    cfg = tld.imagenet_config().unet
    lay, jlay = tldm.build_layout(cfg, True), jldm.build_layout(jld.imagenet_config().unet,
                                                                True)
    for part in ("input_blocks", "middle_block", "output_blocks"):
        assert [vars(i) for i in getattr(lay, part)] == \
            [vars(i) for i in getattr(jlay, part)]
    res = {384: 32, 576: 16, 960: 8}
    sites = [(it.heads, it.dim_head, res[it.out_ch])
             for part in ("input_blocks", "middle_block", "output_blocks")
             for it in getattr(lay, part) if it.kind == "tx"]
    assert len(sites) == 16 and all(h == 1 and d in res for h, d, _ in sites)
    self_attn = [tldm.attention_impl(100, h, r * r, r * r, d) for h, d, r in sites]
    assert self_attn == [jpolicy.attention_impl(100, h, r * r, r * r, d)
                         for h, d, r in sites]
    assert self_attn.count("flash") == 5 and self_attn.count("fused") == 11
    assert all(d == 384 for (h, d, r), i in zip(sites, self_attn) if i == "flash")
    assert flash_plan(1024, 1024, 384)["route"] == "one_pass_wide"
    assert {tldm.attention_impl(100, h, r * r, 1, d) for h, d, r in sites} \
        == {jpolicy.attention_impl(100, h, r * r, 1, d) for h, d, r in sites} \
        == {"einsum"}
    with mock.patch.object(tldm.LDMUNet, "init_weights", lambda *a: None):
        n = sum(p.numel() for p in tldm.LDMUNet(cfg, QC, device="meta").parameters())
    assert n == 400_920_579
