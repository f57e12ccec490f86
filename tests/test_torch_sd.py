"""The port's Stable-Diffusion path vs the JAX package on the CPU.

* ``LayerNorm`` against flax ``nn.LayerNorm``: values within
  rtol = atol = 2e-5 (bf16 outputs: one bf16 rounding, 1e-2), and the
  output dtype flax gives, the promotion of the input's and the
  parameters' dtypes.
* Each transformer block (``CrossAttentionL`` with and without a context,
  ``FeedForwardL``, ``BasicTransformerBlockL``, ``SpatialTransformerL``)
  calibrated by JAX on its own, in FP, DEPLOY and DEPLOY_INT8, on an f32
  and a bf16 carrier: every act quantizer, norm, conv and dense on JAX's
  input within rtol = atol = 2e-5 (bf16: 1e-2, a bf16 rounding of an op
  between modules), the int8 denses and convs bit for bit, the first act
  code that differs on a rounding tie, and the output dtype JAX's.  A
  softmax code computed inside the attention kernel may flip on a tie
  (JAX adds the row sums in float32, the port in float64); the input of
  the ``to_out_0`` after it may then differ on ≤ 0.1 % of its elements.
* ``TinyTextEncoder`` (tokens and the float32 context rows within
  rtol = atol = 2e-5) and its tree through the bridge, both ways.
* The tiny SD UNet of ``tests/test_coco_pipeline_smoke.py`` (text
  context, spatial transformer, ``legacy=False`` heads), JAX-calibrated
  once per file at 2 prompts under CFG (4 rows): FP within 1e-4; DEPLOY
  and DEPLOY_INT8 through the flip-aware gate of ``test_torch_ldm.py``;
  its int8 export leaf by leaf.
* PLMS against JAX at eta 0 over 5 steps (orders 1 to 4) on one analytic
  ε model: within 1e-5.
* The tiny KL-f8 decode through ``decode_first_stage`` (scale factor
  0.18215) within rtol = atol = 1e-4.
* The tiny coco ``sample_batch`` (PLMS, CFG 7.5, KL decode) against JAX's
  from the same x_T and text contexts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn

from eda_dm_tpu.models import encoders as jenc
from eda_dm_tpu.models import ldm_unet as jldm
from eda_dm_tpu.models import vae as jvae
from eda_dm_tpu.pipelines import latent as jpipe
from eda_dm_tpu.quant import CALIB_A, CALIB_W, FP as JFP, QuantConfig as JQC
from eda_dm_tpu.quant import export as jexport
from eda_dm_tpu.samplers import latent as jlat
from eda_dm_tpu_torch.models import ldm_unet as tldm
from eda_dm_tpu_torch.models.bridge import (first_stage_from_jax,
                                            load_jax_variables, to_jax_variables)
from eda_dm_tpu_torch.models.encoders import TinyTextEncoder
from eda_dm_tpu_torch.models.latent_diffusion import LatentDiffusionConfig
from eda_dm_tpu_torch.models.vae import VAEConfig
from eda_dm_tpu_torch.nn.layers import LayerNorm
from eda_dm_tpu_torch.pipelines.latent import LDMPipeline, task_config
from eda_dm_tpu_torch.quant import DEPLOY, DEPLOY_INT8, FP, QuantConfig
from eda_dm_tpu_torch.quant.export import export_serving_int8
from eda_dm_tpu_torch.samplers import latent as tlat

from test_coco_pipeline_smoke import CTX_DIM, tiny_sd_cfg
from test_torch_ddpm import (_against_jax, _against_jax_args, _flip_gate, _np,
                             _torch)
from test_torch_latent import _drift

QC, JQC_ = QuantConfig(weight_bit=4, act_bit=8), JQC(weight_bit=4, act_bit=8)
JMC = tiny_sd_cfg()
UCFG = tldm.LDMUNetConfig(**{f: getattr(JMC.unet, f)
                             for f in tldm.LDMUNetConfig.__dataclass_fields__})
VCFG = VAEConfig(**{f: getattr(JMC.vae, f) for f in VAEConfig.__dataclass_fields__})
CTX_LEN = 6
MODES = {"FP": (JFP, FP), "DEPLOY": (jexport.DEPLOY, DEPLOY),
         "DEPLOY_INT8": (jexport.DEPLOY_INT8, DEPLOY_INT8)}


def _calibrate(module, *args):
    """JAX init → CALIB_W → CALIB_A on ``args``; returns the tree.  The
    init and the inputs go through ``jit`` as arguments: an eager init of
    the tiny SD UNet takes twice as long, and XLA would fold the range
    searches' sorts of constant activations at compile time (a minute at
    2048 tokens)."""
    v = jax.jit(lambda k, *a: module.init(k, *a, mode=JFP))(
        jax.random.PRNGKey(0), *args)
    for mode in (CALIB_W, CALIB_A):
        _, upd = jax.jit(lambda v, *a: module.apply(v, *a, mode=mode,
                                                    mutable=["quant"]))(v, *args)
        v = {**v, "quant": upd["quant"]}
    return v


def _serving_tree(v, mode, dtype):
    """The JAX tree a mode serves from, on the carrier ``dtype``."""
    if mode == "FP":
        return {**v, "params": jax.tree.map(lambda a: a.astype(dtype), v["params"])}
    export = (jexport.export_serving if mode == "DEPLOY"
              else jexport.export_serving_int8)
    return export(v, JQC_, dtype=dtype)


def _dtype_name(a):
    return str(a.dtype).replace("torch.", "")


# --------------------------------------------------------------------------
# LayerNorm


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_layernorm_matches_flax(x_dtype, p_dtype):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((3, 7, 48)) * 2.0 + 0.5, x_dtype)
    params = {"scale": jnp.asarray(1 + 0.3 * rng.standard_normal(48), p_dtype),
              "bias": jnp.asarray(0.2 * rng.standard_normal(48), p_dtype)}
    ref = fnn.LayerNorm().apply({"params": params}, x)
    ln = LayerNorm(48)
    load_jax_variables(ln, {"params": _np(params)})
    ln.to(getattr(torch, p_dtype))
    with torch.no_grad():
        out = ln(_torch(x))
    assert _dtype_name(out) == str(ref.dtype)
    tol = 2e-5 if out.dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# the transformer blocks, each calibrated by JAX on its own


def _blocks():
    wq, aq, aq_w = JQC_.wq, JQC_.aq, JQC_.aq_softmax(always_zero=True)
    pw, pa, pw_ = QC.wq, QC.aq, QC.aq_softmax(always_zero=True)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, CTX_LEN, CTX_DIM)).astype(np.float32)
    x4 = rng.standard_normal((2, 4, 4, 32)).astype(np.float32)
    return {
        "cross_attention": (jldm.CrossAttentionL(2, 16, 32, wq, aq, aq_w),
                            lambda: tldm.CrossAttentionL(32, CTX_DIM, 2, 16, 32,
                                                         pw, pa, pw_), (x, ctx)),
        "self_attention": (jldm.CrossAttentionL(2, 16, 32, wq, aq, aq_w),
                           lambda: tldm.CrossAttentionL(32, 32, 2, 16, 32,
                                                        pw, pa, pw_), (x, None)),
        "feed_forward": (jldm.FeedForwardL(32, wq, aq),
                         lambda: tldm.FeedForwardL(32, pw, pa), (x,)),
        "transformer_block": (jldm.BasicTransformerBlockL(2, 16, 32, wq, aq, aq_w),
                              lambda: tldm.BasicTransformerBlockL(
                                  32, 2, 16, CTX_DIM, pw, pa, pw_), (x, ctx)),
        "spatial_transformer": (jldm.SpatialTransformerL(2, 16, 1, wq, aq, aq_w),
                                lambda: tldm.SpatialTransformerL(
                                    32, 2, 16, 1, CTX_DIM, pw, pa, pw_), (x4, ctx)),
    }


BLOCKS = _blocks()


@pytest.fixture(scope="module")
def calibrated_blocks():
    return {name: _calibrate(jblk, *[None if a is None else jnp.asarray(a)
                                     for a in args])
            for name, (jblk, _, args) in BLOCKS.items()}


@pytest.mark.parametrize("carrier", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_matches_jax(calibrated_blocks, block, mode, carrier):
    jblk, make, args = BLOCKS[block]
    tree = _serving_tree(calibrated_blocks[block], mode, getattr(jnp, carrier))
    blk = make()
    load_jax_variables(blk, _np(tree))
    jargs = [None if a is None else jnp.asarray(a, carrier) for a in args]
    jmode, tmode = MODES[mode]
    bf16 = carrier == "bfloat16"
    ref, out, flips = _against_jax_args(
        jblk, tree, blk, jargs, jmode, tmode, attn_code_flips=True,
        tag=f"{block} {mode} {carrier}", tol=1e-2 if bf16 else 2e-5,
        int8_exact=True)
    with torch.no_grad():
        port_out = blk(*[None if a is None else _torch(a) for a in jargs],
                       mode=tmode)
    assert _dtype_name(port_out) == str(ref.dtype)
    assert out.shape == ref.shape and np.isfinite(out).all()
    if not bf16:
        _flip_gate(out, ref, 0.15, share=flips == 0)
        if not flips:
            np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------
# the text encoder


@pytest.mark.parametrize("dim,length,vocab", [(CTX_DIM, CTX_LEN, 128), (768, 77, 4096)])
def test_text_encoder_matches_jax(dim, length, vocab):
    jenc_ = jenc.TinyTextEncoder(context_dim=dim, max_length=length, vocab=vocab,
                                 seed=3)
    enc = TinyTextEncoder(dim, length, vocab, device="cpu")
    load_jax_variables(enc, _np(jenc_.params))
    prompts = ["a photo of a cat", "", "An astronaut riding a horse on mars"]
    np.testing.assert_array_equal(enc.tokenize(prompts), jenc_.tokenize(prompts))
    ref = np.asarray(jenc_.encode(prompts))
    out = enc.encode(prompts)
    assert out.dtype == torch.float32 and out.shape == ref.shape == (3, length, dim)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    back = to_jax_variables(enc)["params"]
    flat = jax.tree_util.tree_flatten_with_path(_np(jenc_.params)["params"])[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf, err_msg=str(path))


# --------------------------------------------------------------------------
# the tiny SD UNet


@pytest.fixture(scope="module")
def calibrated():
    """JAX calibration of the tiny SD UNet on 2 prompts under CFG: the rows
    are [x; x], [t; t] and [uncond; cond] contexts."""
    model = jldm.LDMUNet(cfg=JMC.unet, qc=JQC_)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((4, CTX_LEN, CTX_DIM)).astype(np.float32)
    x, t = np.concatenate([x, x]), np.asarray([20.0, 600.0] * 2, np.float32)
    v = _calibrate(model, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    return dict(model=model, v=v, x=x, t=t, ctx=ctx,
                int8=jexport.export_serving_int8(v, JQC_, dtype=jnp.float32))


def _port(tree):
    return load_jax_variables(tldm.LDMUNet(UCFG, QC, device="cpu"), _np(tree))


def test_sd_unet_fp_forward(calibrated):
    c = calibrated
    ref = np.asarray(c["model"].apply(c["v"], c["x"], c["t"], c["ctx"], mode=JFP))
    with torch.no_grad():
        out = _port(c["v"])(_torch(c["x"]), _torch(c["t"]), _torch(c["ctx"]), mode=FP)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_sd_unet_deploy_forward(calibrated):
    """Folded weights: the float convs sum in another order than XLA's, and
    on some hosts a code flips on a tie and cascades through the
    random-weight model.  The median and share bounds hold where no code
    flips; where codes flip, max < 0.15, the first flip on a tie (in
    ``_against_jax``) and the mean drift no larger than JAX's own
    DEPLOY_INT8-vs-DEPLOY drift decide."""
    c = calibrated
    tree = jexport.export_serving(c["v"], JQC_, dtype=jnp.float32)
    ref, out, flips = _against_jax(c["model"], tree, _port(tree), c["x"], c["t"],
                                   jexport.DEPLOY, DEPLOY, context=c["ctx"])
    _flip_gate(out, ref, 0.15, share=flips == 0, median=flips == 0)
    if flips:
        jax_int8 = np.asarray(c["model"].apply(c["int8"], c["x"], c["t"], c["ctx"],
                                               mode=jexport.DEPLOY_INT8))
        assert np.abs(out - ref).mean() <= np.abs(jax_int8 - ref).mean()


def test_sd_unet_deploy_int8_forward(calibrated, monkeypatch):
    """The self-attention sites take K4 (fused) in both packages, the
    cross-attention sites K2 → K3 → K2 (einsum)."""
    c = calibrated
    seen = []
    impl = tldm.attention_impl

    def spy(b, h, sq, skv, d):
        seen.append((skv == CTX_LEN, impl(b, h, sq, skv, d)))
        return seen[-1][1]
    monkeypatch.setattr(tldm, "attention_impl", spy)
    ref, out, flips = _against_jax(c["model"], c["int8"], _port(c["int8"]),
                                   c["x"], c["t"], jexport.DEPLOY_INT8,
                                   DEPLOY_INT8, attn_code_flips=True,
                                   context=c["ctx"])
    assert set(seen) == {(False, "fused"), (True, "einsum")}
    assert out.shape == ref.shape and np.isfinite(out).all()
    _flip_gate(out, ref, 0.15, share=flips == 0)
    if flips:
        folded = np.asarray(c["model"].apply(
            jexport.export_serving(c["v"], JQC_, dtype=jnp.float32), c["x"],
            c["t"], c["ctx"], mode=jexport.DEPLOY))
        assert np.abs(out - ref).mean() <= np.abs(folded - ref).mean()


def test_sd_unet_export_matches_jax_leaf_by_leaf(calibrated):
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
    blk = got["params"]["input_blocks_3_1"]["transformer_blocks_0"]
    assert "bias" not in blk["attn1"]["to_q"] and "bias" in blk["attn1"]["to_out_0"]
    assert set(blk["norm1"]) == {"scale", "bias"}
    back = load_jax_variables(tldm.LDMUNet(UCFG, QC, device="cpu"), got)
    state = dict(back.state_dict())
    for name, t in port.state_dict().items():
        assert torch.equal(state[name].float(), t.float()), name


# --------------------------------------------------------------------------
# PLMS, the KL decode, sample_batch


def test_plms_matches_jax():
    sched_j = jlat.make_ldm_schedule(num_timesteps=1000, linear_start=0.00085,
                                     linear_end=0.0120, ddim_steps=5, eta=0.0)
    sched_t = tlat.make_ldm_schedule(num_timesteps=1000, linear_start=0.00085,
                                     linear_end=0.0120, ddim_steps=5, eta=0.0)
    x = np.random.default_rng(2).standard_normal((2, 4, 4, 3)).astype(np.float32)

    def eps(xp, tanh):
        return lambda xx, tt: 0.5 * tanh(xx) + 0.3 * xx * (tt[:, None, None, None] / 1000.0)
    ref, _ = jlat.ldm_plms_sample(jnp.asarray(x), sched_j, eps(jnp, jnp.tanh))
    calls = []

    def counted(xx, tt):
        calls.append(float(tt[0]))
        return eps(torch, torch.tanh)(xx, tt)
    out = tlat.ldm_plms_sample(torch.from_numpy(x), sched_t, counted, device="cpu")
    steps = sched_t.ddim_timesteps[::-1].tolist()
    assert calls == [steps[0], steps[1]] + steps[1:]        # order 1 looks ahead
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def first_stage():
    """The tiny KL first stage's JAX weights, perturbed away from flax's
    initial values so every bias and norm parameter matters."""
    fs = jvae.FirstStage(cfg=JMC.vae)
    v = jax.jit(fs.init)(jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 4)))
    rng = np.random.default_rng(4)
    return {"params": jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        v["params"])}


def test_kl_decode_matches_jax(first_stage):
    v = first_stage
    z = np.random.default_rng(5).standard_normal((2, 8, 8, 4)).astype(np.float32)
    pipe = jpipe.LDMPipeline(jpipe.task_config("coco", custom_steps=5),
                             model_cfg=JMC)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(pipe.ld.decode_first_stage(v, jnp.asarray(z)))
    port = LDMPipeline(task_config("coco", custom_steps=5), _port_model_cfg(),
                       device="cpu")
    port.ld.first_stage = first_stage_from_jax(_np(v), VCFG, "cpu")
    with torch.no_grad():
        out = port.ld.decode_first_stage(torch.from_numpy(z)).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def _port_model_cfg():
    return LatentDiffusionConfig(
        unet=UCFG, vae=VCFG, timesteps=JMC.timesteps, linear_start=JMC.linear_start,
        linear_end=JMC.linear_end, scale_factor=JMC.scale_factor, cond="text")


def test_coco_sample_batch(calibrated, first_stage):
    """Two prompts, 5 PLMS steps at CFG 7.5, DEPLOY_INT8, the KL decode:
    x_T as JAX's ``sample_batch`` draws it, the text contexts from JAX's
    stand-in encoder (the port's encoder, loaded with its weights, gives
    them within 2e-5).  The latents and the images of the free run under
    the flip-aware bounds of ``tests/test_torch_latent.py``: median |Δ| <
    2e-4, and the mean drift no larger than JAX's own folded-vs-int8 drift
    (max < 0.3 for the latents; the images' max is not bounded)."""
    c = calibrated
    steps = 5
    pipe = jpipe.LDMPipeline(jpipe.task_config("coco", custom_steps=steps),
                             model_cfg=JMC)
    assert pipe.is_conditional and pipe.cfg.sampler == "plms"
    vae = first_stage
    jtext = jenc.TinyTextEncoder(context_dim=CTX_DIM, max_length=CTX_LEN,
                                 vocab=128, seed=5)
    prompts = ["a red bus", "two dogs on a beach"]
    ctx, unc = jtext.encode(prompts), jtext.encode([""] * 2)
    key = jax.random.PRNGKey(11)

    def jax_run(unet_tree, mode):
        with jax.default_matmul_precision("highest"):
            z = pipe.sample_batch({"unet": unet_tree, "first_stage": vae}, key,
                                  batch_size=2, context=ctx, uncond=unc,
                                  mode=mode, decode=False)
            img = pipe.ld.decode_first_stage(vae, z)
            return np.array(z), np.array(jnp.clip((img + 1.0) / 2.0, 0.0, 1.0))

    z_ref, img_ref = jax_run(c["int8"], jexport.DEPLOY_INT8)
    z_fold, img_fold = jax_run(jexport.export_serving(c["v"], JQC_,
                                                      dtype=jnp.float32),
                               jexport.DEPLOY)
    x_T = np.array(jax.random.normal(jax.random.split(key)[0], (2, 8, 8, 4)))

    port = LDMPipeline(task_config("coco", custom_steps=steps), _port_model_cfg(),
                       device="cpu")
    assert port.is_conditional and port.cfg.scale == 7.5
    load_jax_variables(port.ld.unet, _np(c["int8"]))
    port.ld.first_stage = first_stage_from_jax(_np(vae), VCFG, "cpu")
    port.ld.cond_stage = TinyTextEncoder(CTX_DIM, CTX_LEN, 128, device="cpu")
    load_jax_variables(port.ld.cond_stage, _np(jtext.params))
    tctx = port.ld.get_learned_conditioning(prompts)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(ctx), rtol=2e-5, atol=2e-5)
    run = lambda decode: port.sample_batch(
        DEPLOY_INT8, x_T=torch.from_numpy(x_T), context=_torch(ctx),
        uncond=_torch(unc), decode=decode).numpy()

    _drift(run(False), z_ref, z_fold)
    out = run(True)
    assert out.shape == (2, 16, 16, 3) and out.min() >= 0.0 and out.max() <= 1.0
    _drift(out, img_ref, img_fold, max_abs=1.0)
