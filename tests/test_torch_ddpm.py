"""The port's DDPM UNet vs the JAX package on a JAX-calibrated tiny model.

The JAX tree goes CALIB_W → CALIB_A → export once per module; the port gets
it through ``models/bridge.py`` and runs on the CPU (the kernels' plain
versions).  ``EDM_FUSED_ATTN=0`` puts JAX on the same einsum +
softmax-codes attention branch as the port at this small batch.

Tolerances: the FP forward atol 1e-4; single blocks on a shared input
rtol = atol = 2e-5 (f32 association only).  The quantized whole-model
paths are held in three ways:

* every GroupNorm, conv and dense on JAX's input (teacher forcing,
  ``eda_dm_tpu_torch.parity.tap``), and the ops between them, within
  rtol = atol = 2e-5 of JAX;
* run freely, the first act code that differs from JAX's sits on a
  rounding tie: its quantizer's input is within 2e-5 of JAX's;
* the whole output: the flip-aware median / max bounds of
  tests/test_export.py (median |Δ| < 2e-4, max < 0.15, < 0.3 after four
  sampler steps), and the share with |Δ| < 2e-4 above 0.7 where no code
  flips.  Once one code flips, GroupNorm and attention spread it over the
  sample, and the share falls below 0.7 between any two summation orders:
  JAX's own DEPLOY against its DEPLOY_INT8 (the same function, conv sums
  in another order) drifts by a mean of 4.9e-3 on this fixture, with a
  share of 0.51.  So where codes flip, the port's mean drift from JAX is
  held to that drift of JAX against itself instead.  (Run with ``-s`` to
  see each comparison's flips and drift.)
"""

import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.models.ddpm_unet import (AttnBlockD as JAttn, DDPMConfig as JCfg,
                                         DDPMUNet as JUNet,
                                         ResnetBlockD as JRes)
from eda_dm_tpu.nn import layers as jlayers
from eda_dm_tpu.quant import CALIB_A, CALIB_W, FP as JFP, QuantConfig as JQC
from eda_dm_tpu.quant import export as jexport
from eda_dm_tpu.samplers import ddim as jddim
from eda_dm_tpu.samplers.schedules import (alphas_cumprod_padded as jalphas,
                                           get_beta_schedule, skip_sequence)
from eda_dm_tpu_torch.models.bridge import (from_jax_variables,
                                            load_jax_variables, to_jax_variables)
from eda_dm_tpu_torch.models.ddpm_unet import (AttnBlockD, DDPMConfig,
                                               ResnetBlockD)
from eda_dm_tpu_torch.nn.layers import ActQuantizer, GNorm, QConv, QDense
from eda_dm_tpu_torch.parity import act_code_flips, tap
from eda_dm_tpu_torch.quant import DEPLOY, DEPLOY_INT8, FP, QuantConfig
from eda_dm_tpu_torch.quant.export import export_serving_int8
from eda_dm_tpu_torch.samplers.ddim import ddim_denoise_step, generalized_steps
from eda_dm_tpu_torch.samplers.schedules import alphas_cumprod_padded

TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=16)
CFG, JCFG = DDPMConfig(**TINY), JCfg(**TINY)
QC, JQC_ = QuantConfig(weight_bit=4, act_bit=8), JQC(weight_bit=4, act_bit=8)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def calibrated():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EDM_FUSED_ATTN", "0")
        model = JUNet(cfg=JCFG, qc=JQC_)
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal((4, 16, 16, 3)), jnp.float32)
        t = jnp.full((4,), 20.0)
        v = model.init(jax.random.PRNGKey(0), x, t, JFP)
        _, upd = jax.jit(lambda v: model.apply(v, x, t, CALIB_W,
                                               mutable=["quant"]))(v)
        v = {**v, "quant": upd["quant"]}
        _, upd = jax.jit(lambda v: model.apply(v, x, t, CALIB_A,
                                               mutable=["quant"]))(v)
        v = {**v, "quant": upd["quant"]}
        yield dict(model=model, v=v, x=x, t=t,
                   int8=jexport.export_serving_int8(v, JQC_, dtype=jnp.float32))


def _flip_gate(out, ref, max_abs, share=True):
    d = np.abs(np.asarray(out, np.float32) - np.asarray(ref, np.float32))
    assert np.median(d) < 2e-4, np.median(d)
    assert d.max() < max_abs, d.max()
    if share:
        assert (d < 2e-4).mean() > 0.7, (d < 2e-4).mean()


_JAX_KINDS = (jlayers.ActQuantizer, jlayers.GNorm, jlayers.QConv, jlayers.QDense)


def _port_name(path):
    """JAX module path -> the port's module name (``down_0`` -> ``down.0``)."""
    return ".".join(re.sub(r"^(down|up|block|attn)_(\d+)$", r"\1.\2", p)
                    for p in path)


def _jax_tapped(model, tree, x, t, mode):
    """``model.apply`` recording, as ``parity.tap`` does for the port, the
    first input and the output of every act quantizer, GroupNorm, conv and
    dense call, under the port's module names."""
    rec = {}

    def keep(next_fun, args, kwargs, ctx):
        out = next_fun(*args, **kwargs)
        if (isinstance(ctx.module, _JAX_KINDS) and ctx.method_name == "__call__"
                and args and args[0] is not None):
            rec.setdefault(_port_name(ctx.module.path), []).append(
                (torch.from_numpy(np.array(args[0], np.float32)),
                 torch.from_numpy(np.array(out, np.float32))
                 if isinstance(out, jax.Array) else None))
        return out

    with fnn.intercept_methods(keep):
        out = model.apply(tree, jnp.asarray(x), jnp.asarray(t), mode)
    return np.asarray(out), rec


def _against_jax(model, tree, port, x, t, jmode, mode):
    """JAX's and the port's output on one input.  On the way, every module
    of the port computed on JAX's input must give JAX's output, and the
    ops between modules JAX's input of the next (rtol = atol = 2e-5); and
    in the free run the first act code that differs from JAX's must sit on
    a rounding tie.  Returns (JAX out, port out, codes that differ)."""
    ref, jrec = _jax_tapped(model, tree, x, t, jmode)
    xt, tt = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(t))
    with torch.no_grad():
        with tap(port, (GNorm, QConv, QDense), replace=jrec) as forced:
            port(xt, tt, mode)
        with tap(port, ActQuantizer) as free:
            out = port(xt, tt, mode).numpy()
    for name, calls in forced.items():
        for (x_port, o_port), (x_jax, o_jax) in zip(calls, jrec[name]):
            torch.testing.assert_close(x_port, x_jax, rtol=2e-5, atol=2e-5,
                                       msg=f"input of {name}")
            torch.testing.assert_close(o_port, o_jax, rtol=2e-5, atol=2e-5,
                                       msg=f"output of {name}")
    rows = act_code_flips(port, free, jrec)
    first = next((r for r in rows if r[2]), None)
    assert first is None or first[3] <= 2e-5, first
    d = np.abs(out - ref)
    print(f"\n  t={float(t[0]):g}: {sum(r[2] for r in rows)} act codes differ, "
          f"the first in {first}; median {np.median(d):.3g} max {d.max():.3g}"
          f" mean {d.mean():.3g} share<2e-4 {(d < 2e-4).mean():.4f}")
    return ref, out, sum(r[2] for r in rows)


def test_fp_forward(calibrated):
    c = calibrated
    ref = np.asarray(c["model"].apply(c["v"], c["x"], c["t"], JFP))
    port = from_jax_variables(_np(c["v"]), CFG, QC, device="cpu")
    with torch.no_grad():
        out = port(torch.from_numpy(np.array(c["x"])),
                   torch.from_numpy(np.array(c["t"])), FP)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_deploy_forward(calibrated):
    """Folded weights: the float convs sum in another order than XLA's, one
    code flips at a tie in mid_block_1 and spreads (see the module
    docstring)."""
    c = calibrated
    tree = jexport.export_serving(c["v"], JQC_, dtype=jnp.float32)
    port = from_jax_variables(_np(tree), CFG, QC, device="cpu")
    ref, out, flips = _against_jax(c["model"], tree, port, c["x"], c["t"],
                                   jexport.DEPLOY, DEPLOY)
    _flip_gate(out, ref, 0.15, share=flips == 0)
    jax_int8 = np.asarray(c["model"].apply(c["int8"], c["x"], c["t"],
                                           jexport.DEPLOY_INT8))
    d = np.abs(jax_int8 - ref)
    print(f"  JAX DEPLOY_INT8 vs JAX DEPLOY: median {np.median(d):.3g} max "
          f"{d.max():.3g} mean {d.mean():.3g} share<2e-4 {(d < 2e-4).mean():.4f}")
    assert np.abs(out - ref).mean() <= d.mean()


def test_deploy_int8_forward(calibrated):
    c = calibrated
    port = from_jax_variables(_np(c["int8"]), CFG, QC, device="cpu")
    ref, out, flips = _against_jax(c["model"], c["int8"], port, c["x"],
                                   c["t"], jexport.DEPLOY_INT8, DEPLOY_INT8)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert flips == 0
    _flip_gate(out, ref, 0.15)


@pytest.mark.parametrize("which", ["resnet_block", "attn_block"])
def test_single_block_int8(calibrated, which):
    """One block on a shared input, int8 serving, exported state."""
    c = calibrated
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 8, 8, 32 if which == "resnet_block" else 64)
                            ).astype(np.float32)
    sub = "block_0" if which == "resnet_block" else "attn_0"
    tree = {k: c["int8"][k]["down_1"][sub] for k in ("params", "quant")}
    if which == "resnet_block":
        temb = rng.standard_normal((2, CFG.temb_ch)).astype(np.float32)
        jblk = JRes(64, CFG.temb_ch, JQC_.wq, JQC_.aq)
        ref = jblk.apply(tree, jnp.asarray(x), jnp.asarray(temb),
                         jexport.DEPLOY_INT8)
        blk = ResnetBlockD(32, 64, CFG.temb_ch, QC.wq, QC.aq)
        args = (torch.from_numpy(x), torch.from_numpy(temb))
    else:
        aq_w = JQC_.aq_softmax(always_zero=False)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("EDM_FUSED_ATTN", "0")
            ref = JAttn(JQC_.wq, JQC_.aq, aq_w).apply(tree, jnp.asarray(x),
                                                      jexport.DEPLOY_INT8)
        blk = AttnBlockD(64, QC.wq, QC.aq, QC.aq_softmax(always_zero=False))
        args = (torch.from_numpy(x),)
    load_jax_variables(blk, _np(tree))
    with torch.no_grad():
        out = blk(*args, DEPLOY_INT8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_export_matches_jax_leaf_by_leaf(calibrated, dtype):
    c = calibrated
    ref = _np(jexport.export_serving_int8(c["v"], JQC_,
                                          dtype=getattr(jnp, dtype)))
    port = from_jax_variables(_np(c["v"]), CFG, QC, device="cpu")
    export_serving_int8(port, QC, getattr(torch, dtype))
    got = to_jax_variables(port)

    def walk(g, r, path):
        for k, rv in r.items():
            if isinstance(rv, dict):
                walk(g[k], rv, f"{path}/{k}")
            elif k in ("running_min", "running_max", "one_side", "inited"):
                continue                   # calibration state, not served
            else:
                gv, rv = g[k], np.asarray(rv)
                assert gv.shape == rv.shape, f"{path}/{k}"
                if rv.dtype.kind in "iub":
                    assert gv.dtype == rv.dtype, f"{path}/{k}"
                np.testing.assert_array_equal(
                    gv, rv.astype(np.float32) if rv.dtype.name == "bfloat16"
                    else rv, err_msg=f"{path}/{k}")
        assert set(g) >= {k for k in r if k not in
                          ("running_min", "running_max", "one_side", "inited")}

    walk(got["params"], ref["params"], "params")
    walk(got["quant"], ref["quant"], "quant")
    assert "w0_int" in got["quant"]["conv_in"]
    assert "w0_int" not in got["quant"]["temb_dense_0"]      # 8-bit first layer


def test_ddim_sampling_int8(calibrated):
    """Four DDIM steps at eta=0 through DEPLOY_INT8.  Step by step on JAX's
    own x_t: the forward is held as in :func:`_against_jax` (at t = 35 a
    code flips at a tie and spreads) and the DDIM update on JAX's (x_t, ε)
    within 2e-5.  Run freely: the flip-aware median / max bounds, and the
    mean drift no larger than JAX's own folded-vs-int8 drift on the same
    trajectory."""
    c = calibrated
    # a 100-step schedule keeps alpha-bar above ~0.4, so the x0 estimate
    # (x − √(1−ᾱ)·ε)/√ᾱ does not amplify the drift 100-fold as the first
    # steps of a 1000-step schedule do on a random-weight model
    betas = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                              num_diffusion_timesteps=100)
    seq = skip_sequence("quad", 4, 100)
    x = np.random.default_rng(3).standard_normal((2, 16, 16, 3)).astype(np.float32)
    model = c["model"]

    def jax_run(tree, mode):
        out, steps = jddim.generalized_steps(
            jnp.asarray(x), seq, lambda xx, tt: model.apply(tree, xx, tt, mode),
            betas, eta=0.0, record_xt=True)
        return np.asarray(out), steps

    ref, steps = jax_run(c["int8"], jexport.DEPLOY_INT8)
    folded, _ = jax_run(jexport.export_serving(c["v"], JQC_, dtype=jnp.float32),
                        jexport.DEPLOY)
    port = from_jax_variables(_np(c["int8"]), CFG, QC, device="cpu")
    ja, pa = jalphas(betas), alphas_cumprod_padded(betas)
    seq_next = [-1] + list(seq[:-1])
    flipped = False
    for k, (i, j) in enumerate(zip(seq[::-1], seq_next[::-1])):
        xk = np.array(steps["x"][k])
        assert int(steps["t"][k]) == i
        t = np.full((xk.shape[0],), i, np.float32)
        eps, eps_port, flips = _against_jax(model, c["int8"], port, xk, t,
                                            jexport.DEPLOY_INT8, DEPLOY_INT8)
        _flip_gate(eps_port, eps, 0.15, share=flips == 0)
        flipped |= flips > 0
        nxt, _ = jddim.ddim_denoise_step(jnp.asarray(xk), jnp.asarray(eps),
                                         ja[i + 1], ja[j + 1], 0.0, 0.0)
        nxt_port, _ = ddim_denoise_step(
            torch.from_numpy(xk), torch.from_numpy(np.array(eps)), pa[i + 1],
            pa[j + 1], 0.0, None)
        np.testing.assert_allclose(nxt_port.numpy(), np.asarray(nxt),
                                   rtol=2e-5, atol=2e-5)
    out = generalized_steps(torch.from_numpy(x), seq,
                            lambda xx, tt: port(xx, tt, DEPLOY_INT8), betas,
                            eta=0.0, device="cpu").numpy()
    assert np.isfinite(out).all()
    d, dj = np.abs(out - ref), np.abs(folded - ref)
    print(f"  free run: median {np.median(d):.3g} max {d.max():.3g} mean "
          f"{d.mean():.3g} share<2e-4 {(d < 2e-4).mean():.4f}; JAX folded vs "
          f"int8: mean {dj.mean():.3g}")
    _flip_gate(out, ref, 0.3, share=not flipped)
    assert d.mean() <= dj.mean()
