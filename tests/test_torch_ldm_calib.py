"""The latent family's calibration pieces in the port against the JAX
package, on the CPU (``jax_default_matmul_precision`` highest).

Tiny configs: a church-like UNet (8×8×4 latents, 32 channels,
channel_mult (1, 2), one res block a level, scale-shift norm, resampling
res blocks, attention at the 4×4 level with 2 heads) and an SD-like one
(the same sizes, a spatial transformer with 4 heads over a 6 × 24 text
context), each built by the port from seed 0 and calibrated by it
(CALIB_W, CALIB_A) on 6 rows made with numpy; the JAX package gets the
same state through ``models/bridge.py``.

* The plans: ``ldm_recon_plan`` and ``ldm_layer_plan`` give JAX's names,
  paths, kinds, ``has_temb``, ``has_ctx``, inner taps and ``act_only`` in
  JAX's order, the module class each spec names, and ``group_plan``
  groups as JAX's does (window 0 and 1, groups of 2 and 4): the tiny
  bedroom-, church- and SD-like configs and the full ``bedroom_config``,
  ``church_config`` and ``sd_v1_config``.  ``church_config`` equals JAX's.
* The captures (``build_group_data``, chunks of 4 and 2 rows): a res
  block with its inner taps and an attention block captured together; a
  transformer block's ``proj_in`` and the block itself with its
  ``block_ctx``.  FP taps within rtol = atol = 2e-5 of JAX's (the
  module tolerance of ``tests/test_torch_ldm.py``: the attention's float
  sums go in another order); ``inp_q`` (the quantized
  prefix) median < 2e-4 and max within 2 % of its largest value, as
  ``tests/test_torch_recon.py`` holds it (a code on a float tie flips).
* The loops, on the port's capture, deterministic (minibatch = the 6
  rows, ``input_prob=1``, QDrop probability 1): 10 iterations of a res
  block, an attention block, a transformer block with its context and
  the layer plan's act-only attention target; each loss within 5e-3 of
  the curve's peak and hard masks > 98 % equal, as
  ``tests/test_torch_recon.py`` holds them; act deltas within rel 1e-3 or
  one Adam step (lr_a).  After the first step every delta of the
  transformer block equals JAX's (every gradient's sign agrees); that step
  moves each alpha by lr_w = 0.5, those whose gradient is float noise
  either way, so the second step's loss differs by 0.15 % and a small
  delta gradient then takes the other sign: attn2's ``to_q`` quantizer
  ends 0.8 of a step from JAX's after 10 iterations (the CIFAR blocks
  stay within a quarter).
* CALIB_W: (delta, zp) equal or a tie by JAX's own score, alphas within
  2e-6 with equal hard masks (``tests/test_torch_calib.py``'s rule).
  CALIB_A over two batches of 3 rows, each quantizer on JAX's own input
  (``parity.tap``): ``one_side`` equal, ``delta`` and ``zero_point``
  within rel 1e-5, and the running range too, except where the search's
  best two candidate ranges fall on one grid (the same width and zero
  point, shifted by less than a step: the same quantizer, a tie that
  float noise decides); at most 5 % of the quantizers.
* The samplers' records: ``ldm_ddim_sample`` (eta 1, JAX's noise) and
  ``ldm_plms_sample`` (eta 0, its look-ahead) on a closed-form ε and aux,
  every recorded x_t, aux, timestep, index and next timestep within 1e-6
  (the integers equal).
* ``api.reconstruct`` on an ``LDMUNet`` without a plan runs
  ``ldm_recon_plan``; ``resumable_reconstruct`` on an LDM plan,
  interrupted after a group and resumed, ends buffer for buffer where an
  uninterrupted run does; the LDM serving bundle, saved and loaded,
  serves DEPLOY_INT8 bit-equal to the in-memory export (its leaves and
  bytes are the DDPM bundle's code, held against JAX's in
  ``tests/test_torch_bundle.py``).
"""

import dataclasses
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.calib import recon as jrecon
from eda_dm_tpu.calib import scale_init as jsi
from eda_dm_tpu.models import latent_diffusion as jld
from eda_dm_tpu.models import ldm_unet as jldm
from eda_dm_tpu.nn import layers as jlayers
from eda_dm_tpu.quant import affine as jaff
from eda_dm_tpu.quant import config as jconf
from eda_dm_tpu.quant import search as jsearch
from eda_dm_tpu.samplers import latent as jlat
from eda_dm_tpu.utils.tree import get_subtree
from eda_dm_tpu_torch import api
from eda_dm_tpu_torch.calib import recon as trecon
from eda_dm_tpu_torch.calib import scale_init as tsi
from eda_dm_tpu_torch.models import latent_diffusion as tld
from eda_dm_tpu_torch.models import ldm_unet as tldm
from eda_dm_tpu_torch.models.bridge import load_jax_variables, to_jax_variables
from eda_dm_tpu_torch.nn.layers import ActQuantizer
from eda_dm_tpu_torch.parity import tap
from eda_dm_tpu_torch.quant import config as tconf
from eda_dm_tpu_torch.quant import export as texport
from eda_dm_tpu_torch.samplers import latent as tlat
from eda_dm_tpu_torch.utils import checkpointing

BASE = dict(image_size=8, model_channels=32, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2))
TINY = {
    "bedroom": dict(BASE, in_channels=3, out_channels=3, num_head_channels=16),
    "church": dict(BASE, in_channels=4, out_channels=4, num_heads=2,
                   use_scale_shift_norm=True, resblock_updown=True),
    "sd": dict(BASE, in_channels=4, out_channels=4, num_heads=4,
               use_spatial_transformer=True, context_dim=24, legacy=False),
}
ROWS, CTX_LEN = 6, 6
ITERS = 10
# QDrop probability 1: every quantized value kept, no draw
JQC, TQC = jconf.QuantConfig(prob=1.0), tconf.QuantConfig(prob=1.0)
LR_A = trecon.ReconArgs().lr_a


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jcfg(d):
    """A port LDMUNetConfig as JAX's (the JAX config also has
    ``conv_resample``, always True)."""
    return jldm.LDMUNetConfig(**{k: v for k, v in d.items()})


def _tcfg(d):
    return tldm.LDMUNetConfig(**d)


def _full(name):
    jc = getattr(jld, f"{name}_config")().unet
    return jc, tldm.LDMUNetConfig(**{k: v for k, v in dataclasses.asdict(jc).items()
                                     if k != "conv_resample"})


def _fields(t):
    return (t.name, t.path, t.kind, t.has_temb, t.has_ctx, t.inner_taps, t.act_only)


# --------------------------------------------------------------------------
# plans and configs


@pytest.mark.parametrize("which", ["ldm_recon_plan", "ldm_layer_plan"])
@pytest.mark.parametrize("size", ["tiny_bedroom", "tiny_church", "tiny_sd", "bedroom",
                                  "church", "sd_v1"])
def test_plans_match_jax(which, size):
    if size.startswith("tiny_"):
        jc, tc = _jcfg(TINY[size[5:]]), _tcfg(TINY[size[5:]])
    else:
        jc, tc = _full(size)
    want = getattr(jldm, which)(jc, jconf.QuantConfig())
    got = getattr(tldm, which)(tc, tconf.QuantConfig())
    assert [_fields(t) for t in got] == [_fields(t) for t in want]
    assert [t.spec[0] for t in got] == [type(t.module).__name__ for t in want]
    names = lambda groups: [[t.name for t in g] for g in groups]
    for window in (0, 1):
        for gs in (2, 4):
            assert (names(trecon.group_plan(got, gs, window))
                    == names(jrecon.group_plan(want, gs, window)))
    if size == "sd_v1":
        assert sum(t.has_ctx for t in got) == 16 and len(got) == (80 if which ==
                                                                   "ldm_recon_plan" else 138)


def test_church_config_matches_jax():
    got, want = tld.church_config(), jld.church_config()
    for field in ("timesteps", "linear_start", "linear_end", "scale_factor", "cond"):
        assert getattr(got, field) == getattr(want, field), field
    assert dataclasses.asdict(got.vae) == dataclasses.asdict(want.vae)
    unet = dataclasses.asdict(want.unet)
    assert unet.pop("conv_resample") is True
    assert dataclasses.asdict(got.unet) == unet


# --------------------------------------------------------------------------
# a tiny model calibrated by the port


def _data(family, rows=ROWS):
    rng = np.random.default_rng({"church": 0, "sd": 1}[family])
    x = rng.standard_normal((rows, 8, 8, 4)).astype(np.float32)
    t = rng.integers(0, 1000, rows).astype(np.float32)
    if family == "church":
        return (x, t)
    return (x, t, rng.standard_normal((rows, CTX_LEN, 24)).astype(np.float32))


@pytest.fixture(scope="module", params=["church", "sd"])
def calibrated(request):
    """The tiny model of ``request.param`` built and calibrated by the port,
    as JAX trees through the bridge (``init`` before CALIB_W, ``w`` after
    it, ``v`` after CALIB_A): both packages start from one state."""
    family = request.param
    arrays = _data(family)
    tcali = tuple(torch.from_numpy(a) for a in arrays)
    port = tldm.LDMUNet(_tcfg(TINY[family]), TQC, device="cpu", seed=0)
    init = to_jax_variables(port)
    tsi.set_weight_quantize_params(port, tcali, device="cpu")
    w = to_jax_variables(port)
    tsi.set_act_quantize_params(port, tcali, device="cpu")
    return dict(family=family, init=init, w=w, v=to_jax_variables(port), tcali=tcali,
                cali=tuple(jnp.asarray(a) for a in arrays),
                model=jldm.LDMUNet(cfg=_jcfg(TINY[family]), qc=JQC))


def _port(c, qc=TQC):
    return load_jax_variables(tldm.LDMUNet(_tcfg(TINY[c["family"]]), qc, device="cpu"),
                              _np(c["v"]))


def _target(c, name, layer=False):
    which = "ldm_layer_plan" if layer else "ldm_recon_plan"
    cfg = TINY[c["family"]]
    return (next(t for t in getattr(tldm, which)(_tcfg(cfg), TQC) if t.name == name),
            next(t for t in getattr(jldm, which)(_jcfg(cfg), JQC) if t.name == name))


CAPTURES = {"church": ("input_blocks.3_0", "input_blocks.3_1"),
            "sd": ("input_blocks.3_1.proj_in", "input_blocks.3_1.tx_0")}


def test_capture_matches_jax(calibrated):
    """One group's captures, its members taken in the same two passes."""
    c = calibrated
    targets = [_target(c, n) for n in CAPTURES[c["family"]]]
    got = trecon.build_group_data(_port(c), c["tcali"], [t for t, _ in targets],
                                  trecon.ReconArgs(capture_batch_size=4))
    want = jrecon.build_group_data(c["model"], c["v"], c["cali"], [j for _, j in targets],
                                   jrecon.ReconArgs(capture_batch_size=4))
    for (t, _), g, w in zip(targets, got, want):
        assert set(g) == {k for k, v in w.items() if v is not None}, t.name
        assert ("ctx_q" in g) == t.has_ctx
        for k, wv in w.items():
            for a, b in zip(g[k] if isinstance(wv, tuple) else [g[k]],
                            wv if isinstance(wv, tuple) else [wv]):
                a, b = a.numpy(), np.asarray(b)
                assert a.shape == b.shape, (t.name, k)
                if k == "inp_q":
                    d = np.abs(a - b)
                    print(f"\n  {t.name} inp_q: median {np.median(d):.3g}, max "
                          f"{d.max():.3g} of {np.abs(b).max():.3g}")
                    assert np.median(d) < 2e-4 and d.max() <= 0.02 * np.abs(b).max()
                else:
                    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5,
                                               err_msg=f"{t.name} {k}")


def _jax_data(data):
    return {k: (tuple(jnp.asarray(a.numpy()) for a in v) if isinstance(v, tuple)
                else jnp.asarray(v.numpy())) for k, v in data.items()}


def _compare_state(port, jv, target, tag):
    """The target's subtree: act deltas within rel 1e-3 or lr_a;
    returns (hard-mask agreement, alpha count)."""
    got = to_jax_variables(target.module(port))["quant"]
    want = _np(get_subtree(jv["quant"], target.path))
    same = total = 0
    worst = [0.0]

    def walk(g, w, p):
        nonlocal same, total
        for k, wv in w.items():
            if isinstance(wv, dict):
                walk(g[k], wv, f"{p}/{k}")
            elif k.endswith("_alpha"):
                same += int(((g[k] >= 0) == (wv >= 0)).sum())
                total += wv.size
            elif k == "delta":
                d = abs(float(g[k]) - float(wv))
                worst[0] = max(worst[0], d / LR_A)
                assert d <= max(1e-3 * abs(float(wv)), LR_A), f"{p}/delta {d:.3g}"
    walk(got, want, "")
    share = same / max(total, 1)
    print(f"\n  {tag}: hard masks agree on {share:.5f} of {total}, act deltas at most "
          f"{worst[0]:.3g} steps of lr_a apart")
    return share, total


LOOPS = {"church": [("input_blocks.3_0", False), ("input_blocks.3_1", False),
                    ("input_blocks.3_1.acts", True)],
         "sd": [("input_blocks.3_1.tx_0", False)]}


def test_target_loops_match_jax(calibrated):
    """10 deterministic iterations of each of the family's targets."""
    c = calibrated
    for name, layer in LOOPS[c["family"]]:
        port = _port(c)
        t, j = _target(c, name, layer)
        kw = dict(iters=ITERS, batch_size=ROWS, input_prob=1.0)
        targs = trecon.ReconArgs(**kw)
        data = trecon.build_target_data(port, c["tcali"], t, targs)
        before = {n: b.clone() for n, b in t.module(port).named_buffers()}
        jv, jl = jrecon.reconstruct_target(j, c["v"], _jax_data(data),
                                           jrecon.ReconArgs(**kw), jax.random.PRNGKey(1))
        tl = trecon.reconstruct_target(t, port, data, targs,
                                       torch.Generator().manual_seed(1))
        jl = np.asarray(jl)
        peak = float(np.abs(jl).max())
        assert np.isfinite(tl.numpy()).all() and tl.shape == jl.shape
        print(f"\n  {name}: losses within {np.abs(tl.numpy() - jl).max() / peak:.3g} "
              f"of the peak")
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=5e-3 * peak)
        share, total = _compare_state(port, jv, t, name)
        assert total == 0 or share > 0.98
        after = dict(t.module(port).named_buffers())
        moved = [n for n in after if not torch.equal(after[n], before[n])]
        if t.act_only:            # only the block's own q/k/w/v deltas
            assert moved and all(re.fullmatch(r"act_quantizer_[qkwv]\.delta", n)
                                 for n in moved), moved
        else:
            assert any(n.endswith("_alpha") for n in moved)
        if t.has_ctx:
            assert data["ctx_q"].shape == (ROWS, CTX_LEN, 24)


# --------------------------------------------------------------------------
# scale init


@pytest.fixture(scope="module")
def calib_w(calibrated):
    """JAX's CALIB_W tree from the port's initial state."""
    c = calibrated
    return jsi.set_weight_quantize_params(c["model"], c["init"], c["cali"])


def test_calib_w_matches_jax(calib_w, calibrated):
    ref, got = _np(calib_w), _np(calibrated["w"])
    n_layers = n_ties = 0

    def walk(g, r, p, params):
        nonlocal n_layers, n_ties
        for k, rv in r.items():
            if isinstance(rv, dict) and k in params:
                walk(g[k], rv, f"{p}/{k}", params[k])
        for part in ("w0", "w1"):
            if f"{part}_delta" not in r:
                continue
            n_layers += 1
            d, z = g[f"{part}_delta"], g[f"{part}_zp"]
            rd, rz = r[f"{part}_delta"], r[f"{part}_zp"]
            differ = ((d != rd) | (z != rz)).reshape(-1)
            if differ.any():             # a tie: JAX's score of both choices
                kernel = params["kernel"]
                axis = kernel.ndim - 2
                split = r["w0_alpha"].shape[axis]
                w = (kernel[..., :split, :] if part == "w0" and "w1_delta" in r else
                     kernel[..., split:, :] if part == "w1" else kernel)
                axes = tuple(range(w.ndim - 1))
                L = 2 ** int(r[f"{part}_bits"])

                def score(dd, zz):
                    fq = jaff.fake_quant_nograd(jnp.asarray(w), jnp.asarray(dd),
                                                jnp.asarray(zz), L)
                    return np.asarray(jnp.mean(jnp.abs(fq - w) ** jsearch.SEARCH_P,
                                               axis=axes))
                sg, sw = score(d, z)[differ], score(rd, rz)[differ]
                assert np.all(np.abs(sg - sw) <= 1e-6 * np.abs(sw)), f"{p} {part}"
                n_ties += int(differ.sum())
            a, ra = g[f"{part}_alpha"], r[f"{part}_alpha"]
            assert a.shape == ra.shape, f"{p} {part}"
            same = ~np.broadcast_to(differ.reshape((1,) * (a.ndim - 1) + (-1,)), a.shape)
            np.testing.assert_allclose(a[same], ra[same], rtol=0, atol=2e-6,
                                       err_msg=f"{p} {part}_alpha")
            assert np.array_equal(a[same] >= 0, ra[same] >= 0), f"{p} {part} masks"

    walk(got["quant"], ref["quant"], "", ref["params"])
    print(f"\n  CALIB_W: {n_layers} weight quantizers, {n_ties} channels on a tie")
    port = _port(calibrated)
    assert n_layers == len([1 for n, _ in port.named_buffers() if n.endswith("_delta")])


def test_calib_a_matches_jax(calib_w, calibrated):
    """CALIB_A streamed in two batches of 3 rows, every port quantizer on
    JAX's input of its call."""
    c = calibrated
    model, jv, records = c["model"], calib_w, []
    for s in (0, 3):
        batch = tuple(a[s:s + 3] for a in c["cali"])

        def step(v, *b):
            rec = {}

            def keep(next_fun, args, kwargs, ctx):
                if (isinstance(ctx.module, jlayers.ActQuantizer)
                        and ctx.method_name == "__call__"
                        and not kwargs.get("params_only", False)):
                    rec.setdefault(".".join(ctx.module.path), []).append(args[0])
                return next_fun(*args, **kwargs)
            with fnn.intercept_methods(keep):
                _, upd = model.apply(v, *b, mode=jconf.CALIB_A, mutable=["quant"])
            return upd["quant"], rec
        quant, rec = jax.jit(step)(jv, *batch)
        jv = {**jv, "quant": quant}
        records.append({k: [(torch.from_numpy(np.array(a)), None) for a in calls]
                        for k, calls in rec.items()})
    port = load_jax_variables(tldm.LDMUNet(_tcfg(TINY[c["family"]]), TQC, device="cpu"),
                              _np(calib_w))
    batches, forward = iter(records), port.forward

    def forced(*args, **kw):
        with tap(port, ActQuantizer, replace=next(batches)):
            return forward(*args, **kw)
    port.forward = forced
    tsi.set_act_quantize_params(port, c["tcali"], batch_size=3, device="cpu")
    del port.forward
    got, ref = to_jax_variables(port)["quant"], _np(jv["quant"])
    n, ties = 0, []

    def walk(g, r, p):
        nonlocal n
        if "inited" in r:
            n += 1
            assert np.array_equal(g["one_side"], r["one_side"]) and bool(g["inited"])
            for k in ("delta", "zero_point"):
                np.testing.assert_allclose(g[k], r[k], rtol=1e-5, atol=0, err_msg=f"{p} {k}")
            lo, hi = (np.isclose(g[k], r[k], rtol=1e-5, atol=0)
                      for k in ("running_min", "running_max"))
            if not (lo and hi):          # two ranges on one grid: a tie
                width = lambda s: float(s["running_max"] - s["running_min"])
                shift = float(g["running_min"] - r["running_min"])
                print(f"\n  {p}: the same grid from a range shifted by {shift:.3g} "
                      f"(delta {float(r['delta']):.6g})")
                assert abs(width(g) - width(r)) <= 1e-5 * width(r), p
                assert abs(shift) < float(r["delta"]), p
                ties.append(p)
            return
        for k, rv in r.items():
            if isinstance(rv, dict):
                walk(g[k], rv, f"{p}/{k}")
    walk(got, ref, "")
    assert n == len(trecon._act_quantizers(port)) and len(ties) <= 0.05 * n
    print(f"\n  CALIB_A: {n} act quantizers, {len(ties)} ranges on a tie")


# --------------------------------------------------------------------------
# samplers' records, api, checkpoints, bundle


def _closed_form(xp):
    """ε(x, t) and an aux a sampler records, in numpy-like ``xp``."""
    def fn(x, t):
        eps = xp.tanh(0.5 * x) * (t[:, None, None, None] / 1000.0) + 0.1 * x
        return eps, ((x * x).mean(axis=(1, 2)) if xp is jnp else (x * x).mean(dim=(1, 2)))
    return fn


def _jax_noise(key, shape, steps):
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    return out


@pytest.mark.parametrize("sampler,eta", [("ddim", 1.0), ("plms", 0.0)])
def test_sampler_records_match_jax(sampler, eta):
    steps, shape = 5, (3, 4, 4, 2)
    x_T = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(2)
    js, ts = (getattr(m, f"ldm_{sampler}_sample") for m in (jlat, tlat))
    want_x, want = js(jnp.asarray(x_T), jlat.make_ldm_schedule(ddim_steps=steps, eta=eta),
                      _closed_form(jnp), key=key, record_xt=True, model_returns_aux=True)
    got_x, got = ts(torch.from_numpy(x_T), tlat.make_ldm_schedule(ddim_steps=steps, eta=eta),
                    _closed_form(torch), device="cpu", record_xt=True,
                    model_returns_aux=True,
                    noise=_jax_noise(key, shape, steps) if eta else None)
    keys = {"x", "aux", "t", "index"} | ({"t_next"} if sampler == "plms" else set())
    assert set(got) == set(want) == keys
    for k in keys:
        if k in ("x", "aux"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-5, atol=1e-5)
    # without a record the sampler returns the latents alone
    eps = lambda x, t: _closed_form(torch)(x, t)[0]
    alone = ts(torch.from_numpy(x_T), tlat.make_ldm_schedule(ddim_steps=steps, eta=eta),
               eps, device="cpu", noise=_jax_noise(key, shape, steps) if eta else None)
    assert torch.equal(alone, got_x)


def test_api_reconstruct_takes_the_ldm_plan():
    """The church-like model (its initial state: the plan, not the values,
    is under test), one iteration a target."""
    port, done = tldm.LDMUNet(_tcfg(TINY["church"]), TQC, device="cpu", seed=0), []
    tcali = tuple(torch.from_numpy(a) for a in _data("church"))
    plan = tldm.ldm_recon_plan(port.cfg, port.qc)
    before = port.out_2.w0_alpha.clone()
    api.reconstruct(port, tcali, args=trecon.ReconArgs(iters=1, batch_size=4),
                    device="cpu",
                    progress=lambda name, loss: done.append((name, loss)))
    assert [n for n, _ in done] == [t.name for t in plan]
    assert all(np.isfinite(loss) for _, loss in done)
    assert not torch.equal(port.out_2.w0_alpha, before)


def test_resumable_reconstruct_on_an_ldm_plan(calibrated, tmp_path, monkeypatch):
    """Interrupted after its first group and resumed from the checkpoint
    (a fresh model), the run ends where an uninterrupted one does; random
    draws on (batch 4 of 6 rows, input mixing, QDrop 0.5)."""
    c = calibrated
    qc = tconf.QuantConfig()
    fresh = lambda: _port(c, qc)
    plan = tldm.ldm_recon_plan(_tcfg(TINY[c["family"]]), qc)[:5]
    args = trecon.ReconArgs(iters=1, batch_size=4)
    full = checkpointing.resumable_reconstruct(fresh(), c["tcali"], plan, args,
                                               str(tmp_path / "a"), seed=9, group_size=4)
    real, calls = trecon.reconstruct, []

    def stop_after_one(*a, **k):
        if calls:
            raise KeyboardInterrupt
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(trecon, "reconstruct", stop_after_one)
    with pytest.raises(KeyboardInterrupt):
        checkpointing.resumable_reconstruct(fresh(), c["tcali"], plan, args,
                                            str(tmp_path / "b"), seed=9, group_size=4)
    monkeypatch.setattr(trecon, "reconstruct", real)
    done = checkpointing.load_meta(str(tmp_path / "b" / "recon_state.pt"))["completed"]
    assert 0 < done < len(plan)
    resumed = checkpointing.resumable_reconstruct(fresh(), c["tcali"], plan, args,
                                                  str(tmp_path / "b"), seed=9,
                                                  group_size=4)
    a, b = dict(full.named_buffers()), dict(resumed.named_buffers())
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_ldm_bundle_serves_like_the_export(calibrated, tmp_path):
    c = calibrated
    port = _port(c, tconf.QuantConfig())
    args = tuple(a[:2] for a in c["tcali"])

    def int8(m):
        with torch.no_grad():
            return m(args[0].bfloat16(), *args[1:], mode=tconf.DEPLOY_INT8)
    exported, mode = api.export_for_serving(port, port.qc, kind="int8")
    ref = int8(exported)
    bundle, stats = texport.serving_bundle(port)
    assert bundle["arch"]["family"] == "ldm"
    restored = texport.restore_serving_bundle(bundle, device="cpu")
    assert isinstance(restored, tldm.LDMUNet) and torch.equal(int8(restored), ref)
    assert api.save_bundle(port, port.qc, str(tmp_path / "b.pt")) == stats
    loaded, lmode = api.load_bundle(str(tmp_path / "b.pt"), device="cpu")
    assert lmode == mode == tconf.DEPLOY_INT8 and torch.equal(int8(loaded), ref)
    assert stats["fp32_bytes"] == 4 * sum(p.numel() for p in port.parameters())
