"""The port's quantizer arithmetic and scale initialization against the JAX
package, on the CPU (tiny DDPM, ``jax_default_matmul_precision`` highest).

* Modes and specs equal JAX's field by field.  ``round_ste``,
  ``fake_quant`` and soft AdaRound: values and gradients within 1e-6 of
  ``jax.grad``'s (both libraries pass half the gradient at a clip bound).
  ``lp_loss``, ``ema_update``, ``qdrop`` on an injected mask: within 1e-6.
* CALIB_W: every layer's (delta, zp) equal, or, where a channel's choice
  differs, a tie (JAX's L^2.4 score of the port's choice within 1e-6
  relative of its own, as ``tests/test_torch_search.py`` holds the
  search); alphas within 2e-6 with equal signs (the hard masks): XLA's
  CPU ``log`` and division are not IEEE-exact, so the alphas differ in
  their last bits.
* CALIB_A over 3 batches with a ragged tail (5, 5, 2 rows): the tiny
  model on JAX's CALIB_W state, every quantizer calibrated on JAX's own
  input of each batch (teacher forcing, ``parity.tap``), so that no float
  drift of the quantized prefix moves a search (the exact search on its
  small tensors, the histogram past 16,384 elements); and single
  quantizers on the same inputs in both packages: symmetric on the exact
  search (``search_bins=0``) and the forced histogram (``search_bins=64``,
  also an 8-bit softmax-output spec), ``a_sym`` on the 2-D histogram and
  the 2-D exact search (20 candidates, to keep them short) and one-sided,
  the side found on batch 1 passed on as ``static_sides``.  ``one_side``
  and ``inited`` equal; ``delta``, ``zero_point``, ``running_min`` and
  ``running_max`` within rel 1e-5.
* WQ and WAQ forwards of JAX's calibrated tree: module by module on JAX's
  input and the whole output through the flip-aware gate of
  ``tests/test_torch_ddpm.py``.
"""

import dataclasses
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.calib import scale_init as jsi
from eda_dm_tpu.models.ddpm_unet import DDPMConfig as JCfg, DDPMUNet as JUNet
from eda_dm_tpu.nn import layers as jlayers
from eda_dm_tpu.quant import adaround as jada
from eda_dm_tpu.quant import affine as jaff
from eda_dm_tpu.quant import config as jconf
from eda_dm_tpu.quant import search as jsearch
from eda_dm_tpu_torch.calib import scale_init as tsi
from eda_dm_tpu_torch.models.bridge import (from_jax_variables, load_jax_variables,
                                            to_jax_variables)
from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig
from eda_dm_tpu_torch.nn.layers import ActQuantizer
from eda_dm_tpu_torch.parity import tap
from eda_dm_tpu_torch.quant import adaround as tada
from eda_dm_tpu_torch.quant import affine as taff
from eda_dm_tpu_torch.quant import config as tconf
from test_torch_ddpm import _against_jax, _flip_gate

TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=16)
ROWS, ACT_BATCH = 12, 5                     # batches of 5, 5 and a ragged 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_name(path):
    return ".".join(re.sub(r"^(down|up|block|attn)_(\d+)$", r"\1.\2", p) for p in path)


# --------------------------------------------------------------------------
# config and affine


@pytest.mark.parametrize("name", ["FP", "CALIB_W", "CALIB_A", "WQ", "WAQ", "DEPLOY",
                                  "DEPLOY_FUSED", "DEPLOY_INT8"])
def test_modes_match_jax(name):
    from eda_dm_tpu.quant import export as jexport
    want = getattr(jconf, name, None) or getattr(jexport, name)
    assert dataclasses.asdict(getattr(tconf, name)) == dataclasses.asdict(want)


@pytest.mark.parametrize("kw", [{}, {"a_sym": True}, {"prob": 1.0, "weight_bit": 8},
                                {"quant_act": False, "sm_abit": 4}])
def test_specs_match_jax(kw):
    t, j = tconf.QuantConfig(**kw), jconf.QuantConfig(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for spec in ("wq", "aq"):
        assert dataclasses.asdict(getattr(t, spec)) == dataclasses.asdict(getattr(j, spec))
    for args in ({}, {"always_zero": False}, {"always_zero": True, "symmetric": False}):
        assert (dataclasses.asdict(t.aq_softmax(**args))
                == dataclasses.asdict(j.aq_softmax(**args)))


def _grads(jfn, tfn, arrays, argnums):
    """Values and gradients (of the sum) of ``jfn`` and ``tfn`` on the same
    numpy inputs."""
    jv = np.asarray(jfn(*map(jnp.asarray, arrays)))
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a)), argnums=argnums)(*map(jnp.asarray, arrays))
    ts = [torch.tensor(a, requires_grad=i in argnums) for i, a in enumerate(arrays)]
    out = tfn(*ts)
    out.sum().backward()
    return jv, out.detach().numpy(), [np.asarray(g) for g in jg], [ts[i].grad.numpy()
                                                                   for i in argnums]


@pytest.mark.parametrize("which", ["round_ste", "fake_quant", "soft_adaround",
                                   "round_regularization"])
def test_values_and_gradients_match_jax(which):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, 16)) * 2).astype(np.float32)
    delta = np.float32(0.05)
    if which == "round_ste":
        case = (jaff.round_ste, taff.round_ste, (x * 7,), (0,))
    elif which == "fake_quant":
        # values at and beyond the clip bounds: codes -zp and L-1-zp exactly
        xq = np.concatenate([x.reshape(-1), np.float32([-6.4, 6.35, -7.0, 9.0])])
        zp = np.float32(128.0)
        case = (lambda a, d: jaff.fake_quant(a, d, zp, 256),
                lambda a, d: taff.fake_quant(a, d, torch.tensor(zp), 256),
                (xq * 3, delta), (0, 1))
    elif which == "soft_adaround":
        w = x * 0.1
        d = np.abs(rng.standard_normal((1, 16))).astype(np.float32) * 0.02 + 0.01
        zp = np.full((1, 16), 8.0, np.float32)
        alpha = (rng.standard_normal((64, 16)) * 3).astype(np.float32)
        case = (lambda a: jada.adaround_fake_quant(jnp.asarray(w), jnp.asarray(d),
                                                   jnp.asarray(zp), a, 16, True),
                lambda a: tada.adaround_fake_quant(torch.from_numpy(w), torch.from_numpy(d),
                                                   torch.from_numpy(zp), a, 16, True),
                (alpha,), (0,))
    else:
        alpha = (rng.standard_normal((64, 16)) * 3).astype(np.float32)
        case = (lambda a: jada.round_regularization(a, 12.5),
                lambda a: tada.round_regularization(a, 12.5), (alpha,), (0,))
    jfn, tfn, arrays, argnums = case
    jv, tv, jg, tg = _grads(jfn, tfn, arrays, argnums)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_lp_loss_ema_qdrop_match_jax():
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal((2, 4, 4, 8)).astype(np.float32) for _ in range(2))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for p, axis in ((2.0, None), (2.0, -1), (2.4, -1)):
        np.testing.assert_allclose(float(taff.lp_loss(ta, tb, p, axis)),
                                   float(jaff.lp_loss(a, b, p, axis)), rtol=1e-6)
    got = taff.ema_update(torch.tensor(-1.5), torch.tensor(2.0), torch.tensor(-0.5),
                          torch.tensor(3.0))
    want = jaff.ema_update(jnp.float32(-1.5), jnp.float32(2.0), jnp.float32(-0.5),
                           jnp.float32(3.0))
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want], rtol=1e-6)
    mask = rng.random(a.shape) < 0.5
    want = jnp.where(jnp.asarray(mask), jnp.asarray(a), jnp.asarray(b))
    got = taff.qdrop(ta, tb, 0.5, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qdrop_forward_needs_a_generator():
    q = ActQuantizer(tconf.QuantConfig().aq)
    mode = tconf.WAQ.replace(training=True)
    with pytest.raises(RuntimeError, match="generator"):
        q(torch.ones(4), mode)
    q.generator = torch.Generator().manual_seed(0)
    a = q(torch.linspace(-1, 1, 1000), mode)
    q.generator = torch.Generator().manual_seed(1)
    assert not torch.equal(a, q(torch.linspace(-1, 1, 1000), mode))


# --------------------------------------------------------------------------
# scale init


def _configs(a_sym, bins, num):
    """(JAX, port) QuantConfigs whose act specs have ``bins`` and ``num``."""
    def sub(base):
        @dataclasses.dataclass(frozen=True)
        class QC(base):
            bins: int = 4096
            num: int = 100

            @property
            def aq(self):
                return dataclasses.replace(super().aq, search_bins=self.bins,
                                           num_candidates=self.num)
        return QC(a_sym=a_sym, bins=bins, num=num)
    return sub(jconf.QuantConfig), sub(tconf.QuantConfig)


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((ROWS, 16, 16, 3)).astype(np.float32)
    t = rng.integers(0, 100, ROWS).astype(np.float32)
    return x, t


@pytest.fixture(scope="module")
def calib_w():
    """JAX's CALIB_W tree and the port's CALIB_W model from one init."""
    jqc, tqc = _configs(False, 4096, 100)
    model = JUNet(cfg=JCfg(**TINY), qc=jqc)
    x, t = _data()
    v = jax.jit(lambda k, x, t: model.init(k, x, t, jconf.FP))(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]), jnp.asarray(t[:1]))
    port = from_jax_variables(_np(v), DDPMConfig(**TINY), tqc, device="cpu")
    jv = jsi.set_weight_quantize_params(model, v, (jnp.asarray(x), jnp.asarray(t)))
    tsi.set_weight_quantize_params(port, (torch.from_numpy(x), torch.from_numpy(t)),
                                   device="cpu")
    return dict(model=model, v=v, jv=jv, port=port)


def test_calib_w_matches_jax(calib_w):
    ref, got = _np(calib_w["jv"]), to_jax_variables(calib_w["port"])
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
            assert a.dtype == np.float32 and a.shape == ra.shape, f"{p} {part}"
            same = ~np.broadcast_to(differ.reshape((1,) * (a.ndim - 1) + (-1,)), a.shape)
            np.testing.assert_allclose(a[same], ra[same], rtol=0, atol=2e-6,
                                       err_msg=f"{p} {part}_alpha")
            assert np.array_equal(a[same] >= 0, ra[same] >= 0), f"{p} {part} masks"

    walk(got["quant"], ref["quant"], "", ref["params"])
    print(f"\n  CALIB_W: {n_layers} weight quantizers, {n_ties} channels decided on a tie")
    assert n_layers == 55                   # 45 layers, 10 split in two


def _jax_calib_a(model, v, x, t):
    """JAX's CALIB_A over the batches, returning the quant tree and, per
    batch, every act quantizer's input under the port's module names."""
    records = []
    for s in range(0, ROWS, ACT_BATCH):
        def step(v, xb, tb):
            rec = {}

            def keep(next_fun, args, kwargs, ctx):
                if (isinstance(ctx.module, jlayers.ActQuantizer)
                        and ctx.method_name == "__call__"
                        and not kwargs.get("params_only", False)):
                    rec.setdefault(_port_name(ctx.module.path), []).append(args[0])
                return next_fun(*args, **kwargs)
            with fnn.intercept_methods(keep):
                _, upd = model.apply(v, xb, tb, mode=jconf.CALIB_A, mutable=["quant"])
            return upd["quant"], rec
        quant, rec = jax.jit(step)(v, jnp.asarray(x[s:s + ACT_BATCH]),
                                   jnp.asarray(t[s:s + ACT_BATCH]))
        v = {**v, "quant": quant}
        records.append({k: [(torch.from_numpy(np.array(a)), None) for a in calls]
                        for k, calls in rec.items()})
    return v, records


@pytest.fixture(scope="module")
def calibrated(calib_w):
    """JAX's calibrated tree (CALIB_W, then CALIB_A in batches of 5, 5, 2)
    and the port's CALIB_A on the same batches with each quantizer on
    JAX's input of that batch."""
    x, t = _data()
    jv, records = _jax_calib_a(calib_w["model"], calib_w["jv"], x, t)
    port = from_jax_variables(_np(calib_w["jv"]), DDPMConfig(**TINY),
                              tconf.QuantConfig(), device="cpu")
    batches = iter(records)
    forward = port.forward

    def forced(*args, **kw):
        with tap(port, ActQuantizer, replace=next(batches)):
            return forward(*args, **kw)
    port.forward = forced
    tsi.set_act_quantize_params(port, (torch.from_numpy(x), torch.from_numpy(t)),
                                batch_size=ACT_BATCH, device="cpu")
    del port.forward
    return calib_w["model"], jv, port


def _act_state_close(got, ref):
    """one_side and inited equal, delta, zero_point and the running range
    within rel 1e-5; returns the number of quantizers compared."""
    assert np.array_equal(got["one_side"], ref["one_side"])
    assert bool(got["inited"]) and bool(ref["inited"])
    for k in ("delta", "zero_point", "running_min", "running_max"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=0, err_msg=k)


def test_calib_a_matches_jax(calibrated):
    """The tiny model's CALIB_A (the exact search on its small tensors, the
    histogram past 16,384 elements) streamed over three batches, a ragged
    tail included."""
    _, jv, port = calibrated
    got, ref = to_jax_variables(port)["quant"], _np(jv["quant"])
    n = 0

    def walk(g, r, p):
        nonlocal n
        if "inited" in r:
            n += 1
            _act_state_close(g, r)
            return
        for k, rv in r.items():
            if isinstance(rv, dict):
                walk(g[k], rv, f"{p}/{k}")
    walk(got, ref, "")
    assert n == 70                          # every act quantizer JAX calibrated


@pytest.mark.parametrize("a_sym,bins,kind", [
    (False, 0, "two"), (False, 64, "two"), (False, 64, "softmax"),
    (True, 64, "two"), (True, 0, "small"), (True, 64, "pos")],
    ids=["exact", "histogram", "softmax_histogram", "a_sym_histogram",
         "a_sym_exact", "a_sym_one_sided"])
def test_act_quantizer_streaming_matches_jax(a_sym, bins, kind):
    """One act quantizer over three batches (5, 5 and a ragged 2 rows) in
    CALIB_A, JAX's ``ActQuantizer`` against the port's on the same inputs;
    under ``a_sym`` the side found on batch 1 is passed to batches 2 and 3
    as ``static_sides``, as ``set_act_quantize_params`` hoists it."""
    jqc, tqc = _configs(a_sym, bins, 20 if a_sym else 100)
    spec_j, spec_t = jqc.aq, tqc.aq
    if kind == "softmax":
        spec_j, spec_t = jqc.aq_softmax(False), tqc.aq_softmax(False)
    rng = np.random.default_rng({"two": 3, "small": 4, "pos": 5, "softmax": 6}[kind])
    shape = (4, 4, 8) if kind == "small" else (16, 16, 32)
    batches = []
    for n in (5, 5, 2):
        b = (np.abs(rng.standard_normal((n,) + shape)) ** 3 - 0.3)
        if kind == "pos":
            b = np.abs(b)
        elif kind == "softmax":
            b = np.exp(b * 2) / np.exp(b * 2).sum(-1, keepdims=True)
        batches.append(b.astype(np.float32))
    jq, tq = jlayers.ActQuantizer(spec_j), ActQuantizer(spec_t)
    jmode, tmode = jconf.CALIB_A, tconf.CALIB_A
    quant = jq.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]), jconf.FP)["quant"]
    for b in batches:
        _, upd = jax.jit(lambda q, x: jq.apply({"quant": q}, x, jmode,
                                               mutable=["quant"]))(quant, jnp.asarray(b))
        quant = upd["quant"]
        tq(torch.from_numpy(b), tmode)
        if a_sym and jmode.static_sides is None:
            jmode = jmode.replace(static_sides=(((), int(quant["one_side"])),))
            tmode = tmode.replace(static_sides=((tq.name, int(tq.one_side)),))
    got = {k: getattr(tq, k).numpy() for k in
           ("delta", "zero_point", "running_min", "running_max", "one_side", "inited")}
    _act_state_close(got, _np(quant))


@pytest.mark.parametrize("mode", ["WQ", "WAQ"])
def test_calibrated_forward_matches_jax(calibrated, mode):
    """WQ and WAQ of JAX's calibrated tree in the port."""
    model, jv, _ = calibrated
    x, t = _data()
    port = from_jax_variables(_np(jv), DDPMConfig(**TINY), tconf.QuantConfig(), device="cpu")
    ref, out, flips = _against_jax(model, jv, port, x[:4], t[:4], getattr(jconf, mode),
                                   getattr(tconf, mode))
    assert np.isfinite(out).all() and out.shape == ref.shape
    _flip_gate(out, ref, 0.15, share=flips == 0)


def test_bridge_carries_the_calibration_state(calibrated):
    """A calibrated tree crosses in both directions with its EMA state;
    a tree without that state loads and leaves the module's."""
    model, jv, _ = calibrated
    jv = _np(jv)
    x, t = _data()
    port = from_jax_variables(jv, DDPMConfig(**TINY), tconf.QuantConfig(), device="cpu")
    back = to_jax_variables(port)["quant"]
    q = port.mid_attn_1.act_quantizer_w
    assert bool(q.inited) and q.one_side.dtype == torch.int32
    for k in ("running_min", "running_max", "one_side", "inited", "delta", "zero_point"):
        np.testing.assert_array_equal(back["mid_attn_1"]["act_quantizer_w"][k],
                                      jv["quant"]["mid_attn_1"]["act_quantizer_w"][k])
    assert "act_quantizer" not in back["conv_out"]           # never called
    # the JAX model runs on the port's tree as on its own
    waq = jax.jit(lambda v: model.apply(v, jnp.asarray(x[:2]), jnp.asarray(t[:2]),
                                        jconf.WAQ))
    np.testing.assert_array_equal(np.asarray(waq({"params": jv["params"], "quant": back})),
                                  np.asarray(waq(jv)))

    def drop(tree):
        return {k: drop(v) if isinstance(v, dict) else v for k, v in tree.items()
                if k not in ("running_min", "running_max", "one_side", "inited")}
    load_jax_variables(port, {"params": jv["params"], "quant": drop(jv["quant"])})
    assert bool(q.inited)                     # kept the module's state
