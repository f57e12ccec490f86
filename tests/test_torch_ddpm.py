"""The port's DDPM UNet vs the JAX package on a JAX-calibrated tiny model.

The JAX tree goes CALIB_W → CALIB_A → export once per module; the port gets
it through ``models/bridge.py`` and runs on the CPU (the kernels' plain
versions).  Both packages take their default attention branch: at this
small batch the fused attention (K4's plain version, JAX's Pallas kernel in
interpret mode).  The serving switches put both packages on one branch
under one environment (``monkeypatch.setenv``, nothing of the port's
policy patched): the einsum + softmax-codes branch (``EDM_FUSED_ATTN=0``),
with a float32 softmax in place of the codes kernel
(``EDM_FUSED_SOFTMAX=0``), the fake-quant attention (``EDM_INT8_ATTN=0``)
and the folded convs (``EDM_INT8_CONV=0``), each with spies that count
which kernels each package called.

Tolerances: the FP forward atol 1e-4; single blocks on a shared input
rtol = atol = 2e-5 (f32 association only).  The quantized whole-model
paths are held in three ways:

* every act quantizer, GroupNorm, conv and dense on JAX's input (teacher
  forcing, ``eda_dm_tpu_torch.parity.tap``), and the ops between them,
  within rtol = atol = 2e-5 of JAX;
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

The fused serving paths are held the same way, with spies (``k6_spy``,
``k7_spy``) that count each package's fused-kernel calls: DEPLOY_INT8 with
the fused GroupNorm (``EDM_FUSED_GN=1``, and ``EDM_FUSED_GN_NARROW=1`` for
this model's 32- to 128-channel widths) at every one of its 21 norm sites,
where a code computed inside K6 may flip on a tie (``gn_code_flips``); and
DEPLOY_FUSED, with the fused fake-quant matmul (K7) at each of its 31 1×1
convs and denses.
"""

import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.models import ddpm_unet as jddpm
from eda_dm_tpu.models import ldm_unet as jldm
from eda_dm_tpu.models.ddpm_unet import (AttnBlockD as JAttn, DDPMConfig as JCfg,
                                         DDPMUNet as JUNet,
                                         ResnetBlockD as JRes)
from eda_dm_tpu.nn import layers as jlayers
from eda_dm_tpu.ops import pallas_gn as jgn
from eda_dm_tpu.ops import pallas_quant as jpq
from eda_dm_tpu.quant import CALIB_A, CALIB_W, FP as JFP, QuantConfig as JQC
from eda_dm_tpu.quant import export as jexport
from eda_dm_tpu.samplers import ddim as jddim
from eda_dm_tpu.samplers.schedules import (alphas_cumprod_padded as jalphas,
                                           get_beta_schedule, skip_sequence)
from eda_dm_tpu_torch.models.bridge import (from_jax_variables,
                                            load_jax_variables, to_jax_variables)
from eda_dm_tpu_torch.models import ldm_unet as tldm
from eda_dm_tpu_torch.models.ddpm_unet import (AttnBlockD, DDPMConfig,
                                               ResnetBlockD)
from eda_dm_tpu_torch.nn import layers as tlayers
from eda_dm_tpu_torch.nn.layers import ActQuantizer, GNorm, LayerNorm, QConv, QDense
from eda_dm_tpu_torch.ops.serving_policy import int8_conv_serving
from eda_dm_tpu_torch.parity import act_code_flips, tap
from eda_dm_tpu_torch.quant import (DEPLOY, DEPLOY_FUSED, DEPLOY_INT8, FP,
                                    QuantConfig)
from eda_dm_tpu_torch.quant.export import export_serving_int8
from eda_dm_tpu_torch.samplers.ddim import ddim_denoise_step, generalized_steps
from eda_dm_tpu_torch.samplers.schedules import alphas_cumprod_padded



def _share_cores():
    """Under pytest-xdist every worker would run PyTorch's CPU ops on all of
    the machine's cores: with six workers on eight cores, the workers'
    spinning OpenMP threads slow each op by tens of times.  Each worker
    takes its share of the cores instead (one thread at six workers on
    eight).  Every worker imports every test file, so this runs in each;
    alone, pytest keeps PyTorch's default."""
    import os
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))


_share_cores()

TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=16)
CFG, JCFG = DDPMConfig(**TINY), JCfg(**TINY)
QC, JQC_ = QuantConfig(weight_bit=4, act_bit=8), JQC(weight_bit=4, act_bit=8)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def calibrated():
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
    return dict(model=model, v=v, x=x, t=t,
                int8=jexport.export_serving_int8(v, JQC_, dtype=jnp.float32))


@pytest.fixture
def branch_spy(monkeypatch):
    """Counts, per package, of the attention kernels' calls: the fused
    attention (K4) and the softmax-codes kernel (K3, which serves the
    einsum branch unless ``EDM_FUSED_SOFTMAX=0``)."""
    import eda_dm_tpu_torch.models.ddpm_unet as port_unet
    import eda_dm_tpu_torch.ops.softmax_codes as port_softmax
    seen = {"jax": 0, "port": 0}
    counts = {}
    for side, module, name in (("jax", jddpm, "int8_fused_attention"),
                               ("jax", jddpm, "softmax_int8_codes"),
                               ("port", port_unet, "int8_fused_attention"),
                               ("port", port_softmax, "softmax_int8_codes")):
        key = (side, name.replace("int8_", "").replace("_int8", ""))
        counts[key] = {"jax": 0, "port": 0}
        _count_calls(monkeypatch, module, name, counts[key], side)
    return lambda: {k: v[k[0]] for k, v in counts.items()}


@pytest.fixture
def einsum_attention(monkeypatch, branch_spy):
    """Both packages on the einsum + softmax-codes attention branch, by the
    switch alone."""
    monkeypatch.setenv("EDM_FUSED_ATTN", "0")
    return branch_spy


def _flip_gate(out, ref, max_abs, share=True, median=True):
    """The whole-output bounds: max |Δ| < ``max_abs`` always; the median
    below 2e-4 where ``median`` and the share with |Δ| < 2e-4 above 0.7
    where ``share`` (callers pass "no code flipped" for either)."""
    d = np.abs(np.asarray(out, np.float32) - np.asarray(ref, np.float32))
    if median:
        assert np.median(d) < 2e-4, np.median(d)
    assert d.max() < max_abs, d.max()
    if share:
        assert (d < 2e-4).mean() > 0.7, (d < 2e-4).mean()


_JAX_KINDS = (jlayers.ActQuantizer, jlayers.GNorm, jlayers.QConv, jlayers.QDense,
              fnn.LayerNorm)
_PORT_KINDS = (ActQuantizer, GNorm, QConv, QDense, LayerNorm)
# the modules that take an attention kernel's output (the LDM and DDPM
# blocks' proj_out, the transformer's to_out_0)
_AFTER_ATTN = (".proj_out", ".to_out_0")


def _port_name(path):
    """JAX module path -> the port's module name (``down_0`` -> ``down.0``)."""
    return ".".join(re.sub(r"^(down|up|block|attn)_(\d+)$", r"\1.\2", p)
                    for p in path)


def _jax_tapped(model, tree, args, mode, jit=False):
    """``model.apply(tree, *args)`` recording, as ``parity.tap`` does for
    the port, the first input and the output of every act quantizer,
    GroupNorm, LayerNorm, conv and dense call, under the port's module
    names.  Op by op, or with ``jit`` one compiled program
    (:func:`_jax_tapped_jit`)."""
    if jit:
        return _jax_tapped_jit(model, tree, args, mode)
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
        out = model.apply(tree, *[None if a is None else jnp.asarray(a)
                                  for a in args], mode=mode)
    return np.asarray(out), rec


# one compiled tapped program per (model, mode, serving switches, matmul
# precision, test phase, input and tree shapes): the steps of a sampler
# test reuse it.  Keyed on the test phase too, so a spy on a JAX function
# that a test sets sees the trace of its own program, not one cached by
# another test.  XLA's constant folding, algebraic simplifier and fusion
# would round some values otherwise than the op-by-op run does (the
# timestep embedding's frequencies folded at compile time, a division
# turned into a product, bf16 intermediates kept in float32), so they are
# off: the program's records then equal the op-by-op run's but for a few
# last bits (layouts chosen across ops order a reduction otherwise).  A
# test takes it only where its gates admit a code flipped on such a tie.
_TAPPED = {}
_AS_EAGER = {"xla_disable_hlo_passes": "constant_folding,algsimp,fusion",
             "xla_allow_excess_precision": False}


def _jax_tapped_jit(model, tree, args, mode):
    """:func:`_jax_tapped` as one program, compiled once for the calls
    that share its key."""
    import os
    present = tuple(a is not None for a in args)
    arrays = [jnp.asarray(a) for a in args if a is not None]
    sig = lambda xs: tuple((tuple(x.shape), str(x.dtype)) for x in xs)
    key = (id(model), mode, present,
           tuple(sorted((k, v) for k, v in os.environ.items() if k.startswith("EDM_"))),
           str(jax.config.jax_default_matmul_precision),
           os.environ.get("PYTEST_CURRENT_TEST"), sig(arrays),
           jax.tree.structure(tree), sig(jax.tree.leaves(tree)))
    if key not in _TAPPED:
        def fn(tree, *arrays):
            rec, given = {}, iter(arrays)

            def keep(next_fun, a, kw, ctx):
                out = next_fun(*a, **kw)
                if (isinstance(ctx.module, _JAX_KINDS) and ctx.method_name == "__call__"
                        and a and a[0] is not None):
                    rec.setdefault(_port_name(ctx.module.path), []).append(
                        (a[0], out if isinstance(out, jax.Array) else None))
                return out

            with fnn.intercept_methods(keep):
                out = model.apply(tree, *[next(given) if p else None for p in present],
                                  mode=mode)
            return out, rec
        _TAPPED[key] = (model, jax.jit(fn).lower(tree, *arrays).compile(_AS_EAGER))
    out, rec = _TAPPED[key][1](tree, *arrays)
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32))
    return np.asarray(out), {name: [(f32(i), None if o is None else f32(o))
                                    for i, o in calls] for name, calls in rec.items()}


def _against_jax(model, tree, port, x, t, jmode, mode,
                 attn_code_flips=False, context=None, gn_code_flips=False,
                 attn_flip_share=1e-3, jit=False):
    """:func:`_against_jax_args` on a UNet's ``(x, t[, context])``."""
    args = (x, t) if context is None else (x, t, context)
    return _against_jax_args(model, tree, port, args, jmode, mode,
                             attn_code_flips, tag=f"t={float(np.asarray(t)[0]):g}",
                             gn_code_flips=gn_code_flips,
                             attn_flip_share=attn_flip_share, jit=jit)


def _torch(a):
    """A numpy / JAX array (bf16 included) as a CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _against_jax_args(model, tree, port, args, jmode, mode,
                      attn_code_flips=False, tag="", tol=2e-5,
                      int8_exact=False, gn_code_flips=False, attn_flip_share=1e-3,
                      jit=False):
    """JAX's and the port's output on one input.  On the way, every module
    of the port computed on JAX's input must give JAX's output, and the
    ops between modules JAX's input of the next (rtol = atol = ``tol``,
    2e-5; with ``int8_exact`` the int8 convs and denses bit for bit); and
    in the free run the first act code that differs from JAX's must sit on
    a rounding tie.  Returns (JAX out, port out, codes that differ).

    ``attn_code_flips``: in DEPLOY_INT8 the softmax codes are computed
    inside the attention kernels, where no module can be forced onto JAX's
    input, and at S = 256 a code or two sits on a tie of the two ``exp``s.
    A flipped code W[i, j] moves the head's output at query i by about
    dw·v̂_j, so the input of ``proj_out`` may then differ beyond 2e-5 on at
    most 0.1 % of its elements, by at most 1 % of its largest value, and
    the first act code to differ in the free run may be that of a
    ``proj_out`` (``to_out_0`` in the transformer blocks).  A model with
    one head and few query rows moves a whole row of C channels with one
    flipped code: its caller passes ``attn_flip_share``, the share of the
    elements that the flips it admits may move (0.1 % by default).
    ``jit``: JAX's run as one compiled program (:func:`_jax_tapped_jit`),
    for the steps of a sampler, whose gates admit flipped codes.

    ``gn_code_flips``: with the fused GroupNorm (K6) the act codes of a
    conv's input are computed inside the kernel from statistics that the
    port adds in float64 and JAX in float32, so a code on a tie may flip
    there.  One flipped code moves up to 9·Cout outputs of a 3×3 conv;
    the residual add carries them into the next module's input, and a
    fused ``gn_norm`` there (which normalizes the port's own input, not
    the forced one) spreads a little of it over the group.  So every
    module's input and output may then differ beyond 2e-5 on at most 5 %
    of its elements, by at most 2 % of its largest value; and since no
    quantizer sees the flipped codes, the first act code to differ in the
    free run need not sit on a tie."""
    ref, jrec = _jax_tapped(model, tree, args, jmode, jit)
    targs = [None if a is None else _torch(a) for a in args]
    mods = dict(port.named_modules())
    with torch.no_grad():
        with tap(port, _PORT_KINDS, replace=jrec) as forced:
            port(*targs, mode=mode)
        with tap(port, ActQuantizer) as free:
            out = port(*targs, mode=mode).float().numpy()
    for name, calls in forced.items():
        for (x_port, o_port), (x_jax, o_jax) in zip(calls, jrec[name]):
            if attn_code_flips and f".{name}".endswith(_AFTER_ATTN):
                d = (x_port - x_jax).abs()
                off = d > 2e-5 + 2e-5 * x_jax.abs()
                print(f"\n  input of {name}: {int(off.sum())} of {d.numel()}"
                      f" beyond 2e-5, max |d| {float(d.max()):.3g}")
                assert float(off.float().mean()) <= attn_flip_share, name
                assert float(d.max()) <= 0.01 * float(x_jax.abs().max()), name
                continue
            if gn_code_flips:
                for what, a, b in (("input", x_port, x_jax), ("output", o_port, o_jax)):
                    if b is None or not isinstance(a, torch.Tensor):
                        continue
                    d = (a - b).abs()
                    off = d > tol + tol * b.abs()
                    if off.any():
                        print(f"\n  {what} of {name}: {int(off.sum())} of "
                              f"{d.numel()} beyond {tol}, max |d| {float(d.max()):.3g}")
                    assert float(off.float().mean()) <= 5e-2, f"{what} of {name}"
                    assert float(d.max()) <= 0.02 * float(b.abs().max()), f"{what} of {name}"
                continue
            torch.testing.assert_close(x_port, x_jax, rtol=tol, atol=tol,
                                       msg=f"input of {name}")
            m = mods[name]
            if (int8_exact and isinstance(m, (QConv, QDense))
                    and int8_conv_serving(mode, m.wq, m.aq, m.disable_act_quant,
                                          getattr(m, "split", 0))):
                assert torch.equal(o_port, o_jax), f"output of {name}"
            elif o_jax is not None:        # not a quantizer's params_only call
                torch.testing.assert_close(o_port, o_jax, rtol=tol,
                                           atol=tol, msg=f"output of {name}")
    rows = act_code_flips(port, free, jrec)
    first = next((r for r in rows if r[2]), None)
    # a softmax code flipped inside the attention kernel shows first at the
    # quantizer of the proj_out it feeds (held by the forced run above)
    after_attn = (attn_code_flips and first is not None
                  and f".{first[0]}".endswith(tuple(f"{a}.act_quantizer"
                                                    for a in _AFTER_ATTN)))
    assert first is None or first[3] <= tol or after_attn or gn_code_flips, first
    d = np.abs(out - ref.astype(np.float32))
    print(f"\n  {tag}: {sum(r[2] for r in rows)} act codes differ, "
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


def _deploy_int8_forward(c):
    port = from_jax_variables(_np(c["int8"]), CFG, QC, device="cpu")
    ref, out, flips = _against_jax(c["model"], c["int8"], port, c["x"],
                                   c["t"], jexport.DEPLOY_INT8, DEPLOY_INT8)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert flips == 0
    _flip_gate(out, ref, 0.15)


def test_deploy_int8_forward(calibrated):
    """Batch 4: both packages serve attention with the fused kernel."""
    _deploy_int8_forward(calibrated)


def test_deploy_int8_forward_einsum(calibrated, einsum_attention):
    """``EDM_FUSED_ATTN=0`` at batch 4 (batch·heads < 128): both packages
    serve the four attention blocks with K2 → K3 → K2 and none with K4
    (the port runs twice: forced on JAX's inputs, then free)."""
    _deploy_int8_forward(calibrated)
    assert einsum_attention() == {("jax", "fused_attention"): 0,
                                  ("jax", "softmax_codes"): 4,
                                  ("port", "fused_attention"): 0,
                                  ("port", "softmax_codes"): 8}


@pytest.mark.parametrize("switches,calls", [
    # the einsum branch with a float32 softmax quantized outside a kernel
    ({"EDM_FUSED_ATTN": "0", "EDM_FUSED_SOFTMAX": "0"}, (0, 0, 0, 0)),
    # the attention products on the fake-quant branch
    ({"EDM_INT8_ATTN": "0"}, (0, 0, 0, 0)),
    # every conv and dense on the folded numerics; attention stays int8 (K4)
    ({"EDM_INT8_CONV": "0"}, (4, 0, 8, 0)),
], ids=["fused_softmax_off", "int8_attn_off", "int8_conv_off"])
def test_deploy_int8_forward_switch(calibrated, branch_spy, monkeypatch, switches,
                                    calls):
    """DEPLOY_INT8 of the int8 export under one of JAX's serving switches,
    set once for both packages: each package calls the same kernels, and
    the port's output is held to JAX's as DEPLOY is
    (:func:`test_deploy_forward`: module by module on JAX's input, the
    flip-aware gate, the mean drift no larger than JAX's own DEPLOY vs
    DEPLOY_INT8 drift), since with the folded convs a code may flip on a
    tie of two float summation orders."""
    for name, value in switches.items():
        monkeypatch.setenv(name, value)
    c = calibrated
    port = from_jax_variables(_np(c["int8"]), CFG, QC, device="cpu")
    seen = {"port": 0}
    for name in ("int8_conv", "int8_dense"):
        _count_calls(monkeypatch, tlayers, name, seen, "port")
    ref, out, flips = _against_jax(c["model"], c["int8"], port, c["x"], c["t"],
                                   jexport.DEPLOY_INT8, DEPLOY_INT8)
    got = branch_spy()
    assert (got[("jax", "fused_attention")], got[("jax", "softmax_codes")],
            got[("port", "fused_attention")], got[("port", "softmax_codes")]) == calls
    assert (seen["port"] == 0) == (switches.get("EDM_INT8_CONV") == "0"), seen
    assert out.shape == ref.shape and np.isfinite(out).all()
    _flip_gate(out, ref, 0.15, share=flips == 0)
    monkeypatch.delenv("EDM_INT8_CONV", raising=False)
    folded = np.asarray(c["model"].apply(
        jexport.export_serving(c["v"], JQC_, dtype=jnp.float32), c["x"], c["t"],
        jexport.DEPLOY))
    own = np.abs(np.asarray(c["model"].apply(c["int8"], c["x"], c["t"],
                                             jexport.DEPLOY_INT8)) - folded).mean()
    assert np.abs(out - ref).mean() <= max(own, 1e-6)


@pytest.mark.parametrize("which", ["resnet_block", "attn_block",
                                   "attn_block_einsum"])
def test_single_block_int8(calibrated, which, request):
    """One block on a shared input, int8 serving, exported state; the
    attention block on its default (fused) branch and on the einsum one."""
    c = calibrated
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 8, 8, 32 if which == "resnet_block" else 64)
                            ).astype(np.float32)
    sub = "block_0" if which == "resnet_block" else "attn_0"
    if which == "attn_block_einsum":
        request.getfixturevalue("einsum_attention")
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


def _count_calls(monkeypatch, module, name, seen, side):
    """Wrap ``module.name`` so that each call adds one to ``seen[side]``."""
    fn = getattr(module, name)

    def spy(*a, **k):
        seen[side] += 1
        return fn(*a, **k)
    monkeypatch.setattr(module, name, spy)


@pytest.fixture
def k6_spy(monkeypatch):
    """Counts of the fused GroupNorm calls in each package, and the gate
    decisions (shape, fused?) in call order."""
    seen = {"jax": 0, "port": 0, "jax_gate": [], "port_gate": []}

    def gate(module, side):
        fn = module.use_fused_gn

        def spy(*shape):
            seen[side].append((shape, fn(*shape)))
            return seen[side][-1][1]
        monkeypatch.setattr(module, "use_fused_gn", spy)
    for module, name in ((jgn, "gn_swish_int8"), (jddpm, "gn_norm"),
                         (jldm, "gn_norm")):
        _count_calls(monkeypatch, module, name, seen, "jax")
    for module, name in ((tlayers, "gn_swish_int8"), (tlayers, "gn_norm"),
                         (tldm, "gn_norm")):
        _count_calls(monkeypatch, module, name, seen, "port")
    for module in (jddpm, jldm):
        gate(module, "jax_gate")
    for module in (tlayers, tldm):
        gate(module, "port_gate")
    monkeypatch.setenv("EDM_FUSED_GN", "1")
    return seen


@pytest.fixture
def k7_spy(monkeypatch):
    """Counts of the fused fake-quant matmul calls in each package."""
    seen = {"jax": 0, "port": 0}
    _count_calls(monkeypatch, jpq, "fakequant_matmul", seen, "jax")
    _count_calls(monkeypatch, tlayers, "fakequant_matmul", seen, "port")
    return seen




def test_tiny_ddpm_fused_gn_matches_jax(calibrated, k6_spy, monkeypatch):
    """Every GroupNorm of the tiny DDPM in both packages through K6: two
    per ResnetBlock (into conv1 and conv2), one per attention block and
    ``norm_out``.  Each module on JAX's input as in ``_against_jax``,
    where a code computed inside K6 may flip on a tie (on some hosts one
    does, at ``up.0.block.1.conv2``).  Where no act code differs, the
    output within rtol = atol = 2e-5 of JAX's, element by element.  Where
    codes flip, the flip-aware gate, and the mean drift to the nearer of
    JAX's fused and unfused runs no larger than the drift between those
    two: with no flip, both drifts are float32 rounding noise, and that
    comparison says nothing."""
    monkeypatch.setenv("EDM_FUSED_GN_NARROW", "1")
    c = calibrated
    port = from_jax_variables(_np(c["int8"]), CFG, QC, device="cpu")
    ref, out, flips = _against_jax(c["model"], c["int8"], port, c["x"],
                                   c["t"], jexport.DEPLOY_INT8, DEPLOY_INT8,
                                   gn_code_flips=True)
    sites = sum(isinstance(m, GNorm) for m in port.modules())
    assert sites == 2 * 8 + 4 + 1           # 8 ResnetBlocks, 4 attention blocks
    assert k6_spy["jax"] == sites and k6_spy["port"] == 2 * sites, k6_spy
    assert k6_spy["port_gate"] == 2 * k6_spy["jax_gate"]
    assert len(k6_spy["jax_gate"]) == sites
    assert all(fused for _, fused in k6_spy["jax_gate"])
    assert out.shape == ref.shape and np.isfinite(out).all()
    _flip_gate(out, ref, 0.15, share=flips == 0)
    if flips == 0:
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
        return
    # JAX computes the same function unfused too; a flip lands the port
    # next to that run, so its drift to the nearer of JAX's two runs is
    # held to the drift between them
    monkeypatch.setenv("EDM_FUSED_GN", "0")
    unfused = np.asarray(c["model"].apply(c["int8"], c["x"], c["t"],
                                          jexport.DEPLOY_INT8))
    own, near = np.abs(unfused - ref).mean(), np.abs(out - unfused).mean()
    print(f"  JAX fused vs unfused: mean {own:.3g}; port vs JAX unfused: {near:.3g}")
    assert min(np.abs(out - ref).mean(), near) <= own


def test_deploy_fused_forward(calibrated, k7_spy):
    """DEPLOY_FUSED on the folded tree: every 1×1 conv (the split
    shortcuts with their two channel ranges) and dense through the fused
    fake-quant matmul, K7's plain version here and JAX's Pallas kernel in
    interpret mode; the 3×3 convs and attention as in DEPLOY.  Held as
    DEPLOY is (:func:`test_deploy_forward`): module by module on JAX's
    input, the flip-aware gate, and the mean drift no larger than JAX's
    own DEPLOY_INT8-vs-DEPLOY_FUSED drift."""
    c = calibrated
    tree = jexport.export_serving(c["v"], JQC_, dtype=jnp.float32)
    port = from_jax_variables(_np(tree), CFG, QC, device="cpu")
    ref, out, flips = _against_jax(c["model"], tree, port, c["x"], c["t"],
                                   jexport.DEPLOY_FUSED, DEPLOY_FUSED)
    sites = sum(isinstance(m, QDense) or (isinstance(m, QConv)
                                          and m.kernel_size == (1, 1))
                for m in port.modules())
    assert sites == 16 + 5 + 10      # attention 1×1s, shortcuts, denses
    assert k7_spy["jax"] == sites and k7_spy["port"] == 2 * sites, k7_spy
    _flip_gate(out, ref, 0.15, share=flips == 0)
    jax_int8 = np.asarray(c["model"].apply(c["int8"], c["x"], c["t"],
                                           jexport.DEPLOY_INT8))
    assert np.abs(out - ref).mean() <= np.abs(jax_int8 - ref).mean()


def test_ddim_sampling_int8(calibrated):
    """Four DDIM steps at eta=0 through DEPLOY_INT8.  Step by step on JAX's
    own x_t: the forward is held as in :func:`_against_jax` (on some hosts
    a code flips at a tie at t = 35 and spreads) and the DDIM update on
    JAX's (x_t, ε) within 2e-5.  Run freely: the flip-aware median / max
    bounds, with the share bound only where no act code of the free run
    differs from JAX's (the port's codes on its own x_t against JAX's on
    JAX's x_t, step by step: the two x_t part once any code on a tie flips
    along the way, also between JAX's jitted trajectory and the eager
    forwards held above, so codes may differ there though none does on
    JAX's x_t), and the mean drift no larger than JAX's own
    folded-vs-int8 drift on the same trajectory."""
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
    for k, (i, j) in enumerate(zip(seq[::-1], seq_next[::-1])):
        xk = np.array(steps["x"][k])
        assert int(steps["t"][k]) == i
        t = np.full((xk.shape[0],), i, np.float32)
        eps, eps_port, flips = _against_jax(model, c["int8"], port, xk, t,
                                            jexport.DEPLOY_INT8, DEPLOY_INT8, jit=True)
        _flip_gate(eps_port, eps, 0.15, share=flips == 0)
        nxt, _ = jddim.ddim_denoise_step(jnp.asarray(xk), jnp.asarray(eps),
                                         ja[i + 1], ja[j + 1], 0.0, 0.0)
        nxt_port, _ = ddim_denoise_step(
            torch.from_numpy(xk), torch.from_numpy(np.array(eps)), pa[i + 1],
            pa[j + 1], 0.0, None)
        np.testing.assert_allclose(nxt_port.numpy(), np.asarray(nxt),
                                   rtol=2e-5, atol=2e-5)
    free = []

    def port_eps(xx, tt):
        with tap(port, ActQuantizer) as rec:
            eps = port(xx, tt, DEPLOY_INT8)
        free.append(rec)
        return eps

    out = generalized_steps(torch.from_numpy(x), seq, port_eps, betas,
                            eta=0.0, device="cpu").numpy()
    assert np.isfinite(out).all() and len(free) == len(seq)
    free_flips = 0
    for k, rec in enumerate(free):
        xk = np.array(steps["x"][k])
        t = np.full((xk.shape[0],), int(steps["t"][k]), np.float32)
        _, jrec = _jax_tapped(model, c["int8"], (xk, t), jexport.DEPLOY_INT8, jit=True)
        rows = act_code_flips(port, rec, jrec)
        n = sum(r[2] for r in rows)
        free_flips += n
        print(f"\n  free run, t={int(steps['t'][k])}: {n} act codes differ, the "
              f"first in {next((r for r in rows if r[2]), None)}")
    d, dj = np.abs(out - ref), np.abs(folded - ref)
    print(f"  free run: {free_flips} act codes differ; median {np.median(d):.3g} "
          f"max {d.max():.3g} mean {d.mean():.3g} share<2e-4 "
          f"{(d < 2e-4).mean():.4f}; JAX folded vs int8: mean {dj.mean():.3g}")
    _flip_gate(out, ref, 0.3, share=free_flips == 0)
    assert d.mean() <= dj.mean()
