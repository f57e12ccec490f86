"""The port's AdaRound + FBR reconstruction against the JAX package, on the
CPU (tiny DDPM, ``jax_default_matmul_precision`` highest).

* The plans: ``ddpm_recon_plan`` and ``ddpm_layer_plan`` give JAX's
  names, paths, kinds, ``has_temb``, inner taps and ``act_only`` in JAX's
  order, and the module class each spec names; ``group_plan`` groups as
  JAX's does (window 0 and 1, the tiny and the full ``DDPMConfig()``).
* ``build_group_data`` (the captures): ``inp_s``, ``out_fp`` and every
  ``inner_fp`` within 1e-5 of JAX's; ``inp_q`` (the quantized prefix)
  within 1e-5 where no act code of the prefix differs from JAX's, else on
  at most 1 % of its elements, by at most 1 % of its largest value (a
  code on a float tie flips, and the step it takes moves what follows).
* The loops, on one capture (the port's, so that only the loop is compared), in
  the deterministic setting: minibatch = every row, ``input_prob=1``,
  QDrop probability 1 (so no draw matters).  10 iterations of a res block,
  an attention block, the layer plan's act-only attention target and a
  group of two attention blocks (JAX's vmapped ``reconstruct_group``):
  hard masks agree on > 98 %, act deltas within rel 1e-3 (or a quarter of
  one Adam step, 0.25·lr_a, where that is larger), each loss within 5e-3
  of JAX's relative to the largest loss of its curve.  Adam's first step
  moves every alpha by lr_w = 0.5 in the sign of its gradient, and where a
  gradient is near 0 that sign is float noise (the two packages sum in
  other orders): the curves part at the second step by up to 1.6e-3 of
  the peak and the deltas by up to 2.6e-3 rel (a fifth of a step), while
  the masks stay together (≥ 99.7 %).
* ``resumable_reconstruct`` interrupted after one group and resumed
  equals the uninterrupted run, buffer for buffer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.calib import recon as jrecon
from eda_dm_tpu.models import ddpm_unet as jddpm
from eda_dm_tpu.quant import config as jconf
from eda_dm_tpu.utils.tree import get_subtree
from eda_dm_tpu_torch.calib import recon as trecon
from eda_dm_tpu_torch.calib import scale_init as tsi
from eda_dm_tpu_torch.models import ddpm_unet as tddpm
from eda_dm_tpu_torch.models.bridge import from_jax_variables, to_jax_variables
from eda_dm_tpu_torch.quant import config as tconf
from eda_dm_tpu_torch.utils import checkpointing

TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=16)
ROWS = 8
# QDrop probability 1: every quantized value kept, no draw
JQC, TQC = jconf.QuantConfig(prob=1.0), tconf.QuantConfig(prob=1.0)
ITERS = 10
LR_A = trecon.ReconArgs().lr_a


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_data(data):
    """A port capture as JAX arrays (the loops are compared on one capture)."""
    return {k: (tuple(jnp.asarray(a.numpy()) for a in v) if isinstance(v, tuple)
                else jnp.asarray(v.numpy())) for k, v in data.items()}


@pytest.fixture(scope="module")
def calibrated():
    """A tiny model calibrated by the port (CALIB_W, CALIB_A), as a JAX
    tree through the bridge: both packages start from the same state."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((ROWS, 16, 16, 3)).astype(np.float32)
    t = rng.integers(0, 100, ROWS).astype(np.float32)
    tcali = (torch.from_numpy(x), torch.from_numpy(t))
    port = tddpm.DDPMUNet(tddpm.DDPMConfig(**TINY), TQC, device="cpu", seed=0)
    tsi.set_weight_quantize_params(port, tcali, device="cpu")
    tsi.set_act_quantize_params(port, tcali, device="cpu")
    return dict(model=jddpm.DDPMUNet(cfg=jddpm.DDPMConfig(**TINY), qc=JQC),
                v=to_jax_variables(port), cali=(jnp.asarray(x), jnp.asarray(t)),
                tcali=tcali)


def _port(c):
    return from_jax_variables(_np(c["v"]), tddpm.DDPMConfig(**TINY), TQC, device="cpu")


def _fields(t):
    return (t.name, t.path, t.kind, t.has_temb, t.has_ctx, t.inner_taps, t.act_only)


@pytest.mark.parametrize("which", ["ddpm_recon_plan", "ddpm_layer_plan"])
@pytest.mark.parametrize("size", ["tiny", "full"])
def test_plans_match_jax(which, size):
    kw = TINY if size == "tiny" else {}
    want = getattr(jddpm, which)(jddpm.DDPMConfig(**kw), jconf.QuantConfig())
    got = getattr(tddpm, which)(tddpm.DDPMConfig(**kw), tconf.QuantConfig())
    assert [_fields(t) for t in got] == [_fields(t) for t in want]
    assert [t.spec[0] for t in got] == [type(t.module).__name__ for t in want]
    if which == "ddpm_recon_plan":
        assert len(got) == (18 if size == "tiny" else 38)
        for window in (0, 1):
            for gs in (2, 4):
                names = lambda groups: [[t.name for t in g] for g in groups]
                assert (names(trecon.group_plan(got, gs, window))
                        == names(jrecon.group_plan(want, gs, window)))


def _target(name, layer=False):
    plan = (tddpm.ddpm_layer_plan if layer else tddpm.ddpm_recon_plan)(
        tddpm.DDPMConfig(**TINY), TQC)
    jplan = (jddpm.ddpm_layer_plan if layer else jddpm.ddpm_recon_plan)(
        jddpm.DDPMConfig(**TINY), JQC)
    return (next(t for t in plan if t.name == name),
            next(t for t in jplan if t.name == name))


@pytest.mark.parametrize("names", [("conv_in", "down_0.block_0"),
                                   ("down_1.attn_0", "up_1.block_1", "up_1.attn_1")])
def test_capture_matches_jax(calibrated, names):
    """One group's captures, all members taken in the same two passes."""
    c = calibrated
    port = _port(c)
    targets = [_target(n) for n in names]
    args = trecon.ReconArgs(capture_batch_size=3)          # chunks of 3, 3, 2
    got = trecon.build_group_data(port, c["tcali"], [t for t, _ in targets], args)
    want = jrecon.build_group_data(c["model"], c["v"], c["cali"], [j for _, j in targets],
                                   jrecon.ReconArgs(capture_batch_size=3))
    for (t, _), g, w in zip(targets, got, want):
        assert set(g) == {k for k, v in w.items() if v is not None}, t.name
        for k, wv in w.items():
            for a, b in zip(g[k] if isinstance(wv, tuple) else [g[k]],
                            wv if isinstance(wv, tuple) else [wv]):
                a, b = a.numpy(), np.asarray(b)
                assert a.shape == b.shape, (t.name, k)
                if k == "inp_q":
                    d = np.abs(a - b)
                    off = d > 1e-5 + 1e-5 * np.abs(b)
                    print(f"\n  {t.name} inp_q: {int(off.sum())} of {d.size} beyond "
                          f"1e-5, median {np.median(d):.3g}, max {d.max():.3g} of "
                          f"{np.abs(b).max():.3g}")
                    assert np.median(d) < 2e-4 and d.max() <= 0.02 * np.abs(b).max()
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                               err_msg=f"{t.name} {k}")


def _deterministic(**kw):
    return (jrecon.ReconArgs(iters=ITERS, batch_size=ROWS, input_prob=1.0, **kw),
            trecon.ReconArgs(iters=ITERS, batch_size=ROWS, input_prob=1.0, **kw))


def _compare_state(port, jv, target, tag):
    """The target's subtree: act deltas within rel 1e-3 or 0.25·lr_a;
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
                worst[0] = max(worst[0], d / abs(float(wv)))
                assert d <= max(1e-3 * abs(float(wv)), 0.25 * LR_A), f"{p}/delta {d:.3g}"
    walk(got, want, "")
    share = same / max(total, 1)
    print(f"\n  {tag}: hard masks agree on {share:.5f} of {total}, act deltas within "
          f"rel {worst[0]:.3g}")
    return share, total


def _losses_close(got, want):
    want = np.asarray(want)
    assert np.isfinite(got.numpy()).all() and got.shape == want.shape
    peak = float(np.abs(want).max())
    print(f"\n  losses within {np.abs(got.numpy() - want).max() / peak:.3g} of the peak")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-3 * peak)


def _recon_one(c, name, layer=False):
    port = _port(c)
    t, j = _target(name, layer)
    jargs, targs = _deterministic()
    data = trecon.build_target_data(port, c["tcali"], t, targs)
    jv, jl = jrecon.reconstruct_target(j, c["v"], _jax_data(data), jargs,
                                       jax.random.PRNGKey(1))
    tl = trecon.reconstruct_target(t, port, data, targs,
                                   torch.Generator().manual_seed(1))
    _losses_close(tl, jl)
    share, total = _compare_state(port, jv, t, name)
    assert total == 0 or share > 0.98
    return port, jv, t


@pytest.mark.parametrize("name", ["down_0.block_0", "down_1.attn_0"])
def test_target_loop_matches_jax(calibrated, name):
    port, jv, t = _recon_one(calibrated, name)
    before = to_jax_variables(_port(calibrated).get_submodule(
        ".".join(p.replace("_", ".") if p[-1].isdigit() else p for p in t.path)))
    after = to_jax_variables(t.module(port))
    # the loop moved the alphas (lr_w 0.5)
    moved = [k for k in ("conv1", "q") if k in after["quant"]]
    assert any(not np.array_equal(after["quant"][k]["w0_alpha"],
                                  before["quant"][k]["w0_alpha"]) for k in moved)


def test_act_only_attention_target_matches_jax(calibrated):
    """The layer plan's attention target: only the block's q/k/v/w deltas
    train (no alpha moves)."""
    port, jv, t = _recon_one(calibrated, "down_1.attn_0.acts", layer=True)
    before = to_jax_variables(t.module(_port(calibrated)))["quant"]
    after = to_jax_variables(t.module(port))["quant"]
    np.testing.assert_array_equal(after["q"]["w0_alpha"], before["q"]["w0_alpha"])
    assert after["act_quantizer_q"]["delta"] != before["act_quantizer_q"]["delta"]


def test_group_of_two_matches_jax(calibrated):
    """Two attention blocks captured together, then each reconstructed:
    JAX's vmapped group against the port's member-by-member loop."""
    c = calibrated
    port = _port(c)
    pairs = [_target(n) for n in ("up_1.attn_0", "up_1.attn_1")]
    jargs, targs = _deterministic()
    datas = trecon.build_group_data(port, c["tcali"], [t for t, _ in pairs], targs)
    jv, jls = jrecon.reconstruct_group([j for _, j in pairs], c["v"],
                                       [_jax_data(d) for d in datas], jargs,
                                       jax.random.PRNGKey(3))
    tls = trecon.reconstruct_group([t for t, _ in pairs], port, datas, targs,
                                   torch.Generator().manual_seed(3))
    for (t, _), tl, jl in zip(pairs, tls, jls):
        _losses_close(tl, jl)
        share, _ = _compare_state(port, jv, t, t.name)
        assert share > 0.98


def test_resumable_reconstruct_resumes(calibrated, tmp_path, monkeypatch):
    """Interrupted after its first group and resumed from the checkpoint
    (a fresh model, as after a restart), the run ends where an
    uninterrupted one does; random draws on (batch 4 of 8 rows, input
    mixing, QDrop 0.5)."""
    c = calibrated
    plan = tddpm.ddpm_recon_plan(tddpm.DDPMConfig(**TINY), TQC)[:5]
    args = trecon.ReconArgs(iters=3, batch_size=4)
    qc = tconf.QuantConfig()                       # QDrop at 0.5

    def fresh():
        return from_jax_variables(_np(c["v"]), tddpm.DDPMConfig(**TINY), qc, device="cpu")

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
    assert checkpointing.load_meta(str(tmp_path / "b" / "recon_state.pt"))["completed"] == 1
    resumed = checkpointing.resumable_reconstruct(fresh(), c["tcali"], plan, args,
                                                  str(tmp_path / "b"), seed=9,
                                                  group_size=4)
    a, b = dict(full.named_buffers()), dict(resumed.named_buffers())
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["conv_in.w0_alpha"], fresh().conv_in.w0_alpha)
