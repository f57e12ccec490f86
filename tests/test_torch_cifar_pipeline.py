"""The slice as a whole: ``CifarPipeline.run`` in the port against the JAX
package's, on the CPU (tiny DDPM; ``jax_default_matmul_precision``
highest).

Tiny knobs: 8 DDIM timesteps over a 100-step schedule, 8 TDAC samples of a
batch of 8, 5 reconstruction iterations a target in the deterministic
setting (minibatch = the 8 rows, ``input_prob=1``, QDrop probability 1),
groups of 4 (JAX's vmapped groups against the port's member-by-member
loops), ``serve='int8'``, 4 images.  The port starts from JAX's
``init_variables`` through the bridge and is handed JAX's draws: TDAC's
x_T and permutation and the sampling batch's x_T.

* TDAC: the calibration set equal (the FP trajectory within 1e-5).
* The final quant state, leaf by leaf: hard masks agree on > 98 %; act
  deltas within rel 1e-3 or within three Adam steps (3·lr_a = 1.5e-3) of
  JAX's.  An Adam step moves a delta by up to lr_a whatever the size of
  its gradient, and a gradient near 0 takes its sign from float noise, so
  after 5 steps a small delta (the softmax quantizers' are about 3e-3)
  may sit a step or two from JAX's; and the free-running calibration's
  prefix drifts where an act code on a float tie flips
  (``tests/test_torch_calib.py`` holds each quantizer on JAX's own
  input).
* The images: the port's DEPLOY_INT8 images against JAX's DEPLOY_INT8
  images of the port's own final state (the serving path alone) through
  the flip-aware gate of ``tests/test_torch_ddpm.py`` (max < 0.3 after
  sampling; the share bound only where nothing flips); and against JAX's
  run, the mean drift at most 1.5× the drift of JAX's own images between
  its state and the port's (the two states' rounding differs on about 1 %
  of the weights, and that difference dominates).
"""

import jax
import numpy as np
import pytest
import torch

from eda_dm_tpu.models.ddpm_unet import DDPMConfig as JCfg, DDPMUNet as JUNet
from eda_dm_tpu.pipelines import cifar as jcifar
from eda_dm_tpu.quant import QuantConfig as JQC
from eda_dm_tpu_torch.calib.recon import ReconArgs
from eda_dm_tpu_torch.models.bridge import from_jax_variables, to_jax_variables
from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig
from eda_dm_tpu_torch.pipelines import cifar as tcifar
from eda_dm_tpu_torch.quant import QuantConfig
from test_torch_ddpm import _flip_gate

TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=16)
KNOBS = dict(image_size=16, timesteps=8, num_diffusion_timesteps=100, batch_samples=8,
             calib_num_samples=8, iters=5, recon_batch_size=8, input_prob=1.0,
             max_images=4, sample_batch_size=4)
LR_A = ReconArgs().lr_a


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs():
    jpipe = jcifar.CifarPipeline(jcifar.CifarConfig(arch=JCfg(**TINY), **KNOBS))
    jpipe.qc = JQC(weight_bit=4, act_bit=8, prob=1.0)       # QDrop keeps every value
    jpipe.model = JUNet(cfg=jpipe.cfg.arch, qc=jpipe.qc)
    v0 = jax.jit(jpipe.init_variables)()
    sets = {}
    jtdac = jpipe.tdac_calibration        # JAX's TDAC set, kept from its run
    jpipe.tdac_calibration = lambda *a: sets.setdefault("jax", jtdac(*a))
    jv, jimgs = jpipe.run(variables=v0, serve="int8")
    # JAX's draws, as its run made them
    _, k_tdac, _ = jax.random.split(jpipe.root_key, 3)
    _, k_noise, k_sel, _ = jax.random.split(k_tdac, 4)
    cfg = jpipe.cfg
    x_T = jax.random.normal(k_noise, (cfg.batch_samples, 16, 16, 3))
    _, sub = jax.random.split(jax.random.PRNGKey(cfg.seed))
    sample_x_T = jax.random.normal(jax.random.split(sub)[0], (4, 16, 16, 3))
    draws = {"tdac_x_T": torch.from_numpy(np.array(x_T)),
             "tdac_perm": np.asarray(jax.random.permutation(k_sel, cfg.calib_num_samples)),
             "sample_x_T": [torch.from_numpy(np.array(sample_x_T))]}
    tpipe = tcifar.CifarPipeline(tcifar.CifarConfig(arch=DDPMConfig(**TINY), **KNOBS),
                                 device="cpu")
    tpipe.qc = QuantConfig(weight_bit=4, act_bit=8, prob=1.0)
    model = from_jax_variables(_np(v0), tpipe.cfg.arch, tpipe.qc, device="cpu")
    tdac = tpipe.tdac_calibration
    tpipe.tdac_calibration = lambda *a: sets.setdefault("port", tdac(*a))
    model, timgs = tpipe.run(model=model, serve="int8", draws=draws)
    return dict(jpipe=jpipe, jv=jv, jimgs=np.asarray(jimgs), model=model,
                timgs=timgs, sets=sets, draws=draws)


def test_tdac_set_matches_jax(runs):
    (tx, tt, tsel), (jx, jt, jsel) = runs["sets"]["port"], runs["sets"]["jax"]
    np.testing.assert_array_equal(tsel.t_num, jsel.t_num)
    np.testing.assert_array_equal(tsel.time_codes, jsel.time_codes)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)


def test_final_state_matches_jax(runs):
    got = to_jax_variables(runs["model"])["quant"]
    want = _np(runs["jv"]["quant"])
    same = total = 0
    rels = []

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
                rels.append((d / abs(float(wv)), d, p))
    walk(got, want, "")
    print(f"\n  hard masks agree on {same / total:.5f} of {total}; act deltas within rel "
          f"1e-3 at {sum(r <= 1e-3 for r, _, _ in rels)} of {len(rels)}, the farthest "
          f"{max(d for _, d, _ in rels):.3g} ({max(d for _, d, _ in rels) / LR_A:.2f} "
          f"steps of lr_a)")
    assert same > 0.98 * total
    assert all(r <= 1e-3 or d <= 3 * LR_A for r, d, _ in rels), max(rels, key=lambda v: v[1])


def test_images_match_jax(runs):
    """DEPLOY_INT8 images: against JAX serving the port's own final state
    (the same x_T), then against JAX's run."""
    jpipe, timgs = runs["jpipe"], runs["timgs"]
    assert timgs.shape == (4, 16, 16, 3) and np.isfinite(timgs).all()
    tree = {"params": _np(runs["jv"]["params"]), "quant": to_jax_variables(runs["model"])["quant"]}
    serving, mode = jpipe.serving_variables(tree, "int8")
    # JAX's own sampler (compiled by its run) and draws, on the port's state
    same_state = np.asarray(jpipe.sample_fid(serving, mode=mode))
    d = np.abs(timgs - same_state)
    print(f"\n  port vs JAX on the port's state: median {np.median(d):.3g} max {d.max():.3g}"
          f" mean {d.mean():.3g} share<2e-4 {(d < 2e-4).mean():.4f}")
    _flip_gate(timgs, same_state, 0.3, share=False)
    own = np.abs(runs["jimgs"] - same_state).mean()
    drift = np.abs(timgs - runs["jimgs"]).mean()
    print(f"  port vs JAX's run: mean {drift:.3g}; JAX's states' drift {own:.3g}")
    assert drift <= 1.5 * own
