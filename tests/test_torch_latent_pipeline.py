"""The latent slice as a whole: ``LDMPipeline.run`` in the port against the
JAX package's, on the CPU (``jax_default_matmul_precision`` highest).

Two tiny runs, each on a UNet the port builds from seed 0 (carried to JAX
by ``models/bridge.py``, the KL first stage with it), the unconditional
one here and the guided one in ``tests/test_torch_latent_pipeline_cfg.py``
(which imports these tests and :func:`run_both`, so that the two runs go
to two test workers):

* unconditional, church-like (8×8×4 latents, scale-shift norm, resampling
  res blocks, attention at the 4×4 level): the church task's recipe at
  eta 1 (so that TDAC and sampling draw noise), 5 DDIM steps over a
  50-step schedule, 12 TDAC samples from two trajectory batches of 6 (the
  second batch gives its slice of the selected latents), 3 reconstruction
  iterations a target over the whole ``ldm_recon_plan`` in groups of 4
  (JAX's vmapped groups against the port's member-by-member loops) in the
  deterministic setting (minibatch = the 12 rows, ``input_prob=1``, QDrop
  probability 1), ``serve='int8'``, 2 images;
* classifier-free guidance, SD-like (a spatial transformer over a 6 × 24
  text context; 8 prompt rows and 8 empty-prompt rows made with numpy),
  the coco recipe: PLMS with its look-ahead, scale 7.5, 8 TDAC samples
  from two trajectory batches of 4 (each batch its own context rows), the
  doubled calibration rows [x; x], [t; t], [uncond; cond], scale init,
  ``serve='int8'`` on the calibrated state, 2 images.  Its reconstruction
  is left out here (``recon=False``): each JAX compile of a target's loop
  costs seconds, and ``tests/test_torch_ldm_calib.py`` holds the
  transformer block's loop with its context.

The port is handed JAX's draws (TDAC's x_T, per-step noise and
permutation; each sampling batch's x_T and noise).  JAX's reconstruction
runs with ``shared_capture`` (one capture program for the whole plan:
the same captured values, fewer XLA compiles).

* TDAC and the calibration rows: the selection equal (counts, time codes,
  model times), the latents within 1e-5, and under guidance the doubled
  rows' layout equal to JAX's.
* The final quant state, leaf by leaf: hard masks agree on > 98 %; act
  deltas within rel 5 %, at least half of them within rel 1e-3.  The
  calibration runs free: where an act code on a float tie flips upstream
  (the TDAC latents agree to 1e-5, not bitwise), a later range search on
  its flat score may move a few steps of its 100-candidate grid (the
  church run's farthest delta 1.9 %, the coco run's 3.0 %, about half
  within 1e-3; the recipes' lr_a of 1e-4 moves a delta far less in 3
  iterations).  ``tests/test_torch_ldm_calib.py`` holds CALIB_A with each
  quantizer on JAX's input, and the loops on one capture.
* The serving path alone, step by step: JAX's sampler over the port's
  final state (its int8 export on a float32 carrier, where the two
  packages round alike; the bf16 carrier's roundings between modules are
  held in ``tests/test_torch_sd.py``) records each step's x_t and the
  UNet's output (on the doubled rows under guidance); the port's output on
  each recorded x_t passes the flip-aware gate of ``tests/test_torch_ddpm.py``
  (median < 2e-4, max < 0.3), and its guided ε is JAX's combination of
  those halves.  Run free, a code that flips on a tie spreads, and under
  guidance at 7.5 it is multiplied at every step (one flipped code at the
  coco run's second step moves a guided ε by 0.49): so the runs' images
  (bf16 carrier) are held
  finite, in [0, 1], and against JAX's run by the mean drift, at most 1.5×
  the drift of JAX's own images between its state and the port's.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.models import latent_diffusion as jld
from eda_dm_tpu.models import ldm_unet as jldm
from eda_dm_tpu.models import vae as jvae
from eda_dm_tpu.pipelines import latent as jlatent
from eda_dm_tpu.quant import config as jconf
from eda_dm_tpu.quant import export as jexport
from eda_dm_tpu.samplers import latent as jlat
from eda_dm_tpu_torch.models import latent_diffusion as tld
from eda_dm_tpu_torch.models import ldm_unet as tldm
from eda_dm_tpu_torch.models import vae as tvae
from eda_dm_tpu_torch.models.bridge import to_jax_variables
from eda_dm_tpu_torch.pipelines import latent as tlatent
from eda_dm_tpu_torch.quant import config as tconf
from eda_dm_tpu_torch.quant.export import export_serving_int8
from test_torch_ddpm import _flip_gate

BASE = dict(image_size=8, in_channels=4, out_channels=4, model_channels=32,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2))
UNET = {"church": dict(BASE, num_heads=2, use_scale_shift_norm=True,
                       resblock_updown=True),
        "coco": dict(BASE, num_heads=4, use_spatial_transformer=True, context_dim=24,
                     legacy=False),
        "imagenet": dict(BASE, num_heads=1, use_spatial_transformer=True,
                         context_dim=24)}
KL = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
          in_channels=3, resolution=16, z_channels=4, double_z=True, embed_dim=4,
          n_embed=None)
SCHED = {"church": dict(timesteps=50),
         "coco": dict(timesteps=50, linear_start=0.00085, linear_end=0.0120,
                      scale_factor=0.18215, cond="text"),
         "imagenet": dict(timesteps=50, cond="class", n_classes=1001, class_embed_dim=24)}
KNOBS = {"church": dict(custom_steps=5, eta=1.0, calib_num_samples=12, batch_samples=6,
                        iters=3, recon_batch_size=12, input_prob=1.0, n_samples=2,
                        batch_size=2),
         "coco": dict(custom_steps=5, calib_num_samples=8, batch_samples=4, recon=False,
                      n_samples=2, batch_size=2),
         "imagenet": dict(custom_steps=5, calib_num_samples=8, batch_samples=4,
                          recon=False, n_samples=2, batch_size=2)}
PROMPTS, CTX_LEN = 8, 6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ddim_noise(key, shape, steps):
    """The per-step noise of JAX's ``ldm_ddim_sample`` scan."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(_t(jax.random.normal(sub, shape, jnp.float32)))
    return out


def _draws(task, jpipe):
    """JAX's draws in ``run``, as it splits its keys."""
    cfg, res = jpipe.cfg, jpipe.mc.unet.image_size
    shape = lambda n: (n, res, res, jpipe.mc.unet.in_channels)
    noisy = cfg.eta != 0.0 and cfg.sampler == "ddim"
    _, k_tdac, _ = jax.random.split(jpipe.root_key, 3)
    key, k_sel = jax.random.split(k_tdac)
    n_batches = cfg.calib_num_samples // cfg.batch_samples
    keys = jax.random.split(key, 2 * n_batches).reshape(n_batches, 2, -1)
    draws = {"tdac_x_T": [_t(jax.random.normal(keys[r, 0], shape(cfg.batch_samples)))
                          for r in range(n_batches)],
             "tdac_perm": np.asarray(jax.random.permutation(k_sel, cfg.calib_num_samples))}
    if noisy:
        draws["tdac_noise"] = [_ddim_noise(keys[r, 1], shape(cfg.batch_samples),
                                           cfg.custom_steps) for r in range(n_batches)]
    key, x_T, noise = jax.random.PRNGKey(cfg.seed), [], []
    for _ in range(cfg.n_samples // cfg.batch_size):
        key, sub = jax.random.split(key)
        k_noise, k_samp = jax.random.split(sub)
        x_T.append(_t(jax.random.normal(k_noise, shape(cfg.batch_size))))
        noise.append(_ddim_noise(k_samp, shape(cfg.batch_size), cfg.custom_steps)
                     if noisy else None)
    draws.update(sample_x_T=x_T, sample_noise=noise)
    return draws


def _record(pipe, name, store):
    """Keep what ``pipe.<name>`` returns in ``store``."""
    fn = getattr(pipe, name)

    def kept(*a, **k):
        store[name] = fn(*a, **k)
        return store[name]
    setattr(pipe, name, kept)


def run_both(task):
    """JAX's and the port's ``run`` of ``task`` on one initial state."""
    mc_kw = dict(SCHED[task])
    tpipe = tlatent.LDMPipeline(
        tlatent.task_config(task, **KNOBS[task]),
        tld.LatentDiffusionConfig(unet=tldm.LDMUNetConfig(**UNET[task]),
                                  vae=tvae.VAEConfig(**KL), **mc_kw), device="cpu")
    tpipe.qc = tconf.QuantConfig(prob=1.0)           # QDrop keeps every value
    tpipe.ld = tld.LatentDiffusion(tpipe.mc, tpipe.qc, device="cpu", seed=0)
    v0 = {"unet": to_jax_variables(tpipe.ld.unet),
          "first_stage": to_jax_variables(tpipe.ld.first_stage)}
    if tpipe.mc.cond == "class":
        v0["cond_stage"] = to_jax_variables(tpipe.ld.cond_stage)
    jpipe = jlatent.LDMPipeline(
        jlatent.task_config(task, **KNOBS[task]),
        model_cfg=jld.LatentDiffusionConfig(unet=jldm.LDMUNetConfig(**UNET[task]),
                                            vae=jvae.VAEConfig(**KL), **mc_kw))
    jpipe.qc = jconf.QuantConfig(prob=1.0)
    jpipe.ld = jld.LatentDiffusion(jpipe.mc, jpipe.qc)
    ctx = unc = None
    if task == "coco":
        rng = np.random.default_rng(3)
        ctx, unc = (rng.standard_normal((PROMPTS, CTX_LEN, 24)).astype(np.float32)
                    for _ in range(2))
    elif task == "imagenet":
        # each package's embedder on the helper's labels: one token a row
        labels, uncond = tlatent.imagenet_labels(PROMPTS, jpipe.cfg.seed)
        ctx, unc = (tpipe.ld.get_learned_conditioning(a).numpy() for a in (labels, uncond))
        for a, b in ((labels, ctx), (uncond, unc)):
            np.testing.assert_array_equal(np.asarray(jpipe.ld.get_learned_conditioning(
                v0["cond_stage"], a)), b)
    jkeep, tkeep = {}, {}
    for pipe, store in ((jpipe, jkeep), (tpipe, tkeep)):
        for name in ("tdac_calibration", "build_cali_data"):
            _record(pipe, name, store)
    args = jlatent.ReconArgs
    jlatent.ReconArgs = functools.partial(args, shared_capture=True)
    try:
        jv, jimgs = jpipe.run(variables=v0, serve="int8",
                              context=None if ctx is None else jnp.asarray(ctx),
                              uncond=None if unc is None else jnp.asarray(unc))
    finally:
        jlatent.ReconArgs = args
    unet, timgs = tpipe.run(serve="int8", draws=_draws(task, jpipe),
                            context=None if ctx is None else torch.from_numpy(ctx),
                            uncond=None if unc is None else torch.from_numpy(unc))
    return dict(task=task, jpipe=jpipe, tpipe=tpipe, v0=v0, jv=jv,
                jimgs=np.asarray(jimgs), timgs=timgs, unet=unet, jkeep=jkeep,
                tkeep=tkeep, ctx=ctx, unc=unc)


@pytest.fixture(scope="module", params=["church"])
def runs(request):
    return run_both(request.param)


def test_tdac_and_calibration_rows_match_jax(runs):
    tsel, jsel = runs["tkeep"]["tdac_calibration"], runs["jkeep"]["tdac_calibration"]
    np.testing.assert_array_equal(tsel.t_num, jsel.t_num)
    np.testing.assert_array_equal(tsel.time_codes, jsel.time_codes)
    np.testing.assert_array_equal(tsel.calib_t.numpy(), np.asarray(jsel.calib_t))
    np.testing.assert_allclose(tsel.calib_x.numpy(), np.asarray(jsel.calib_x),
                               rtol=1e-5, atol=1e-5)
    cfg = runs["tpipe"].cfg
    assert tsel.calib_x.shape[0] == cfg.calib_num_samples
    tcali, jcali = runs["tkeep"]["build_cali_data"], runs["jkeep"]["build_cali_data"]
    assert len(tcali) == len(jcali) == (2 if runs["ctx"] is None else 3)
    for a, b in zip(tcali, jcali):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    if runs["ctx"] is not None:                  # [uncond; cond] on doubled rows
        n = cfg.calib_num_samples
        np.testing.assert_array_equal(tcali[2].numpy(),
                                      np.concatenate([runs["unc"][:n], runs["ctx"][:n]]))
        assert torch.equal(tcali[0][:n], tcali[0][n:])


def test_final_state_matches_jax(runs):
    got = to_jax_variables(runs["unet"])["quant"]
    want = _np(runs["jv"]["unet"]["quant"])
    lr_a = runs["tpipe"].cfg.lr_a
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
    far = max(rels)
    close = sum(r <= 1e-3 for r, _, _ in rels)
    print(f"\n  {runs['task']}: hard masks agree on {same / total:.5f} of {total}; act "
          f"deltas within rel 1e-3 at {close} of {len(rels)}, the farthest rel "
          f"{far[0]:.3g} ({far[1] / lr_a:.2f} steps of lr_a) at {far[2]}")
    assert same > 0.98 * total
    assert far[0] <= 0.05 and close >= 0.5 * len(rels), far


def test_serving_steps_match_jax(runs):
    """The port's UNet output (DEPLOY_INT8, its final state exported on a
    float32 carrier) on each x_t of JAX's trajectory over the same state,
    the first sampling batch's draws."""
    jpipe, tpipe = runs["jpipe"], runs["tpipe"]
    state = {"params": _np(runs["jv"]["unet"]["params"]),
             "quant": to_jax_variables(runs["unet"])["quant"]}
    jtree = jexport.export_serving_int8(state, jpipe.qc, dtype=jnp.float32)
    port = export_serving_int8(copy.deepcopy(runs["unet"]), tpipe.qc, torch.float32)
    draws = _draws(runs["task"], jpipe)
    scale = jpipe.cfg.scale if jpipe.is_conditional else 1.0
    ctx = unc = None
    if runs["ctx"] is not None:
        ctx, unc = runs["ctx"][:2], runs["unc"][:2]
    def rows(xp, x, t):
        """The UNet's rows: (x, t) alone, or doubled with [uncond; cond]."""
        if ctx is None:
            return (x, t, None)
        cat = (lambda a: jnp.concatenate(a)) if xp is jnp else torch.cat
        return (cat([x, x]), cat([t, t]),
                cat([xp.asarray(unc), xp.asarray(ctx)]) if xp is jnp
                else torch.from_numpy(np.concatenate([unc, ctx])))

    def guided(e):
        e_u, e_c = (jnp.split(e, 2) if isinstance(e, jax.Array) else e.chunk(2))
        return e_u + scale * (e_c - e_u)

    def jstep(x, t):
        out = jpipe.ld.apply_model(jtree, *rows(jnp, x, t)[:2],
                                   context=rows(jnp, x, t)[2], mode=jexport.DEPLOY_INT8)
        return (out if ctx is None else guided(out)), out
    key = jax.random.split(jax.random.split(jax.random.PRNGKey(jpipe.cfg.seed))[1])[1]
    sampler = getattr(jlat, f"ldm_{jpipe.cfg.sampler}_sample")
    _, rec = jax.jit(lambda x: sampler(x, jpipe.sched, jstep, key=key, record_xt=True,
                                       model_returns_aux=True))(
        jnp.asarray(draws["sample_x_T"][0].numpy()))
    for k in range(len(rec["t"])):
        x, t = torch.from_numpy(np.array(rec["x"][k])), torch.full((2,), float(rec["t"][k]))
        xx, tt, cc = rows(torch, x, t)
        with torch.no_grad():
            out = port(xx, tt, context=cc, mode=tconf.DEPLOY_INT8)
        ref = np.asarray(rec["aux"][k])
        d = np.abs(out.numpy() - ref)
        print(f"\n  {runs['task']} step {k} (t={int(rec['t'][k])}): median "
              f"{np.median(d):.3g} max {d.max():.3g}")
        _flip_gate(out.numpy(), ref, 0.3, share=False)
        if ctx is not None:              # the port's guidance on JAX's halves
            np.testing.assert_allclose(guided(torch.from_numpy(ref)).numpy(),
                                       np.asarray(guided(jnp.asarray(ref))),
                                       rtol=1e-6, atol=1e-6)


def test_images_match_jax(runs):
    """The runs' DEPLOY_INT8 images (bf16 carrier): against JAX's run by the
    mean drift, beside JAX's own images of the port's final state."""
    jpipe, timgs = runs["jpipe"], runs["timgs"]
    assert timgs.shape == (2, 16, 16, 3) and np.isfinite(timgs).all()
    assert timgs.min() >= 0.0 and timgs.max() <= 1.0
    state = {"params": _np(runs["jv"]["unet"]["params"]),
             "quant": to_jax_variables(runs["unet"])["quant"]}
    serving, mode = jpipe.serving_variables({**runs["v0"], "unet": state}, "int8")
    ctx_fn = jpipe.make_context_fn(runs["ctx"], runs["unc"])
    same_state = np.asarray(jpipe.sample_fid(serving, mode=mode, context_fn=ctx_fn))
    d = np.abs(timgs - same_state)
    print(f"\n  {runs['task']}: port vs JAX on the port's state: median "
          f"{np.median(d):.3g} max {d.max():.3g} mean {d.mean():.3g}")
    own = np.abs(runs["jimgs"] - same_state).mean()
    drift = np.abs(timgs - runs["jimgs"]).mean()
    print(f"  port vs JAX's run: mean {drift:.3g}; JAX's states' drift {own:.3g}")
    assert drift <= 1.5 * own


@pytest.mark.parametrize("task", ["bedroom", "church", "imagenet", "coco"])
def test_task_recipes_match_jax(task):
    """``TASK_DEFAULTS`` and every ``LDMTaskConfig`` field of the task equal
    JAX's (which ``tests/test_task_recipes.py`` pins to the reference
    scripts), but for the XLA-only ``recon_clear_caches_every``; the model
    config is JAX's; the task's pipeline constructs with the DPM-Solver
    sampler (on a tiny model of the task's conditioning)."""
    import dataclasses
    assert tlatent.TASK_DEFAULTS[task] == jlatent.TASK_DEFAULTS[task]
    want = dataclasses.asdict(jlatent.task_config(task))
    assert want.pop("recon_clear_caches_every") == 6
    assert dataclasses.asdict(tlatent.task_config(task)) == want
    unet = dataclasses.asdict(jlatent.MODEL_CONFIGS[task]().unet)
    unet.pop("conv_resample")
    assert dataclasses.asdict(tlatent.MODEL_CONFIGS[task]().unet) == unet
    tiny = task if task in UNET else "church"
    pipe = tlatent.LDMPipeline(
        tlatent.task_config(task, sampler="dpm", custom_steps=5),
        tld.LatentDiffusionConfig(unet=tldm.LDMUNetConfig(**UNET[tiny]),
                                  vae=tvae.VAEConfig(**KL), **SCHED[tiny]), device="cpu")
    assert pipe.cfg.sampler == "dpm" and pipe.is_conditional == (task in ("imagenet", "coco"))
