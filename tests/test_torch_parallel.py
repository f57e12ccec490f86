"""The port's data and tensor parallelism (``eda_dm_tpu_torch/parallel``)
on gloo ranks on the CPU, against the single-process path and the JAX
package's ``parallel/``.

The tiny DDPM of ``tests/test_tp_serving.py`` (``ch=32, ch_mult=(1, 2),
num_res_blocks=1, attn_resolutions=(8,), resolution=16``), its act range
search on 20 candidates (``short_search``, as ``test_torch_calib`` keeps
its exact 2-D searches short).  Each world is
spawned once (``parallel.launch.spawn``: one process a rank, a
``FileStore``, one thread each) and runs every case of its size; the
tests read the ranks' results.  The rank functions import no JAX (the
ranks import this module to find them); JAX runs in the test process, on
its 8 virtual CPU devices.

* ``tp_spec``: JAX's PartitionSpec on the cases of
  ``test_tp_serving.py``, as a tuple.
* ``dp_calibrate_acts`` at world 2 over 8 rows in batches of 4 and over
  5 rows (the tail padded by cyclic repetition, as
  ``test_indivisible_batches.py`` holds it): against JAX's
  ``dp_calibrate_acts`` on ``make_mesh(2)`` with every quantizer on JAX's
  own input rows of its shard (teacher forcing, ``parity.tap``), within
  ``test_torch_calib``'s CALIB_A tolerance (``one_side`` equal, Δ, zp and
  the running range within rel 1e-5); on the port's single-process
  ``set_act_quantize_params``'s inputs, bit-equal to its state (the
  statistics over the ranks are exact); free-running under the gate of
  the port's other free-running calibrations (a rank's layers sum in an
  order that depends on its row count); the padded run bit-equal to the
  explicitly pre-tiled one.
* The attention dispatch follows the global batch: 64 rows a rank of a
  128-row batch take the einsum branch (batch·heads ≥ 128) that 64 rows
  alone would not, and give the single process's rows bit for bit.
* ``dp_sample`` (DEPLOY_INT8, bf16 carrier, 3 DDIM steps) at eta 0 and
  eta 1: each rank draws the global noise and keeps its rows, so the
  gathered samples equal the single process's bit for bit (the same
  per-row float operations on one thread).
* ``dp_reconstruct`` at group sizes 1 and 2 (``num_res_blocks=2`` so that
  two targets group, 16 rows, minibatch 8, 3 iterations, the first 3
  block targets) against the single-process ``reconstruct``, with JAX's
  tolerance (rtol 1e-3, atol 6·lr: Adam turns a sign flip of a
  near-zero gradient into a ±lr step); a minibatch that does not divide
  the mesh raises "must divide", rows that do not divide it "do not shard
  evenly".  The captures are row-sharded: the first group's, gathered in
  rank order, are the single process's bit for bit, every target's
  ``cache_bytes`` is half the single process's, and each drawn minibatch
  is one row exchange (``comm.stats["rows_*"]``); the same on a tiny LDM's
  first res block and first transformer block (a context target) under a
  capture budget that caps both (the capped rows fetched from their
  owners).  ``rows.fetch`` on its own: each rank's block of an index list
  with repeats, in three dtypes.
* tp at ``make_mesh2d(1, 2)``: DEPLOY_INT8 bit-equal to the unsharded
  forward, FP within 1e-5, WAQ under JAX's bounds (max < 0.15, mean <
  0.01); every layer whose output width divides is sharded.
* ``tp_sample`` at ``make_mesh2d(2, 2)`` (world 4): the FP trajectory
  within 1e-5 of the single process's, DEPLOY_INT8 bit-equal.
* A rank's exception reaches the parent.
"""

import contextlib
import copy
import dataclasses
import re

import numpy as np
import pytest
import torch

from eda_dm_tpu_torch.parallel import launch

TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=16)
ROWS, BATCH, PAD_ROWS = 8, 4, 5
LR = 1e-4


def short_search(base):
    """``base`` (either package's QuantConfig class) with 20 candidates in
    the act range search instead of 100, to keep the exact 2-D searches
    of the tiny model short (as ``test_torch_calib`` does)."""
    @dataclasses.dataclass(frozen=True)
    class QC(base):
        @property
        def aq(self):
            return dataclasses.replace(super().aq, num_candidates=20)
    return QC()


def _port_name(path):
    return ".".join(re.sub(r"^(down|up|block|attn)_(\d+)$", r"\1.\2", p) for p in path)


# --------------------------------------------------------------------------
# rank functions (no JAX)

def _port_model(tree, cfg=None):
    from eda_dm_tpu_torch.models.bridge import from_jax_variables
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig
    from eda_dm_tpu_torch.quant import QuantConfig
    return from_jax_variables(tree, DDPMConfig(**(cfg or TINY)), short_search(QuantConfig),
                              device="cpu")


def _act_state(model):
    from eda_dm_tpu_torch.models.bridge import to_jax_variables
    return to_jax_variables(model)["quant"]


def _act_differ(a, b):
    """Names of the act quantizers whose state differs in any bit."""
    from eda_dm_tpu_torch.nn.layers import ActQuantizer
    mb = dict(b.named_modules())
    leaves = ("delta", "zero_point", "one_side", "running_min", "running_max", "inited")
    return [n for n, q in a.named_modules() if isinstance(q, ActQuantizer)
            and not all(torch.equal(getattr(q, k), getattr(mb[n], k)) for k in leaves)]


def _forced(model, records, rank, world):
    """``parity.tap`` replacing each quantizer's input by this rank's rows
    of another run's (records: one ``{name: [input per call]}`` a batch)."""
    from eda_dm_tpu_torch.nn.layers import ActQuantizer
    from eda_dm_tpu_torch.parity import tap
    rep = {}
    for rec in records:
        for name, calls in rec.items():
            for a in calls:
                a = torch.as_tensor(a)
                b = a.shape[0] // world
                rep.setdefault(name, []).append((a[rank * b:(rank + 1) * b], None))
    return tap(model, ActQuantizer, replace=rep)


def _calibration_cases(rank, world, inp, mesh):
    from eda_dm_tpu_torch.calib.scale_init import set_act_quantize_params
    from eda_dm_tpu_torch.nn.layers import ActQuantizer
    from eda_dm_tpu_torch.parallel import dp
    from eda_dm_tpu_torch.parity import tap
    x, t = torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"])
    out = {}
    base = _port_model(inp["calib_w"])
    for case, n in (("even", ROWS), ("padded", PAD_ROWS)):
        cali = (x[:n], t[:n])
        if f"records_{case}" in inp:
            m = copy.deepcopy(base)
            with _forced(m, inp[f"records_{case}"], rank, world):
                dp.dp_calibrate_acts(m, cali, mesh, batch_size=BATCH)
            out[f"forced_jax_{case}"] = _act_state(m)
        bs = BATCH - BATCH % world if BATCH > world else BATCH   # JAX's rounding
        pad = []                # the batches as dp pads them: cyclic repetition
        for s in range(0, n, bs):
            r = min(bs, n - s)
            pad += [s + i % r for i in range(-(-r // world) * world)]
        tiled = (x[pad], t[pad])
        one = copy.deepcopy(base)
        with tap(one, ActQuantizer) as rec:
            set_act_quantize_params(one, tiled, batch_size=bs, device="cpu")
        per_batch = [{k: [v[i][0]] for k, v in rec.items()}
                     for i in range(len(next(iter(rec.values()))))]
        m = copy.deepcopy(base)
        with _forced(m, per_batch, rank, world):
            dp.dp_calibrate_acts(m, cali, mesh, batch_size=BATCH)
        out[f"same_inputs_{case}"] = _act_differ(m, one)
        par = dp.dp_calibrate_acts(copy.deepcopy(base), cali, mesh, batch_size=BATCH)
        out[f"free_{case}"] = (_act_state(par), _act_state(one))
        if case == "padded":
            pre = dp.dp_calibrate_acts(copy.deepcopy(base), tiled, mesh, batch_size=bs)
            out["padded_vs_pretiled"] = _act_differ(par, pre)
    return out


def _serving(inp):
    """The tiny DDPM calibrated by the single process and its int8 export
    (float32 weights; the bf16 carrier below)."""
    from eda_dm_tpu_torch.calib.scale_init import set_act_quantize_params
    from eda_dm_tpu_torch.quant.export import export_serving_int8
    x, t = torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"])
    model = set_act_quantize_params(_port_model(inp["calib_w"]), (x, t),
                                    batch_size=BATCH, device="cpu")
    return model, export_serving_int8(copy.deepcopy(model), dtype=torch.bfloat16)


def _sampler(eta):
    from eda_dm_tpu_torch.quant import DEPLOY_INT8
    from eda_dm_tpu_torch.samplers.ddim import generalized_steps
    from eda_dm_tpu_torch.samplers.schedules import get_beta_schedule, skip_sequence
    betas = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                              num_diffusion_timesteps=100)
    seq = skip_sequence("uniform", 3, 100)

    def sample(model, x, generator, mode=DEPLOY_INT8):
        ct = next(model.parameters()).dtype
        fn = lambda a, b: model(a.to(ct), b, mode).float()
        return generalized_steps(x, seq, fn, betas, eta=eta, generator=generator,
                                 device="cpu")
    return sample


def _dispatch_case(rank, world, serving, mesh):
    """One attention block on 64 rows a rank of a 128-row batch."""
    import eda_dm_tpu_torch.models.ddpm_unet as ddpm
    from eda_dm_tpu_torch.parallel import rows
    from eda_dm_tpu_torch.parallel.mesh import axis_group
    from eda_dm_tpu_torch.quant import DEPLOY_INT8
    block = serving.mid_attn_1
    g = torch.Generator().manual_seed(11)
    x = torch.randn(64 * world, 8, 8, 64, generator=g).to(torch.bfloat16)
    mine = slice(rank * 64, (rank + 1) * 64)
    chosen, impl = [], ddpm.attention_impl
    ddpm.attention_impl = lambda *a: chosen.append(impl(*a)) or chosen[-1]
    try:
        with torch.no_grad():
            full = block(x, DEPLOY_INT8)[mine]
            with rows.sharded_rows(axis_group(mesh, "dp")):
                local = block(x[mine], DEPLOY_INT8)
            block(x[mine], DEPLOY_INT8)                 # the rows alone
    finally:
        ddpm.attention_impl = impl
    return {"branches": chosen, "equal": bool(torch.equal(full, local))}


def _tp_cases(rank, world, model, serving, inp):
    from eda_dm_tpu_torch.nn.layers import QConv, QDense
    from eda_dm_tpu_torch.parallel import tp
    from eda_dm_tpu_torch.quant import DEPLOY_INT8, FP, WAQ
    mesh = tp.make_mesh2d(1, world)
    x, t = torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"])
    out = {}
    with torch.no_grad():
        for name, m, mode, xin in (("fp", model, FP, x), ("waq", model, WAQ, x),
                                   ("int8", serving, DEPLOY_INT8, x.bfloat16())):
            sharded = tp.shard_params_tp(mesh, copy.deepcopy(m))
            out[name] = (m(xin, t, mode).float(), sharded(xin, t, mode).float())
    out["sharded"] = len(tp.tp_layers(sharded))
    out["divisible"] = sum(1 for m in serving.modules() if isinstance(m, (QConv, QDense))
                           and m.features % world == 0 and m.features // world >= 2)
    return out


@contextlib.contextmanager
def _first_captures():
    """Record the captures of ``reconstruct``'s first group (taken before
    any target is reconstructed, so a dp run's equal the single
    process's rows)."""
    from eda_dm_tpu_torch.calib import recon
    real, seen = recon.build_group_data, []

    def record(*a, **k):
        datas = real(*a, **k)
        if not seen:
            seen.extend(dict(d) for d in datas)
        return datas
    recon.build_group_data = record
    try:
        yield seen
    finally:
        recon.build_group_data = real


def _tensors(data):
    return {f"{k}.{i}": t for k, v in data.items()
            for i, t in enumerate(v if isinstance(v, tuple) else (v,))}


def _recon_pair(model, cali, plan, args, mesh, **kw):
    """The single process's ``reconstruct`` and ``dp_reconstruct`` from the
    same start: their states, logs, the keys of the first group's captures
    whose rows, gathered in rank order, differ from the single process's
    in any bit (and how many were compared), and the row exchange's
    counters."""
    from eda_dm_tpu_torch.calib.recon import reconstruct
    from eda_dm_tpu_torch.parallel import comm, dp
    gen = lambda: torch.Generator().manual_seed(7)
    state = lambda m: {k: v.clone() for k, v in m.named_buffers() if v is not None}
    log_one, log_par = [], []
    with _first_captures() as cap_one:
        one = reconstruct(copy.deepcopy(model), cali, plan, args, gen(), log=log_one, **kw)
    comm.reset_stats()
    with _first_captures() as cap_par:
        par = dp.dp_reconstruct(copy.deepcopy(model), cali, plan, args, gen(), mesh,
                                log=log_par, **kw)
    exchange = {k: comm.stats[k] for k in ("rows_calls", "rows_bytes")}
    group = mesh.get_group(0)
    differ, compared = [], 0
    for d_one, d_par in zip(cap_one, cap_par):
        a, b = _tensors(d_one), _tensors(d_par)
        assert sorted(a) == sorted(b)
        for k in a:
            compared += 1
            if not torch.equal(comm.all_gather(b[k], group), a[k]):
                differ.append(k)
    return dict(states=(state(one), state(par)), logs=(log_one, log_par),
                captures=(differ, compared, len(cap_one)), exchange=exchange)


def _recon_cases(rank, world, inp, mesh):
    from eda_dm_tpu_torch.calib.recon import ReconArgs
    from eda_dm_tpu_torch.calib.scale_init import (set_act_quantize_params,
                                                   set_weight_quantize_params)
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet, ddpm_recon_plan
    from eda_dm_tpu_torch.parallel import dp
    from eda_dm_tpu_torch.quant import QuantConfig
    cfg = DDPMConfig(**{**TINY, "num_res_blocks": 2})
    qc = short_search(QuantConfig)
    g = torch.Generator().manual_seed(0)
    cali = (torch.randn(16, 16, 16, 3, generator=g), torch.linspace(0.0, 90.0, 16))
    model = DDPMUNet(cfg, qc, device="cpu", seed=0)
    set_weight_quantize_params(model, cali, device="cpu")
    set_act_quantize_params(model, cali, batch_size=16, device="cpu")
    plan = [tg for tg in ddpm_recon_plan(cfg, qc) if tg.kind == "block"][:3]
    args = ReconArgs(iters=3, batch_size=8, lr_w=LR, lr_a=LR)
    out = {"before": {k: v.clone() for k, v in model.named_buffers() if v is not None}}
    for gs in (1, 2):
        out[gs] = _recon_pair(model, cali, plan, args, mesh, group_size=gs)
    out["ldm_capped"] = _ldm_capped_case(mesh)
    for name, rows_, a in (("error", 16, ReconArgs(iters=1, batch_size=3)),
                           ("rows_error", 15, ReconArgs(iters=1, batch_size=4))):
        try:
            dp.dp_reconstruct(copy.deepcopy(model), tuple(c[:rows_] for c in cali), plan[:1],
                              a, torch.Generator(), mesh)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


LDM_RECON = dict(image_size=8, in_channels=3, model_channels=32, out_channels=3,
                 num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                 num_head_channels=16, use_spatial_transformer=True, context_dim=16)


def _ldm_capped_case(mesh):
    """A tiny text-conditional LDM UNet: its first res block and its first
    transformer block (``has_ctx``) under a capture budget that caps both
    (to 8 and 4 of the 16 rows), captured 2 rows at a time, minibatches of
    2."""
    from eda_dm_tpu_torch.calib.recon import ReconArgs, tap_row_bytes
    from eda_dm_tpu_torch.calib.scale_init import (set_act_quantize_params,
                                                   set_weight_quantize_params)
    from eda_dm_tpu_torch.models.ldm_unet import LDMUNet, LDMUNetConfig, ldm_recon_plan
    from eda_dm_tpu_torch.quant import QuantConfig
    cfg, qc = LDMUNetConfig(**LDM_RECON), short_search(QuantConfig)
    model = LDMUNet(cfg, qc, device="cpu", seed=3)
    g = torch.Generator().manual_seed(1)
    cali = (torch.randn(16, 8, 8, 3, generator=g), torch.linspace(5.0, 950.0, 16),
            torch.randn(16, 4, 16, generator=g))
    set_weight_quantize_params(model, cali, device="cpu")
    set_act_quantize_params(model, cali, batch_size=16, device="cpu")
    full = ldm_recon_plan(cfg, qc)
    ctx = next(t for t in full if t.has_ctx)
    res = next(t for t in full if t.has_temb and t.kind == "block")
    plan = [t for t in full if t in (res, ctx)]
    per_row = tap_row_bytes(model, cali, plan, 4)
    budget = int(min(per_row.values()) * 16 * 0.6)     # every target over it
    args = ReconArgs(iters=3, batch_size=2, lr_w=LR, lr_a=LR, capture_batch_size=2,
                     capture_budget_bytes=budget)
    out = _recon_pair(model, cali, plan, args, mesh)
    out["has_ctx"] = [t.has_ctx for t in plan]
    return out


def world2(rank, world, dev, inp):
    from eda_dm_tpu_torch.parallel import dp, mesh as pm
    mesh = pm.make_mesh(world)
    out = {"calibration": _calibration_cases(rank, world, inp, mesh)}
    model, serving = _serving(inp)
    out["dispatch"] = _dispatch_case(rank, world, serving, mesh)
    x = torch.from_numpy(inp["x"])
    for eta in (0.0, 1.0):
        sample = _sampler(eta)
        one = sample(serving, x, torch.Generator().manual_seed(5))
        par = dp.dp_sample(sample, serving, x, torch.Generator().manual_seed(5), mesh)
        out[f"sample_eta{eta:g}"] = (one, par)
    out["tp"] = _tp_cases(rank, world, model, serving, inp)
    out["recon"] = _recon_cases(rank, world, inp, mesh)
    out["fetch"] = _fetch_case(rank, world, mesh)
    return out


def _fetch_case(rank, world, mesh):
    from eda_dm_tpu_torch.parallel import rows
    g = torch.Generator().manual_seed(3)
    full = [torch.randn(12, 3, 2, generator=g), torch.randn(12, 5, generator=g).bfloat16(),
            torch.arange(12 * 4, dtype=torch.int64).reshape(12, 4)]
    idx = torch.tensor([11, 0, 5, 6, 6, 2, 7, 1, 9, 3])      # repeats, every owner
    group, k = mesh.get_group(0), len(idx) // world
    local = [a[rank * 6:(rank + 1) * 6] for a in full]
    got = rows.fetch(local, idx, group)
    want = [a[idx[rank * k:(rank + 1) * k]] for a in full]
    try:
        rows.fetch(local, idx[:3], group)
        error = ""
    except ValueError as e:
        error = str(e)
    return got, want, error


def world4(rank, world, dev, inp):
    from eda_dm_tpu_torch.parallel import mesh as pm, tp
    from eda_dm_tpu_torch.quant import FP
    out = {"calibration": _calibration_cases(rank, world, inp, pm.make_mesh(world))}
    model, serving = _serving(inp)
    mesh = tp.make_mesh2d(2, 2)
    x = torch.from_numpy(inp["x"])
    sample = _sampler(0.0)
    out["tp_sample_fp"] = (sample(model, x, None, FP),
                           tp.tp_sample(lambda m, xx, g: sample(m, xx, g, FP), model, x,
                                        None, mesh))
    out["tp_sample_int8"] = (sample(serving, x, None),
                             tp.tp_sample(sample, serving, x, None, mesh))
    return out


def failing(rank, world, dev):
    raise ValueError(f"rank {rank} fails on purpose")


# --------------------------------------------------------------------------
# the test process: JAX's side and the two worlds

def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _jax_dp_records(model, v, cali, mesh, batch_size):
    """Each batch's act-quantizer inputs of JAX's ``dp_calibrate_acts``
    (its batching and padding, its sharded step, the inputs recorded by
    ``intercept_methods``), under the port's module names; and the state
    this recording run ends with."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    from eda_dm_tpu.nn import layers as jlayers
    from eda_dm_tpu.parallel.mesh import replicate, shard_batch
    from eda_dm_tpu.quant import config as jconf
    n = cali[0].shape[0]
    bs = min(batch_size or n, n)
    n_dev = mesh.devices.size
    if bs > n_dev:
        bs -= bs % n_dev
    v = replicate(mesh, v)

    @jax.jit
    def step(v, batch):
        rec = {}

        def keep(next_fun, args, kwargs, ctx):
            if (isinstance(ctx.module, jlayers.ActQuantizer)
                    and ctx.method_name == "__call__"
                    and not kwargs.get("params_only", False)):
                rec.setdefault(_port_name(ctx.module.path), []).append(args[0])
            return next_fun(*args, **kwargs)
        with fnn.intercept_methods(keep):
            _, upd = model.apply(v, *batch, jconf.CALIB_A, mutable=["quant"])
        return {**v, "quant": upd["quant"]}, rec

    records = []
    for s in range(0, n, bs):
        rows = tuple(a[s:s + bs] for a in cali)
        r = rows[0].shape[0]
        if r % n_dev:
            target = -(-r // n_dev) * n_dev
            rows = tuple(jnp.tile(a, (-(-target // r),) + (1,) * (a.ndim - 1))[:target]
                         for a in rows)
        v, rec = step(v, shard_batch(mesh, rows))
        records.append({k: [np.asarray(a) for a in calls] for k, calls in rec.items()})
    return v, records


@pytest.fixture(scope="module")
def jax_side():
    """The tiny JAX DDPM's CALIB_W tree, and JAX's ``dp_calibrate_acts``
    on ``make_mesh(2)`` over the even and the padded rows with each
    batch's recorded quantizer inputs."""
    import jax
    import jax.numpy as jnp
    from eda_dm_tpu.calib import scale_init as jsi
    from eda_dm_tpu.models.ddpm_unet import DDPMConfig as JCfg, DDPMUNet as JUNet
    from eda_dm_tpu.parallel.dp import dp_calibrate_acts
    from eda_dm_tpu.parallel.mesh import make_mesh
    from eda_dm_tpu.quant import config as jconf
    rng = np.random.default_rng(0)
    x = rng.standard_normal((ROWS, 16, 16, 3)).astype(np.float32)
    t = rng.integers(0, 100, ROWS).astype(np.float32)
    model = JUNet(cfg=JCfg(**TINY), qc=short_search(jconf.QuantConfig))
    v = jax.jit(lambda k, x, t: model.init(k, x, t, jconf.FP))(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]), jnp.asarray(t[:1]))
    jv = jsi.set_weight_quantize_params(model, v, (jnp.asarray(x), jnp.asarray(t)))
    mesh = make_mesh(2)
    out = {"x": x, "t": t, "calib_w": _np(jv)}
    for case, n in (("even", ROWS), ("padded", PAD_ROWS)):
        cali = (jnp.asarray(x[:n]), jnp.asarray(t[:n]))
        ref = dp_calibrate_acts(model, jv, cali, mesh, batch_size=BATCH)
        rec_v, records = _jax_dp_records(model, jv, cali, mesh, BATCH)
        out[f"jax_{case}"] = _np(ref["quant"])
        out[f"jax_recording_{case}"] = _np(rec_v["quant"])
        out[f"records_{case}"] = records
    return out


@pytest.fixture(scope="module")
def w2(jax_side):
    inp = {k: v for k, v in jax_side.items() if not k.startswith("jax_")}
    return launch.spawn(world2, 2, "gloo", "cpu", inp, threads=1, timeout_s=300)


@pytest.fixture(scope="module")
def w4(jax_side):
    inp = {k: jax_side[k] for k in ("x", "t", "calib_w")}
    return launch.spawn(world4, 4, "gloo", "cpu", inp, threads=1, timeout_s=300)


# --------------------------------------------------------------------------
# tests

TP_SPEC_CASES = [((3, 3, 32, 64), 4), ((32, 64), 4), ((64,), 4), ((1, 1, 1, 64), 4),
                 ((), 4), ((6,), 4), ((4,), 4), ((3, 3, 32, 64), 3)]


@pytest.mark.parametrize("shape,tp_size", TP_SPEC_CASES, ids=str)
def test_tp_spec_matches_jax(shape, tp_size):
    import jax.numpy as jnp
    from eda_dm_tpu.parallel.tp import tp_spec as jax_tp_spec
    from eda_dm_tpu_torch.parallel.tp import tp_spec
    assert tp_spec(shape, tp_size) == tuple(jax_tp_spec(jnp.zeros(shape), tp_size))


def _walk_act_state(got, ref, path=""):
    """``test_torch_calib``'s CALIB_A gate on every quantizer JAX holds:
    ``one_side`` equal, delta, zero_point and the running range within rel
    1e-5.  Returns the number compared."""
    if "inited" in ref:
        np.testing.assert_array_equal(got["one_side"], ref["one_side"], err_msg=path)
        assert bool(got["inited"]) and bool(ref["inited"]), path
        for k in ("delta", "zero_point", "running_min", "running_max"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=0,
                                       err_msg=f"{path}/{k}")
        return 1
    return sum(_walk_act_state(got[k], v, f"{path}/{k}") for k, v in ref.items()
               if isinstance(v, dict))


@pytest.mark.parametrize("case", ["even", "padded"])
def test_dp_calibrate_acts_matches_jax(jax_side, w2, case):
    """Each rank's quantizers on JAX's input rows of its shard: the port's
    dp state within the CALIB_A tolerance of JAX's ``dp_calibrate_acts``
    (and of the recording run, which is the same computation)."""
    for r in w2:
        got = r["calibration"][f"forced_jax_{case}"]
        assert _walk_act_state(got, jax_side[f"jax_{case}"]) == 70
        assert _walk_act_state(got, jax_side[f"jax_recording_{case}"]) == 70


@pytest.mark.parametrize("case", ["even", "padded"])
def test_dp_calibrate_acts_bit_equal_on_the_same_inputs(w2, w4, case):
    """Each rank's quantizers on its rows of the single process's inputs:
    the statistics over the ranks (extremes, histogram counts, the
    gathered small tensors) are exact, so the state is bit-equal to
    ``set_act_quantize_params``'s."""
    for r in w2 + w4:
        assert r["calibration"][f"same_inputs_{case}"] == []


def _act_leaves(tree, path=""):
    """{quantizer path: its state} of a JAX-layout quant tree."""
    if "inited" in tree:
        return {path: tree}
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_act_leaves(v, f"{path}/{k}"))
    return out


@pytest.mark.parametrize("case", ["even", "padded"])
def test_dp_calibrate_acts_free_run_matches_single_process(w2, w4, case):
    """Free-running, a rank's convs and denses run at its own row count,
    and the CPU's routes (one row: matrix-vector; several threads: the
    split of the work) sum in an order that depends on it, so the inputs
    of later quantizers differ in their last bits and a range search on a
    flat score may move a candidate.  The gate of the port's other
    free-running calibrations (``test_torch_latent_pipeline``): every
    ``one_side`` equal, every delta within rel 5 %, at least half within
    rel 1e-3."""
    for r in w2 + w4:
        par, one = r["calibration"][f"free_{case}"]
        got, ref = _act_leaves(par), _act_leaves(one)
        assert sorted(got) == sorted(ref) and len(ref) == 70
        rels = []
        for k in ref:
            np.testing.assert_array_equal(got[k]["one_side"], ref[k]["one_side"], err_msg=k)
            rels.append(float(abs(got[k]["delta"] - ref[k]["delta"]) / abs(ref[k]["delta"])))
        print(f"\n  free run: deltas bit-equal at {sum(x == 0 for x in rels)} of "
              f"{len(rels)}, within rel 1e-3 at {sum(x <= 1e-3 for x in rels)}, the "
              f"farthest rel {max(rels):.3g}")
        assert max(rels) <= 0.05 and sum(x <= 1e-3 for x in rels) >= 0.5 * len(rels)


def test_dp_calibrate_pads_like_the_pretiled_batch(w2, w4):
    for r in w2 + w4:
        assert r["calibration"]["padded_vs_pretiled"] == []


def test_attention_dispatch_follows_the_global_batch(w2):
    for r in w2:
        d = r["dispatch"]
        # full batch, the rank's rows under the context, its rows alone
        assert d["branches"] == ["einsum", "einsum", "fused"], d["branches"]
        assert d["equal"]


@pytest.mark.parametrize("eta", [0, 1])
def test_dp_sample_matches_single_process(w2, eta):
    for r in w2:
        one, par = r[f"sample_eta{eta}"]
        assert torch.isfinite(par).all()
        assert torch.equal(one, par)


@pytest.mark.parametrize("group_size", [1, 2])
def test_dp_reconstruct_matches_single_process(w2, group_size):
    for r in w2:
        rec = r["recon"]
        one, par = rec[group_size]["states"]
        assert sum(not torch.equal(one[k], rec["before"][k]) for k in one) > 0
        for k in one:
            np.testing.assert_allclose(par[k].float().numpy(), one[k].float().numpy(),
                                       rtol=1e-3, atol=3 * 2 * LR, err_msg=k)


RECON_CASES = [1, 2, "ldm_capped"]


@pytest.mark.parametrize("case", RECON_CASES)
def test_dp_reconstruct_captures_are_the_single_process_rows(w2, case):
    """Each rank captures its own block of the (capped) rows: the blocks in
    rank order are the single process's captures bit for bit."""
    for r in w2:
        differ, compared, members = r["recon"][case]["captures"]
        assert differ == [] and members == (2 if case == 2 else 1)
        assert compared >= 5 * members


@pytest.mark.parametrize("case", RECON_CASES)
def test_dp_reconstruct_holds_half_the_cache_bytes(w2, case):
    """Every target's captures on a rank of 2 are half the single
    process's; with a cap, both take the same rows.  Each iteration draws
    a minibatch and exchanges its rows once, and each capped target
    fetches its calibration rows once."""
    for r in w2:
        log_one, log_par = r["recon"][case]["logs"]
        assert [e["name"] for e in log_one] == [e["name"] for e in log_par]
        for a, b in zip(log_one, log_par):
            assert a["cache_bytes"] > 0 and 2 * b["cache_bytes"] == a["cache_bytes"], a["name"]
            assert a["row_cap"] == b["row_cap"]
            assert (a["row_cap"] in (4, 8)) if case == "ldm_capped" else a["row_cap"] is None
        exchange = r["recon"][case]["exchange"]
        capped = sum(e["row_cap"] is not None for e in log_par)
        assert exchange["rows_calls"] == 3 * len(log_par) + capped
        assert exchange["rows_bytes"] > 0


def test_dp_reconstruct_row_capped_ctx_target_matches_single_process(w2):
    """The capped path with a context target (the tiny LDM's first
    transformer block) under the tolerance of the uncapped runs."""
    for r in w2:
        rec = r["recon"]["ldm_capped"]
        assert rec["has_ctx"] == [False, True]
        one, par = rec["states"]
        for k in one:
            np.testing.assert_allclose(par[k].float().numpy(), one[k].float().numpy(),
                                       rtol=1e-3, atol=3 * 2 * LR, err_msg=k)


def test_dp_reconstruct_rejects_unshardable_batch(w2):
    for r in w2:
        assert r["recon"]["error"] and "must divide" in r["recon"]["error"]
        assert r["recon"]["rows_error"] and "do not shard evenly" in r["recon"]["rows_error"]


def test_fetch_takes_each_ranks_block_of_the_rows(w2):
    """``rows.fetch`` over rows sharded in blocks: every rank gets its
    block of the index list, in order, in every dtype, and a list that
    does not divide over the ranks raises."""
    for r in w2:
        got, want, error = r["fetch"]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert "do not shard evenly" in error


@pytest.mark.parametrize("mode", ["fp", "waq", "int8"])
def test_tp_forward_matches_single_process(w2, mode):
    for r in w2:
        ref, out = r["tp"][mode]
        if mode == "int8":
            assert torch.equal(out, ref)
        elif mode == "fp":
            np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
        else:
            d = (out - ref).abs()
            assert float(d.max()) < 0.15 and float(d.mean()) < 0.01


def test_tp_shards_every_divisible_layer(w2):
    for r in w2:
        assert r["tp"]["sharded"] == r["tp"]["divisible"] >= 20


@pytest.mark.parametrize("mode", ["fp", "int8"])
def test_tp_sample_matches_single_process(w4, mode):
    for r in w4:
        one, par = r[f"tp_sample_{mode}"]
        if mode == "int8":
            assert torch.equal(one, par)
        else:
            np.testing.assert_allclose(par.numpy(), one.numpy(), rtol=1e-5, atol=1e-5)


def test_a_rank_error_reaches_the_parent():
    with pytest.raises(Exception, match="fails on purpose"):
        launch.spawn(failing, 1, "gloo", "cpu", threads=1)
