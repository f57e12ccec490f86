"""``python -m eda_dm_tpu_torch.gate_recon_deviations`` (the port of
``scripts/gate_recon_deviations.py``) on the CPU.

* ``_metrics`` and ``_control_metrics`` equal the JAX script's (loaded
  from its file) on the same seeded features, float for float, for each
  verdict each of them gives.
* ``--from-dump`` reads an npz in the JAX script's layout.
* Arm B's budget splits the groups of the mid-size arch at ``--calib 256``
  into the same subgroups and row caps as JAX's ``_split_by_budget``, from
  shapes only (fake tensors in the port, ``eval_shape`` in JAX); the caps
  keep all rows, since the capture batch is all of them.
* ``main`` at a tiny arch, three iterations and 8 images a population,
  prints finite JSON with the JAX script's keys; the pool3 features are
  cut to 64 dimensions there to keep the 2048-wide ``sqrtm``s out of the
  test's time.
* The seed-2 refusals of ``--with-control`` and ``--control-seed``.
"""

import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from test_torch_ddpm import _share_cores  # noqa: F401  (shares the cores among workers)
import eda_dm_tpu_torch.gate_recon_deviations as gate

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scripts", "gate_recon_deviations.py")


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location("jax_gate_recon_deviations", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _features(case, n=64, d=16):
    """Seeded (f_f, f_a, f_b, f_c) that put ``_metrics`` and
    ``_control_metrics`` on one verdict each."""
    rng = np.random.default_rng(["PASS", "WEAK-PASS", "INCONCLUSIVE", "FAIL"].index(case))
    f_a = rng.standard_normal((n, d))
    noise = lambda s: s * rng.standard_normal((n, d))
    # the noise of B, of FP, FP's shift and the noise of the control arm
    sb, sf, shift, sc = {"PASS": (0.05, 0.5, 1.5, 0.05), "WEAK-PASS": (0.7, 1.0, 0.0, 0.45),
                         "INCONCLUSIVE": (1.0, 0.01, 0.0, 1.0),
                         "FAIL": (2.0, 0.3, 1.5, 0.3)}[case]
    return f_a + noise(sf) + shift, f_a, f_a + noise(sb), f_a + noise(sc)


@pytest.mark.parametrize("case", ["PASS", "WEAK-PASS", "INCONCLUSIVE", "FAIL"])
def test_metrics_equal_the_jax_scripts(jax_script, case):
    f_f, f_a, f_b, f_c = _features(case)
    got = gate._metrics(f_f, f_a, f_b, 7, len(f_a))
    assert got == jax_script._metrics(f_f, f_a, f_b, 7, len(f_a))
    assert got["gate"] == case
    ctl = gate._control_metrics(f_f, f_a, f_b, f_c, 7, len(f_a))
    assert ctl == jax_script._control_metrics(f_f, f_a, f_b, f_c, 7, len(f_a))
    if case != "INCONCLUSIVE":                # the control has no such verdict
        assert ctl["gate_seed_control"] == case


def test_from_dump_reads_the_jax_layout(tmp_path, capsys):
    f_f, f_a, f_b, _ = _features("PASS")
    path = str(tmp_path / "dump.npz")
    np.savez_compressed(path, f_f=f_f, f_a=f_a, f_b=f_b, iters=11, n=len(f_a))
    out = gate.main(["--from-dump", path])
    assert out["metrics"] == gate._metrics(f_f, f_a, f_b, 11, len(f_a))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out["metrics"]


def test_arm_b_budget_splits_as_jax(jax_script):
    import jax
    import jax.numpy as jnp
    from eda_dm_tpu.calib import recon as jrecon
    from eda_dm_tpu.models.ddpm_unet import DDPMConfig as JCfg, DDPMUNet as JUNet
    from eda_dm_tpu.models.ddpm_unet import ddpm_recon_plan as jplan
    from eda_dm_tpu.quant import FP as JFP, QuantConfig as JQC
    from eda_dm_tpu_torch.calib import recon
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMUNet, ddpm_recon_plan
    from eda_dm_tpu_torch.quant import QuantConfig
    calib, cfg = 256, gate.arch()
    budget = gate.arm_b_budget(calib)
    # the port, from the taps' shapes
    qc = QuantConfig(weight_bit=4, act_bit=8)
    model = DDPMUNet(cfg, qc, device="cpu", seed=0)
    cali = (torch.zeros(calib, 32, 32, 3), torch.zeros(calib))
    args = recon.ReconArgs(iters=1, batch_size=32, cache_dtype="bfloat16",
                           capture_budget_bytes=budget)
    plan = ddpm_recon_plan(cfg, qc)
    row_bytes = recon.tap_row_bytes(model, cali, plan, 2)
    port = [recon._split_by_budget(row_bytes, calib, g, args)
            for g in recon.group_plan(plan, 4, 1)]
    # JAX, from eval_shape
    jcfg, jqc = JCfg(**{f: getattr(cfg, f) for f in ("ch", "ch_mult", "num_res_blocks",
                                                     "attn_resolutions", "resolution")}), \
        JQC(weight_bit=4, act_bit=8)
    jmodel = JUNet(cfg=jcfg, qc=jqc)
    x1, t1 = jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,))
    variables = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x1, t1, JFP))
    jcali = (jax.ShapeDtypeStruct((calib, 32, 32, 3), jnp.float32),
             jax.ShapeDtypeStruct((calib,), jnp.float32))
    jargs = jrecon.ReconArgs(iters=1, batch_size=32, cache_dtype="bfloat16",
                             capture_budget_bytes=budget)
    jgroups = jrecon.group_plan(jplan(jcfg, jqc), 4, 1)
    jax_split = [jrecon._split_by_budget(jmodel, variables, jcali, g, jargs) for g in jgroups]
    names = lambda split: [([[t.name for t in sg] for sg in subs], cap) for subs, cap in split]
    assert names(port) == names(jax_split)
    # arm B takes the row cap where a member alone exceeds the budget; the
    # cap is a multiple of the capture batch, which defaults to all rows,
    # so it keeps all 256 (in JAX as here)
    caps = [cap for _, cap in port if cap]
    assert caps and set(caps) == {calib}


@pytest.fixture
def tiny_gate(monkeypatch):
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig
    monkeypatch.setattr(gate, "arch", lambda: DDPMConfig(
        ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16))
    feats = gate.feats
    monkeypatch.setattr(gate, "feats", lambda ext, imgs: feats(ext, imgs)[:, :64])


def test_main_prints_finite_metrics(tmp_path, capsys, tiny_gate, jax_script):
    dump = str(tmp_path / "dump.npz")
    out = gate.main(["--iters", "3", "--n", "8", "--calib", "8", "--steps", "2",
                     "--device", "cpu", "--dump", dump])
    m = out["metrics"]
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == m
    f = np.load(dump)
    assert set(m) == set(jax_script._metrics(f["f_f"], f["f_a"], f["f_b"], 3, 8))
    assert all(math.isfinite(v) for v in m.values() if isinstance(v, float))
    assert m["gate"] in ("PASS", "WEAK-PASS", "INCONCLUSIVE", "FAIL")
    assert out["arm_b_row_caps"] == [] and (m["iters"], m["n"]) == (3, 8)


@pytest.mark.parametrize("flag", ["--with-control", "--control-seed"])
def test_seed_2_collides(flag):
    with pytest.raises(SystemExit):
        gate.main([flag, "2", "--device", "cpu"])
