"""Package-level guarantees of the PyTorch port.

* no module of ``eda_dm_tpu_torch`` and no line of ``chip_smoke.py``
  imports JAX, Flax, ``msgpack`` or the JAX package (a source scan; the
  card's machine has none of them);
* the package imports with JAX, Flax and ``msgpack`` made unimportable;
* entry points run on the card unless asked for the CPU: without a card
  and without ``device="cpu"`` they raise.
"""

import ast
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "eda_dm_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "eda_dm_tpu"}
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_package_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'flax', 'msgpack', 'eda_dm_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import eda_dm_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'eda_dm_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'triton' not in sys.modules\n"
        "print(len(names))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 15


def test_entry_points_refuse_the_host_without_cpu_opt_in():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
    from eda_dm_tpu_torch.samplers.ddim import generalized_steps
    tiny = DDPMConfig(ch=32, ch_mult=(1,), num_res_blocks=1,
                      attn_resolutions=(), resolution=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DDPMUNet(tiny)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DDPMUNet(tiny, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generalized_steps(torch.zeros(1, 8, 8, 3), np.array([0, 5]),
                          lambda x, t: x, np.full(10, 0.01, np.float32))
    assert next(DDPMUNet(tiny, device="cpu").parameters()).device.type == "cpu"
    from eda_dm_tpu_torch.models.ldm_unet import LDMUNet, LDMUNetConfig
    from eda_dm_tpu_torch.models.vae import FirstStage, VAEConfig
    from eda_dm_tpu_torch.pipelines.latent import LDMPipeline, task_config
    from eda_dm_tpu_torch.models.encoders import ClassEmbedder, TinyTextEncoder
    from eda_dm_tpu_torch.samplers.latent import (ldm_ddim_sample, ldm_plms_sample,
                                                  make_ldm_schedule)
    ldm = LDMUNetConfig(image_size=8, model_channels=32, channel_mult=(1,),
                        num_res_blocks=1, attention_resolutions=())
    for make in (lambda: LDMUNet(ldm), lambda: FirstStage(VAEConfig(ch=32)),
                 lambda: LDMPipeline(task_config("bedroom")),
                 lambda: TinyTextEncoder(context_dim=8),
                 lambda: ClassEmbedder(8, 11),
                 lambda: ldm_ddim_sample(torch.zeros(1, 8, 8, 3),
                                         make_ldm_schedule(ddim_steps=2),
                                         lambda x, t: x),
                 lambda: ldm_plms_sample(torch.zeros(1, 8, 8, 3),
                                         make_ldm_schedule(ddim_steps=2),
                                         lambda x, t: x)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    from eda_dm_tpu_torch.probes import mma_int8
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mma_int8.main(device=device, shapes=((256, 128),), steps=1)


def test_conv_plans_probe_needs_a_card():
    """K1's variant probe builds and times kernels only: it refuses the
    host, CPU included, before it builds anything."""
    from eda_dm_tpu_torch.probes import conv_plans
    for device, what in ((None, "no CUDA device"), ("cuda", "no CUDA device"),
                         ("cpu", "needs a CUDA card")):
        with pytest.raises(RuntimeError, match=what):
            conv_plans.main(device=device)


def test_attention_phases_probe_needs_a_card():
    """K4's phase probe builds and times kernels only: it refuses the
    host, CPU included, before it builds anything."""
    from eda_dm_tpu_torch.probes import attention_phases
    for device, what in ((None, "no CUDA device"), ("cuda", "no CUDA device"),
                         ("cpu", "needs a CUDA card")):
        with pytest.raises(RuntimeError, match=what):
            attention_phases.main(device=device)


def test_flash_plans_probe_needs_a_card():
    """K5's plan probe builds and times kernels only: it refuses the host,
    CPU included, before it builds anything."""
    from eda_dm_tpu_torch.probes import flash_plans
    for device, what in ((None, "no CUDA device"), ("cuda", "no CUDA device"),
                         ("cpu", "needs a CUDA card")):
        with pytest.raises(RuntimeError, match=what):
            flash_plans.main(device=device)


def test_gn_plans_probe_needs_a_card():
    """K6's plan probe builds and times kernels only: it refuses the host,
    CPU included, before it builds anything."""
    from eda_dm_tpu_torch.probes import gn_plans
    for device, what in ((None, "no CUDA device"), ("cuda", "no CUDA device"),
                         ("cpu", "needs a CUDA card")):
        with pytest.raises(RuntimeError, match=what):
            gn_plans.main(device=device)


def test_softmax_plans_probe_needs_a_card():
    """K3's plan probe builds and times kernels only: it refuses the host,
    CPU included, before it builds anything."""
    from eda_dm_tpu_torch.probes import softmax_plans
    for device, what in ((None, "no CUDA device"), ("cuda", "no CUDA device"),
                         ("cpu", "needs a CUDA card")):
        with pytest.raises(RuntimeError, match=what):
            softmax_plans.main(device=device)


def test_fq_plans_probe_needs_a_card():
    """K7's plan probe builds and times kernels only: it refuses the host,
    CPU included, before it builds anything."""
    from eda_dm_tpu_torch.probes import fq_plans
    for device, what in ((None, "no CUDA device"), ("cuda", "no CUDA device"),
                         ("cpu", "needs a CUDA card")):
        with pytest.raises(RuntimeError, match=what):
            fq_plans.main(device=device)


def test_modules_mirror_jax_paths():
    """Module paths map mechanically onto the JAX variable paths."""
    from eda_dm_tpu_torch.models.bridge import _child
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
    tiny = DDPMConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                      attn_resolutions=(8,), resolution=16)
    model = DDPMUNet(tiny, device="cpu")
    names = dict(model.named_modules())
    for jax_path in ("down_0/block_0/conv1", "down_1/attn_0/act_quantizer_w",
                     "mid_attn_1/act_quantizer_q", "up_1/block_0/nin_shortcut",
                     "up_1/upsample/conv", "temb_dense_0", "conv_out"):
        mod = model
        for part in jax_path.split("/"):
            mod = _child(mod, part)
        torch_path = ".".join(re.sub(r"^(down|up|block|attn)_(\d+)$", r"\1.\2", p)
                              for p in jax_path.split("/"))
        assert names[torch_path] is mod


def test_int8_serving_needs_the_int8_export():
    """DEPLOY_INT8 on a model without exported integer codes raises instead
    of silently serving something else."""
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
    from eda_dm_tpu_torch.quant import DEPLOY, DEPLOY_INT8, QuantConfig
    from eda_dm_tpu_torch.quant.export import export_serving
    tiny = DDPMConfig(ch=32, ch_mult=(1,), num_res_blocks=1,
                      attn_resolutions=(), resolution=8)
    model = export_serving(DDPMUNet(tiny, device="cpu"), QuantConfig(),
                           torch.float32)
    x, t = torch.zeros(1, 8, 8, 3), torch.zeros(1)
    with torch.no_grad():
        assert torch.isfinite(model(x, t, DEPLOY)).all()
        with pytest.raises(RuntimeError, match="export_serving_int8"):
            model(x, t, DEPLOY_INT8)


def _tiny_model():
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
    tiny = DDPMConfig(ch=32, ch_mult=(1,), num_res_blocks=1,
                      attn_resolutions=(), resolution=8)
    x = torch.randn(1, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    return DDPMUNet(tiny, device="cpu"), x, torch.full((1,), 10.0)


def test_parity_tap_records_and_forces_inputs():
    """``tap`` keeps each call's input and output; with ``replace=`` every
    tapped module computes on the recorded input instead of its own."""
    from eda_dm_tpu_torch.nn.layers import GNorm, QConv
    from eda_dm_tpu_torch.parity import tap
    from eda_dm_tpu_torch.quant import FP
    model, x, t = _tiny_model()
    with torch.no_grad():
        with tap(model, (GNorm, QConv)) as rec:
            ref = model(x, t, FP)
        assert list(rec)[:2] == ["conv_in", "down.0.block.0.GroupNorm_0"]
        assert torch.equal(rec["conv_in"][0][0], x)
        assert torch.equal(rec["conv_out"][0][1], ref)
        # a forced run on another input reproduces the recorded run
        with tap(model, (GNorm, QConv), replace=rec) as forced:
            out = model(x + 1.0, t, FP)
    assert torch.equal(out, ref)
    assert torch.equal(forced["conv_in"][0][0], x + 1.0)      # its own input


def test_parity_act_code_flips_counts_codes():
    """Two runs whose act-quantizer inputs differ by a whole step at one
    element differ in exactly one code there."""
    from eda_dm_tpu_torch.nn.layers import ActQuantizer
    from eda_dm_tpu_torch.parity import act_code_flips, tap
    from eda_dm_tpu_torch.quant import DEPLOY
    model, x, t = _tiny_model()
    with torch.no_grad():
        with tap(model, ActQuantizer) as a:
            model(x, t, DEPLOY)
    b = {name: [(xi.clone(), o) for xi, o in calls] for name, calls in a.items()}
    a["conv_in.act_quantizer"][0][0][0, 0, 0, 0] = 10.0       # Δ is 1 here
    b["conv_in.act_quantizer"][0][0][0, 0, 0, 0] = 11.0
    rows = act_code_flips(model, a, b)
    assert [r[0] for r in rows] == list(a)
    assert {r[0]: r[2] for r in rows if r[2]} == {"conv_in.act_quantizer": 1}
    assert max(r[3] for r in rows) == 1.0
