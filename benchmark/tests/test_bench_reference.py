"""The reference against the program's own serving path at a tiny size on
the CPU, through the benchmark's run: the int8 UNet within the tiny
limit of the reference's float32 arithmetic, the sampler replays and the
decode equal to rounding; and the reference's modules against the
program's parameter names, shapes and the published counts."""

import json

import pytest
import torch

from benchmark.reference import ddpm, ldm, text, vae

from . import tiny
from .conftest import run_cell


@pytest.mark.parametrize("cell", [tiny.PIXEL, tiny.LATENT])
def test_program_agrees_with_reference(tiny_root, cell):
    rc, res = run_cell(tiny_root, cell)
    assert rc == 0 and res["correct"], res
    assert res["failed"] == 0 and res["attempted"] >= 1
    checks = res["checks"]
    assert checks["sample_err"]["value"] <= 1e-6
    assert 0.0 < checks["eps_err"]["value"] < tiny.LIMITS[cell]["eps_err"]
    if "decode_err" in checks:
        assert checks["decode_err"]["value"] <= 1e-5


@pytest.mark.parametrize("name, cls, key", [("cifar10-ddpm", ddpm.DDPMUNet, "unet"),
                                            ("sd-v1.4", ldm.LDMUNet, "unet")])
def test_reference_holds_the_published_count(name, cls, key):
    cfg = json.loads((tiny.BENCH / "configs" / f"{name}.json").read_text())
    with torch.device("meta"):
        m = cls(cfg[key])
    assert sum(p.numel() for p in m.parameters()) == cfg["parameters"]


def test_reference_names_are_the_programs():
    from eda_dm_tpu_torch.models.latent_diffusion import LatentDiffusion, LatentDiffusionConfig
    from eda_dm_tpu_torch.models.ldm_unet import LDMUNetConfig
    from eda_dm_tpu_torch.models.vae import VAEConfig
    from eda_dm_tpu_torch.quant import QuantConfig
    _, lat = tiny.tiny_configs()
    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    mc = LatentDiffusionConfig(unet=LDMUNetConfig(**tup(lat["unet"])),
                               vae=VAEConfig(**tup(lat["vae"])), cond="text")
    prog = LatentDiffusion(mc, QuantConfig(), device="cpu")
    shapes = lambda m: {n: tuple(p.shape) for n, p in m.named_parameters()}
    assert shapes(prog.unet) == shapes(ldm.LDMUNet(lat["unet"]))
    assert shapes(prog.first_stage) == shapes(vae.FirstStage(lat["vae"]))
    assert shapes(prog.cond_stage) == shapes(text.TextEncoder(lat["text_encoder"]))
