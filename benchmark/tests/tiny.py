"""A tiny copy of the benchmark for CPU tests: the real metric readers,
systems and vocabulary, BENCHMARK.json naming one tiny pixel cell and one
tiny latent cell, with configurations of the real ones' topology at CPU
size."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

PIXEL = "tiny-pixel"
LATENT = "tiny-latent"
# limits for the tiny cells on the CPU, from the readings of
# test_bench_control.py there: the program's eps_err 0.03-0.06, the
# control's 0.14-0.22; the replays and the decode agree to rounding
LIMITS = {PIXEL: {"eps_err": 0.1, "sample_err": 1e-5},
          LATENT: {"eps_err": 0.1, "sample_err": 1e-5, "decode_err": 1e-5}}


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def tiny_configs():
    pix = _json(BENCH / "configs" / "cifar10-ddpm.json")
    pix.update(name="tiny-ddpm", calibration={"rows": 4}, reference={"rows": 3},
               unet={"in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1, 2],
                     "num_res_blocks": 1, "attn_resolutions": [4], "resolution": 8})
    pix["schedule"] = dict(pix["schedule"], num_diffusion_timesteps=100)
    lat = _json(BENCH / "configs" / "sd-v1.4.json")
    lat.update(name="tiny-sd", calibration={"prompts": 2}, reference={"rows": 2})
    lat["unet"] = dict(lat["unet"], image_size=8, model_channels=32, num_res_blocks=1,
                       attention_resolutions=[2], channel_mult=[1, 2], num_heads=4,
                       context_dim=32)
    lat["vae"] = dict(lat["vae"], ch=32, ch_mult=[1, 2], num_res_blocks=1, resolution=16)
    lat["text_encoder"] = dict(lat["text_encoder"], width=32)
    lat["diffusion"] = dict(lat["diffusion"], timesteps=50)
    return pix, lat


def tiny_traffic():
    pix = _json(BENCH / "traffic" / "ddim100-b500.json")
    pix.update(batch=5, steps=4, record_batches=2, check_forwards=[0, -1], trace={"start": 1, "steps": 2})
    lat = _json(BENCH / "traffic" / "plms50-p4.json")
    lat.update(batch=2, steps=5, record_batches=1, check_forwards=[0, 3, -1], trace={"start": 2, "steps": 2})
    return pix, lat


def make_root(tmp: Path, limits: dict = None) -> Path:
    """``tmp`` laid out as a checkout: BENCHMARK.json and benchmark/ with
    the tiny configurations, mixes, the real readers and ``limits``
    (cell → {number: limit})."""
    bench = tmp / "benchmark"
    for d in ("configs", "traffic", "limits"):
        (bench / d).mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "systems"):
        shutil.copytree(BENCH / d, bench / d, dirs_exist_ok=True)
    shutil.copy(BENCH / "traffic" / "caption_words.txt", bench / "traffic")
    spec = copy.deepcopy(_json(REPO / "BENCHMARK.json"))
    (pc, lc), (pt, lt) = tiny_configs(), tiny_traffic()
    for cfg, mix, cell in ((pc, pt, PIXEL), (lc, lt, LATENT)):
        (bench / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        (bench / "traffic" / f"{cell}-mix.json").write_text(json.dumps(mix))
        if limits and cell in limits:
            (bench / "limits" / f"{cell}.json").write_text(json.dumps(
                {k: {"limit": v} for k, v in limits[cell].items()}))
    spec["configs"] = [{"name": c["name"], "source": c["source"], "reduced": [],
                        "file": f"benchmark/configs/{c['name']}.json", "why": "tiny"}
                       for c in (pc, lc)]
    spec["workloads"] = [{"name": PIXEL, "config": pc["name"], "traffic": f"{PIXEL}-mix",
                          "chips": 1, "why": "tiny"},
                         {"name": LATENT, "config": lc["name"], "traffic": f"{LATENT}-mix",
                          "chips": 1, "why": "tiny"}]
    for group in ("end_to_end", "per_layer"):             # the host-paced variants: no tiny cell
        for m in spec[group]:
            if "workloads" in m:
                m["workloads"] = ([] if m["name"].endswith(".host_paced") else
                                  [PIXEL] if m["name"] == "step_ms_p95" else
                                  [LATENT] if m["name"] == "decode_ms" else [PIXEL, LATENT])
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
