"""The port's user entry points on the host at tiny configs:
``python -m eda_dm_tpu_torch.sample_ddim``, ``.sample_ldm`` and
``.evaluate``, driven through their ``main(argv)``.

* ``sample_ddim`` on a reference-layout DDPM checkpoint (``--ckpt``):
  TDAC, CALIB_W / CALIB_A, ``--serve int8`` (the kernels' plain versions
  here) and an FP set, PNGs through ``sample_fid``; then ``--export_bundle``
  and ``--bundle``;
* ``evaluate`` on the two directories (``--isc --sfid``, random-init
  Inception, the standardized FID beside the raw one), ``--ref_stats``
  reuse and ``.npz`` features, the metric equal to the JAX package's on
  the same features;
* ``sample_ldm``: church from a LatentDiffusion checkpoint (``--resume``:
  its ``scale_factor``), ImageNet's class contexts one phase a process
  (``--phase calib``, ``recon``, ``sample`` through ``--state_dir``), coco
  through ``--text_encoder tiny`` and ``bert``; ``clip`` without a local
  checkout and ``--clear_caches_every`` refused with their reasons;
* without ``--device cpu`` and without a card, each raises.

The model sizes are cut by patching the pipelines' configs (the scripts
take the tasks' full-width models).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import test_torch_ddpm  # noqa: F401  (each xdist worker's share of the cores)
from eda_dm_tpu.eval import metrics as jm
from eda_dm_tpu_torch import evaluate, reference_layout as rl, sample_ddim, sample_ldm
from eda_dm_tpu_torch.data.datasets import iter_image_folder
from eda_dm_tpu_torch.models import latent_diffusion as tld
from eda_dm_tpu_torch.models import ldm_unet as tldm
from eda_dm_tpu_torch.models import vae as tvae
from eda_dm_tpu_torch.models.bridge import to_jax_variables
from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
from eda_dm_tpu_torch.pipelines import cifar as tcifar
from eda_dm_tpu_torch.pipelines import latent as tlatent
from eda_dm_tpu_torch.quant.config import QuantConfig

TINY = DDPMConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                  resolution=16)
BASE = dict(image_size=8, in_channels=4, out_channels=4, model_channels=32,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2))
UNET = {"church": dict(BASE, num_heads=2, use_scale_shift_norm=True, resblock_updown=True),
        "coco": dict(BASE, num_heads=4, use_spatial_transformer=True, context_dim=24,
                     legacy=False),
        "imagenet": dict(BASE, num_heads=1, use_spatial_transformer=True, context_dim=24)}
KL = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
          in_channels=3, resolution=16, z_channels=4, double_z=True, embed_dim=4,
          n_embed=None)
SCHED = {"church": dict(timesteps=50),
         "coco": dict(timesteps=50, linear_start=0.00085, linear_end=0.0120,
                      scale_factor=0.18215, cond="text"),
         "imagenet": dict(timesteps=50, cond="class", n_classes=1001, class_embed_dim=24)}
LDM_FLAGS = ["--custom_steps", "5", "--calib_num_samples", "4", "--batch_samples", "4",
             "--iters", "1", "--n_samples", "3", "--batch_size", "2", "--device", "cpu",
             "--n_rows", "2"]


def _tiny_latent(task):
    return tld.LatentDiffusionConfig(unet=tldm.LDMUNetConfig(**UNET[task]),
                                     vae=tvae.VAEConfig(**KL), **SCHED[task])


@pytest.fixture
def tiny_models(monkeypatch):
    """The scripts' pipelines at tiny sizes: a 16×16 DDPM over 100 steps,
    and 8×8×4 latent UNets over a 16×16 KL first stage."""
    @dataclasses.dataclass
    class TinyCifar(tcifar.CifarConfig):
        arch: DDPMConfig = dataclasses.field(default_factory=lambda: TINY)
        image_size: int = 16
        num_diffusion_timesteps: int = 100
    monkeypatch.setattr(tcifar, "CifarConfig", TinyCifar)
    for task in UNET:
        monkeypatch.setitem(tlatent.MODEL_CONFIGS, task, lambda t=task: _tiny_latent(t))


@pytest.fixture(scope="module")
def ddpm_ckpt(tmp_path_factory):
    src = DDPMUNet(TINY, QuantConfig(), device="cpu", seed=5)
    path = str(tmp_path_factory.mktemp("ddpm") / "model.ckpt")
    torch.save(rl.ddpm_state_dict(to_jax_variables(src)["params"]), path)
    return path


def _images_in(d):
    return np.concatenate(list(iter_image_folder(d, batch_size=64)))


def test_sample_ddim_then_evaluate(tiny_models, ddpm_ckpt, tmp_path):
    common = ["--ckpt", ddpm_ckpt, "--timesteps", "4", "--sample_batch_size", "6",
              "--max_images", "10", "--device", "cpu"]          # IS takes 10 splits
    int8 = sample_ddim.main(common + [
        "--serve", "int8", "--no-recon", "--calib_num_samples", "8", "--batch_samples", "8",
        "--logdir", str(tmp_path / "int8"), "--export_bundle", str(tmp_path / "bundle")])
    fp = sample_ddim.main(common + ["--serve", "fp", "--no-ptq", "--logdir",
                                    str(tmp_path / "fp")])
    served = sample_ddim.main(common + ["--bundle", str(tmp_path / "bundle"), "--logdir",
                                        str(tmp_path / "bundle_run")])
    for run in (int8, fp, served):
        imgs = _images_in(run["img_dir"])
        assert run["images"] == 10 and imgs.shape == (10, 16, 16, 3)
        assert set(run["seconds"]) >= {"load", "sample"}
    assert os.path.exists(os.path.join(int8["run_dir"], "run.log"))
    # the bundle serves the int8 export bit-identically
    np.testing.assert_array_equal(_images_in(served["img_dir"]), _images_in(int8["img_dir"]))
    assert not np.array_equal(_images_in(int8["img_dir"]), _images_in(fp["img_dir"]))

    res = evaluate.main(["--gen_dir", int8["img_dir"], "--ref_dir", fp["img_dir"], "--isc",
                         "--sfid", "--batch_size", "4", "--device", "cpu"])
    for k in ("fid", "fid_standardized", "sfid", "sfid_standardized", "is_mean", "is_std"):
        assert np.isfinite(res[k]), k
    assert res["images"] == 20 and res["seconds"] > 0
    assert res["fid_standardized"] > 0 and res["is_mean"] >= 1.0 - 1e-6

    stats = str(tmp_path / "ref_stats.npz")
    evaluate.main(["--ref_dir", fp["img_dir"], "--ref_stats", stats, "--device", "cpu"])
    from eda_dm_tpu_torch.eval.inception import InceptionExtractor
    feats = InceptionExtractor(device="cpu").pool3(_images_in(fp["img_dir"]))
    d = np.load(stats)
    want = jm.FeatureStats.from_features(feats)
    np.testing.assert_allclose(d["mu"], want.mu, rtol=0, atol=1e-9)
    np.testing.assert_allclose(d["sigma"], want.sigma, rtol=0, atol=1e-9)


def test_evaluate_features_equal_jax_metric(tmp_path):
    rng = np.random.default_rng(0)
    g = rng.standard_normal((30, 16)).astype(np.float32)
    r = (rng.standard_normal((40, 16)) + 0.3).astype(np.float32)
    np.savez(tmp_path / "g.npz", features=g)
    np.savez(tmp_path / "r.npz", features=r)
    res = evaluate.main(["--gen_features", str(tmp_path / "g.npz"),
                         "--ref_features", str(tmp_path / "r.npz")])
    assert res["fid"] == jm.fid_from_features(g, r)
    s = jm.FeatureStats.from_features(r)
    np.savez(tmp_path / "s.npz", mu=s.mu, sigma=s.sigma)
    probs = np.full((20, 5), 0.2, np.float32)
    np.savez(tmp_path / "p.npz", probs=probs)
    res = evaluate.main(["--gen_features", str(tmp_path / "g.npz"), "--ref_features",
                         str(tmp_path / "s.npz"), "--probs", str(tmp_path / "p.npz")])
    assert res["fid"] == jm.frechet_distance(jm.FeatureStats.from_features(g), s)
    assert (res["is_mean"], res["is_std"]) == jm.inception_score(probs)
    with pytest.raises(SystemExit):
        evaluate.main(["--gen_features", str(tmp_path / "g.npz")])


@pytest.fixture(scope="module")
def church_ckpt(tmp_path_factory):
    ld = tld.LatentDiffusion(_tiny_latent("church"), QuantConfig(), device="cpu", seed=3)
    sd = rl.latent_diffusion_state_dict(to_jax_variables(ld.unet)["params"],
                                        to_jax_variables(ld.first_stage)["params"],
                                        scale_factor=0.625)
    path = str(tmp_path_factory.mktemp("church") / "model.ckpt")
    torch.save({"state_dict": sd}, path)
    return path


def test_sample_ldm_church_from_a_checkpoint(tiny_models, church_ckpt, tmp_path, monkeypatch):
    seen = {}
    init = tlatent.LDMPipeline.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        seen["pipe"] = self
    monkeypatch.setattr(tlatent.LDMPipeline, "__init__", spy)
    out = sample_ldm.main(["--task", "church", "--resume", church_ckpt, "--serve", "int8",
                           "--logdir", str(tmp_path)] + LDM_FLAGS)
    assert seen["pipe"].mc.scale_factor == 0.625
    imgs = _images_in(out["img_dir"])
    assert imgs.shape == (3, 16, 16, 3) and np.isfinite(imgs).all()
    assert os.path.exists(os.path.join(out["run_dir"], "grid-0000.png"))


def test_sample_ldm_imagenet_one_phase_a_process(tiny_models, tmp_path):
    state = str(tmp_path / "state")
    flags = ["--task", "imagenet", "--state_dir", state, "--serve", "int8",
             "--logdir", str(tmp_path)] + LDM_FLAGS
    sample_ldm.main(flags + ["--phase", "calib"])
    assert os.path.exists(os.path.join(state, "cali.npz"))
    sample_ldm.main(flags + ["--phase", "recon"])
    out = sample_ldm.main(flags + ["--phase", "sample", "--export_bundle",
                                   str(tmp_path / "bundle")])
    assert _images_in(out["img_dir"]).shape == (3, 16, 16, 3)
    again = sample_ldm.main(flags + ["--phase", "sample", "--bundle", str(tmp_path / "bundle")])
    np.testing.assert_array_equal(_images_in(again["img_dir"]), _images_in(out["img_dir"]))
    from eda_dm_tpu_torch.eval.io import read_watermark, read_png
    grid = read_png(os.path.join(out["run_dir"], "grid-0000.png"))
    assert read_watermark(grid) == "StableDiffusionV1"


@pytest.mark.parametrize("encoder", ["tiny", "bert"])
def test_sample_ldm_coco_text_encoders(tiny_models, tmp_path, encoder):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a red barn\na cat on a sofa\n")
    out = sample_ldm.main(["--task", "coco", "--text_encoder", encoder, "--prompts_file",
                           str(prompts), "--serve", "int8", "--logdir", str(tmp_path),
                           "--skip_grid"] + LDM_FLAGS)
    assert _images_in(out["img_dir"]).shape == (3, 16, 16, 3)
    dumped = sorted(os.listdir(os.path.join(out["run_dir"], "image_prompts")))
    assert dumped[:2] == ["00000.txt", "00001.txt"]
    assert not os.path.exists(os.path.join(out["run_dir"], "grid-0000.png"))


def test_sample_ldm_refusals(tiny_models, tmp_path):
    with pytest.raises(RuntimeError, match="local CLIP checkpoint at "
                       "'openai/clip-vit-large-patch14'"):
        sample_ldm.main(["--task", "coco", "--text_encoder", "clip", "--logdir",
                         str(tmp_path)] + LDM_FLAGS)
    with pytest.raises(SystemExit):
        sample_ldm.main(["--task", "church", "--clear_caches_every", "2", "--logdir",
                         str(tmp_path)] + LDM_FLAGS)


def test_entry_points_refuse_the_host_without_cpu_opt_in(tiny_models, ddpm_ckpt, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_ddim.main(["--ckpt", ddpm_ckpt, "--logdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_ldm.main(["--task", "church", "--logdir", str(tmp_path)])
    os.makedirs(tmp_path / "imgs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--gen_dir", str(tmp_path / "imgs"), "--ref_dir", str(tmp_path / "imgs")])
