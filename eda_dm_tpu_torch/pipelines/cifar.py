"""CIFAR-10 DDIM PTQ pipeline (port of ``eda_dm_tpu/pipelines/cifar.py``).

quantized UNet (first/last 8-bit policy built into ``DDPMUNet``) → TDAC
calibration trajectory → weight and act scale init → AdaRound + FBR block
reconstruction → sampling.  The JAX package keeps the state in a
``variables`` tree beside a stateless model; here the model holds it, so
the stages take and return the model.  Random draws come from
``torch.Generator``s seeded from ``cfg.seed``; ``run``'s ``draws`` hands in
another run's draws (TDAC's x_T and permutation, each sampling batch's
x_T) to reproduce it.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..calib.recon import ReconArgs, reconstruct
from ..calib.scale_init import set_act_quantize_params, set_weight_quantize_params
from ..calib.tdac import DENSE_R, TDACResult, select_calib_set
from ..device import model_device, resolve_device
from ..models.bridge import load_jax_variables
from ..models.convert import load_ddpm_checkpoint
from ..models.ddpm_unet import DDPMConfig, DDPMUNet, ddpm_recon_plan
from ..quant.config import FP, WAQ, QuantConfig, QuantMode
from ..samplers.ddim import ddpm_steps, generalized_steps
from ..samplers.schedules import get_beta_schedule, skip_sequence
from ..utils.run import span

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CifarConfig:
    """Knobs of the reference CLI and configs/cifar10.yml (the JAX
    package's names and defaults)."""
    # diffusion / sampling
    timesteps: int = 100
    skip_type: str = "quad"
    eta: float = 0.0
    sample_type: str = "generalized"
    num_diffusion_timesteps: int = 1000
    beta_schedule: str = "linear"
    beta_start: float = 1e-4
    beta_end: float = 0.02
    image_size: int = 32
    channels: int = 3
    # quantization
    ptq: bool = True
    weight_bit: int = 4
    act_bit: int = 8
    sm_abit: int = 8
    quant_act: bool = True
    a_sym: bool = False
    split: bool = True
    # calibration / reconstruction
    calib_num_samples: int = 1024
    batch_samples: int = 1024
    lamda: float = 1.2
    recon: bool = True
    iters: int = 5000
    lr_w: float = 5e-1
    lr_a: float = 5e-4
    add_loss: float = 0.8
    input_prob: float = 0.5
    recon_batch_size: int = 32
    capture_batch_size: Optional[int] = None
    # targets of one group are captured together (calib/recon.py); 1 is
    # the reference-exact sequential order
    recon_group_size: int = 4
    recon_group_window: int = 0
    cache_dtype: Optional[str] = None
    # sampling for FID
    max_images: int = 50000
    sample_batch_size: int = 500
    seed: int = 1234
    # model
    arch: DDPMConfig = dataclasses.field(default_factory=DDPMConfig)
    ckpt_path: Optional[str] = None


class CifarPipeline:
    """End-to-end CIFAR PTQ pipeline on ``device`` (the card unless the
    caller passes ``"cpu"``)."""

    def __init__(self, cfg: CifarConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.qc = QuantConfig(weight_bit=cfg.weight_bit, act_bit=cfg.act_bit,
                              sm_abit=cfg.sm_abit, a_sym=cfg.a_sym,
                              quant_act=cfg.quant_act, split=cfg.split)
        self.betas = get_beta_schedule(
            cfg.beta_schedule, beta_start=cfg.beta_start, beta_end=cfg.beta_end,
            num_diffusion_timesteps=cfg.num_diffusion_timesteps)
        self.seq = skip_sequence(cfg.skip_type, cfg.timesteps,
                                 cfg.num_diffusion_timesteps)

    def generator(self, offset: int = 0, device=None) -> torch.Generator:
        return torch.Generator(device=device or self.device).manual_seed(
            self.cfg.seed + offset)

    # ------------------------------------------------------------------
    def init_variables(self) -> DDPMUNet:
        """The quantized UNet with random weights from ``cfg.seed``, or with
        a reference DDPM checkpoint's (``cfg.ckpt_path``) converted in."""
        model = DDPMUNet(self.cfg.arch, self.qc, device=self.device, seed=self.cfg.seed)
        if self.cfg.ckpt_path:
            load_jax_variables(model, {"params": load_ddpm_checkpoint(self.cfg.ckpt_path)})
        return model

    # ------------------------------------------------------------------
    @torch.no_grad()
    def tdac_calibration(self, model: DDPMUNet, x_T: Optional[torch.Tensor] = None,
                         perm: Optional[np.ndarray] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, TDACResult]:
        """FP trajectory + TDAC selection.  The mid-block attention input is
        read in the same forward that computes eps (a forward pre-hook on
        ``mid_attn_1``).  ``x_T`` / ``perm`` replace the generator's draws."""
        cfg = self.cfg
        model_device(model, self.device)
        if x_T is None:
            x_T = torch.randn((cfg.batch_samples, cfg.image_size, cfg.image_size,
                               cfg.channels), generator=self.generator(1),
                              device=self.device)
        feats = []
        hook = model.mid_attn_1.register_forward_pre_hook(
            lambda m, args: feats.append(args[0]) and None)

        def model_aux(x, t):
            out = model(x, t, FP)
            return out, feats.pop()

        try:
            _, traj = generalized_steps(x_T.to(self.device), self.seq, model_aux,
                                        self.betas, eta=cfg.eta, device=self.device,
                                        generator=self.generator(2),
                                        record_xt=True, model_returns_aux=True)
        finally:
            hook.remove()
        sel = select_calib_set(traj["x"], traj["aux"], self.seq, cfg.lamda,
                               cfg.calib_num_samples, DENSE_R["cifar"],
                               generator=self.generator(3, "cpu"), perm=perm)
        return sel.calib_x, sel.calib_t, sel

    # ------------------------------------------------------------------
    def calibrate(self, model: DDPMUNet, cali_data, act_batch_size: int = 256):
        """Weight then act scale init."""
        set_weight_quantize_params(model, cali_data, device=self.device)
        return set_act_quantize_params(model, cali_data, batch_size=act_batch_size,
                                       device=self.device)

    def recon_args(self) -> ReconArgs:
        cfg = self.cfg
        return ReconArgs(iters=cfg.iters, batch_size=cfg.recon_batch_size,
                         lr_w=cfg.lr_w, lr_a=cfg.lr_a, add_loss=cfg.add_loss,
                         input_prob=cfg.input_prob,
                         capture_batch_size=cfg.capture_batch_size,
                         cache_dtype=cfg.cache_dtype)

    def reconstruct(self, model: DDPMUNet, cali_data, progress=None,
                    checkpoint_dir: Optional[str] = None, log=None):
        """Block reconstruction over ``ddpm_recon_plan``;
        ``checkpoint_dir`` checkpoints after every group and resumes
        (``utils/checkpointing.py::resumable_reconstruct``)."""
        cfg = self.cfg
        model_device(model, self.device)
        plan = ddpm_recon_plan(cfg.arch, self.qc)
        if checkpoint_dir is not None:
            from ..utils.checkpointing import resumable_reconstruct
            return resumable_reconstruct(
                model, cali_data, plan, self.recon_args(), checkpoint_dir,
                seed=cfg.seed, progress=progress, group_size=cfg.recon_group_size,
                group_window=cfg.recon_group_window)
        return reconstruct(model, cali_data, plan, self.recon_args(),
                           self.generator(4), progress=progress,
                           group_size=cfg.recon_group_size,
                           group_window=cfg.recon_group_window, log=log)

    # ------------------------------------------------------------------
    def sampler_fn(self, model: DDPMUNet, mode: QuantMode = WAQ):
        """``model_fn(x, t)`` feeding the UNet its carrier dtype (that of its
        parameters: bf16 after a serving export); the sampler's own update
        stays in the caller's dtype."""
        ct = next(model.parameters()).dtype

        def model_fn(x, t):
            return model(x.to(ct), t, mode).to(x.dtype)
        return model_fn

    @torch.no_grad()
    def sample_batch(self, model: DDPMUNet, generator: Optional[torch.Generator] = None,
                     batch_size: Optional[int] = None, mode: QuantMode = WAQ,
                     x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One sampling batch → images in [0, 1], NHWC."""
        with span("edm.pipeline.batch"):
            cfg = self.cfg
            bs = batch_size or cfg.sample_batch_size
            generator = generator or self.generator()
            if x_T is None:
                x_T = torch.randn((bs, cfg.image_size, cfg.image_size, cfg.channels),
                                  generator=generator, device=self.device)
            model_fn = self.sampler_fn(model, mode)
            x_T = x_T.to(self.device)
            if cfg.sample_type == "generalized":
                x = generalized_steps(x_T, self.seq, model_fn, self.betas, eta=cfg.eta,
                                      generator=generator, device=self.device)
            else:
                x = ddpm_steps(x_T, self.seq, model_fn, self.betas, generator=generator,
                               device=self.device)
            return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)

    def sample_fid(self, model: DDPMUNet, out_dir: Optional[str] = None,
                   max_images: Optional[int] = None, mode: QuantMode = WAQ,
                   x_T=None):
        """The FID set batch by batch; ``x_T`` (one tensor a batch) replaces
        the draws.  Returns the images (numpy) without ``out_dir``, else
        writes PNGs and returns None."""
        cfg = self.cfg
        model_device(model, self.device)
        total = max_images or cfg.max_images
        bs = min(cfg.sample_batch_size, total)
        generator = self.generator()
        images = [] if out_dir is None else None
        img_id = 0
        t0 = time.time()
        for r in range(-(-total // bs)):
            batch = self.sample_batch(model, generator, bs, mode,
                                      None if x_T is None else x_T[r]).cpu().numpy()
            take = min(bs, total - img_id)
            if out_dir is None:
                images.append(batch[:take])
            else:
                from ..eval.io import save_images
                save_images(batch[:take], out_dir, start_index=img_id)
            img_id += take
        logger.info("sampled %d images in %.1fs", img_id, time.time() - t0)
        return np.concatenate(images) if out_dir is None else None

    # ------------------------------------------------------------------
    def serving_variables(self, model: DDPMUNet, serve: str = "waq"):
        """(model, serve mode) for ``serve``: 'waq' the fake-quant model,
        'fp' the unquantized one, 'int8' / 'bf16' / 'fold' the exports of
        ``api.export_for_serving`` (a copy) with their paired modes."""
        if serve == "waq":
            return model, WAQ
        if serve == "fp":
            return model, FP
        from ..api import export_for_serving
        return export_for_serving(model, self.qc, kind=serve)

    def run(self, out_dir: Optional[str] = None, model: Optional[DDPMUNet] = None,
            progress=None, serve: str = "waq",
            draws: Optional[Dict[str, Any]] = None):
        """The full PTQ flow; returns (model, images or None).  ``draws``:
        ``"tdac_x_T"``, ``"tdac_perm"``, ``"sample_x_T"`` (a tensor a
        sampling batch) in place of the generators' draws."""
        draws = draws or {}
        if model is None:
            model = self.init_variables()
        if self.cfg.ptq:
            calib_x, calib_t, _ = self.tdac_calibration(
                model, draws.get("tdac_x_T"), draws.get("tdac_perm"))
            cali_data = (calib_x, calib_t)
            self.calibrate(model, cali_data)
            if self.cfg.recon:
                self.reconstruct(model, cali_data, progress=progress)
        serving, mode = self.serving_variables(model, serve)
        return model, self.sample_fid(serving, out_dir=out_dir, mode=mode,
                                      x_T=draws.get("sample_x_T"))
