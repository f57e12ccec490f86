"""Latent-diffusion serving (port of ``eda_dm_tpu/pipelines/latent.py``:
``LDMTaskConfig``, ``task_config`` and ``sample_batch``) for the LSUN-Bedroom
task (unconditional, DDIM) and the COCO text-to-image task (SD v1.4, PLMS,
classifier-free guidance).

One batch is x_T → the task's sampler (DDIM or PLMS) over the quantized
UNet, under classifier-free guidance where the task has a text context
and a scale other than 1 (``cfg_model_fn``: one UNet call on the doubled
batch [uncond; cond]) → the float32 first-stage decode → images clipped to
[0, 1], NHWC.  The UNet is
fed its carrier dtype (that of its parameters: bf16 after
``export_serving_int8(..., torch.bfloat16)``); the sampler and the decode
stay float32, with TF32 off.  Calibration (TDAC, scale init,
reconstruction) comes with a later slice: until then the caller sets the
quant state and runs the export.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..models.latent_diffusion import (LatentDiffusion, LatentDiffusionConfig,
                                       bedroom_config, sd_v1_config)
from ..ops.int8_einsum import tf32_off
from ..quant.config import DEPLOY_INT8, QuantConfig, QuantMode
from ..samplers.latent import (cfg_model_fn, ldm_ddim_sample, ldm_plms_sample,
                               make_ldm_schedule)


@dataclasses.dataclass
class LDMTaskConfig:
    """The serving knobs of one task (the JAX package's defaults).  The
    quantization is the task's W4A8 with 8-bit softmax codes and split
    shortcut quantizers (``QC``)."""
    task: str = "bedroom"
    custom_steps: int = 200
    eta: float = 1.0
    sampler: str = "ddim"                 # 'ddim' | 'plms'
    scale: float = 1.0                    # classifier-free guidance scale
    batch_size: int = 50


QC = QuantConfig(weight_bit=4, act_bit=8, sm_abit=8, split=True)


TASK_DEFAULTS = {
    "bedroom": dict(custom_steps=200, eta=1.0, batch_size=50),
    "coco": dict(custom_steps=50, eta=0.0, scale=7.5, sampler="plms",
                 batch_size=4),
}

MODEL_CONFIGS = {"bedroom": bedroom_config, "coco": sd_v1_config}

SAMPLERS = {"ddim": ldm_ddim_sample, "plms": ldm_plms_sample}


def task_config(task: str, **overrides) -> LDMTaskConfig:
    if task not in TASK_DEFAULTS:
        raise NotImplementedError(f"latent task {task!r} is not ported yet")
    kw = dict(TASK_DEFAULTS[task])
    kw.update(overrides)
    return LDMTaskConfig(task=task, **kw)


class LDMPipeline:
    """The task's model and DDIM schedule on ``device`` (the card unless
    the caller passes ``"cpu"``), random weights from ``seed``."""

    def __init__(self, cfg: LDMTaskConfig,
                 model_cfg: Optional[LatentDiffusionConfig] = None,
                 device=None, seed: int = 0):
        self.cfg = cfg
        self.qc = QC
        self.mc = model_cfg or MODEL_CONFIGS[cfg.task]()
        self.ld = LatentDiffusion(self.mc, self.qc, device=device, seed=seed)
        self.device = next(self.ld.unet.parameters()).device
        self.sched = make_ldm_schedule(
            num_timesteps=self.mc.timesteps, linear_start=self.mc.linear_start,
            linear_end=self.mc.linear_end, ddim_steps=cfg.custom_steps,
            eta=cfg.eta)
        if cfg.sampler not in SAMPLERS:
            raise NotImplementedError(f"sampler {cfg.sampler!r} is not ported yet")
        self.is_conditional = cfg.scale != 1.0 and self.mc.cond != "none"

    @torch.no_grad()
    def sample_batch(self, mode: QuantMode = DEPLOY_INT8,
                     batch_size: Optional[int] = None,
                     generator: Optional[torch.Generator] = None,
                     x_T: Optional[torch.Tensor] = None,
                     noise: Optional[Sequence[torch.Tensor]] = None,
                     decode: bool = True,
                     context: Optional[torch.Tensor] = None,
                     uncond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One batch: images (N, H, W, 3) in [0, 1], or with ``decode=False``
        the latents.  x_T and the per-step noise are drawn from
        ``generator`` unless given.  ``context`` / ``uncond``: the text
        rows of the prompts and of the empty prompt, (N, 77, context_dim)
        each (``self.ld.get_learned_conditioning``)."""
        unet = self.ld.unet
        if x_T is None:
            res = self.mc.unet.image_size
            x_T = torch.randn(batch_size or self.cfg.batch_size, res, res,
                              self.mc.unet.in_channels, generator=generator,
                              device=self.device)
        ct = next(unet.parameters()).dtype
        on = lambda c: None if c is None else c.to(self.device, ct)
        apply_fn = lambda x, t, c: self.ld.apply_model(
            x.to(ct), t, context=c, mode=mode).to(x.dtype)
        model_fn = cfg_model_fn(apply_fn, on(context), on(uncond),
                                self.cfg.scale if self.is_conditional else 1.0)
        with tf32_off():
            z = SAMPLERS[self.cfg.sampler](
                x_T, self.sched, model_fn, generator=generator, noise=noise,
                device=self.device)
            if not decode:
                return z
            img = self.ld.decode_first_stage(z)
        return torch.clamp((img + 1.0) / 2.0, 0.0, 1.0)
