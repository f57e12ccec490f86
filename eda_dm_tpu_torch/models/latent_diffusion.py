"""LatentDiffusion: quantized LDM UNet + float32 first stage (port of
``eda_dm_tpu/models/latent_diffusion.py``, the unconditional serving part).

The JAX package holds flax module definitions and passes variable trees;
here the object holds the two modules.  Class and text conditioning, the
checkpoint loader and the other task configs come with later slices.
"""

from __future__ import annotations

import dataclasses

import torch

from ..quant.config import FP, QuantConfig, QuantMode
from .ldm_unet import LDMUNet, LDMUNetConfig
from .vae import FirstStage, VAEConfig


@dataclasses.dataclass
class LatentDiffusionConfig:
    unet: LDMUNetConfig
    vae: VAEConfig
    timesteps: int = 1000
    linear_start: float = 0.0015
    linear_end: float = 0.0195
    scale_factor: float = 1.0
    cond: str = "none"


class LatentDiffusion:
    """The UNet and the first stage on ``device`` (the card unless the
    caller passes ``"cpu"``), random weights from ``seed``."""

    def __init__(self, cfg: LatentDiffusionConfig, qc: QuantConfig,
                 device=None, seed: int = 0):
        if cfg.cond != "none":
            raise NotImplementedError(
                f"conditioning {cfg.cond!r} is not ported yet")
        self.cfg, self.qc = cfg, qc
        self.unet = LDMUNet(cfg.unet, qc, device=device, seed=seed)
        self.first_stage = FirstStage(cfg.vae, device=device, seed=seed)

    def apply_model(self, x: torch.Tensor, t: torch.Tensor, context=None,
                    mode: QuantMode = FP) -> torch.Tensor:
        return self.unet(x, t, context=context, mode=mode)

    def decode_first_stage(self, z: torch.Tensor,
                           force_not_quantize: bool = False) -> torch.Tensor:
        """z / scale_factor → first-stage decode (VQ through the codebook
        unless forced)."""
        return self.first_stage.decode(z / self.cfg.scale_factor,
                                       force_not_quantize)


def bedroom_config() -> LatentDiffusionConfig:
    """LDM-4 LSUN-Bedroom (models/ldm/lsun_beds256/config.yaml)."""
    return LatentDiffusionConfig(
        unet=LDMUNetConfig(image_size=64, in_channels=3, model_channels=224,
                           out_channels=3, num_res_blocks=2,
                           attention_resolutions=(8, 4, 2),
                           channel_mult=(1, 2, 3, 4), num_head_channels=32),
        vae=VAEConfig(ch=128, out_ch=3, ch_mult=(1, 2, 4), num_res_blocks=2,
                      attn_resolutions=(), in_channels=3, resolution=256,
                      z_channels=3, double_z=False, embed_dim=3,
                      n_embed=8192),
        linear_start=0.0015, linear_end=0.0195)
