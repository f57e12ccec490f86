"""LatentDiffusion: quantized LDM UNet + float32 first stage + text
conditioner (port of ``eda_dm_tpu/models/latent_diffusion.py``, the
serving part of the unconditional and text-conditioned models).

The JAX package holds flax module definitions and passes variable trees;
here the object holds the modules.  Text conditioning runs through the
weightless stand-in ``TinyTextEncoder`` (the CLIP weights are not in the
repository).  Class conditioning, the checkpoint loader and the ImageNet
config come with later slices.
"""

from __future__ import annotations

import dataclasses

import torch

from ..quant.config import FP, QuantConfig, QuantMode
from .encoders import TinyTextEncoder
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
    cond: str = "none"            # 'none' | 'text'


class LatentDiffusion:
    """The UNet, the first stage and (``cond="text"``) the stand-in text
    encoder on ``device`` (the card unless the caller passes ``"cpu"``),
    random weights from ``seed``."""

    def __init__(self, cfg: LatentDiffusionConfig, qc: QuantConfig,
                 device=None, seed: int = 0):
        if cfg.cond not in ("none", "text"):
            raise NotImplementedError(
                f"conditioning {cfg.cond!r} is not ported yet")
        self.cfg, self.qc = cfg, qc
        self.unet = LDMUNet(cfg.unet, qc, device=device, seed=seed)
        self.first_stage = FirstStage(cfg.vae, device=device, seed=seed)
        self.cond_stage = (TinyTextEncoder(cfg.unet.context_dim, device=device,
                                           seed=seed)
                           if cfg.cond == "text" else None)

    def apply_model(self, x: torch.Tensor, t: torch.Tensor, context=None,
                    mode: QuantMode = FP) -> torch.Tensor:
        return self.unet(x, t, context=context, mode=mode)

    def get_learned_conditioning(self, prompts) -> torch.Tensor:
        """Text prompts → (B, 77, context_dim) float32 context rows."""
        if self.cond_stage is None:
            raise ValueError("this model takes no text conditioning")
        return self.cond_stage.encode(prompts)

    def decode_first_stage(self, z: torch.Tensor,
                           force_not_quantize: bool = False) -> torch.Tensor:
        """z / scale_factor → first-stage decode (VQ through the codebook
        unless forced; KL straight through the decoder)."""
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


def church_config() -> LatentDiffusionConfig:
    """LDM-8 LSUN-Church (models/ldm/lsun_churches256/config.yaml): 32×32
    latents of 4 channels, attention at every level with 8 heads,
    scale-shift norm and resampling res blocks, the KL-f8 first stage.
    ``scale_by_std``: the checkpoint holds the scale factor; 1.0 without
    one."""
    return LatentDiffusionConfig(
        unet=LDMUNetConfig(image_size=32, in_channels=4, model_channels=192,
                           out_channels=4, num_res_blocks=2,
                           attention_resolutions=(1, 2, 4, 8),
                           channel_mult=(1, 2, 2, 4, 4), num_heads=8,
                           use_scale_shift_norm=True, resblock_updown=True),
        vae=VAEConfig(ch=128, out_ch=3, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
                      attn_resolutions=(), in_channels=3, resolution=256,
                      z_channels=4, double_z=True, embed_dim=4, n_embed=None),
        linear_start=0.0015, linear_end=0.0155, scale_factor=1.0)


def sd_v1_config() -> LatentDiffusionConfig:
    """Stable Diffusion v1.4 (configs/stable-diffusion/v1-inference.yaml):
    the 860 M-parameter spatial-transformer UNet on 64×64×4 latents, text
    context 77×768, the KL-f8 first stage to 512×512."""
    return LatentDiffusionConfig(
        unet=LDMUNetConfig(image_size=64, in_channels=4, model_channels=320,
                           out_channels=4, num_res_blocks=2,
                           attention_resolutions=(4, 2, 1),
                           channel_mult=(1, 2, 4, 4), num_heads=8,
                           use_spatial_transformer=True, transformer_depth=1,
                           context_dim=768, legacy=False),
        vae=VAEConfig(ch=128, out_ch=3, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
                      attn_resolutions=(), in_channels=3, resolution=256,
                      z_channels=4, double_z=True, embed_dim=4, n_embed=None),
        linear_start=0.00085, linear_end=0.0120, scale_factor=0.18215,
        cond="text")
