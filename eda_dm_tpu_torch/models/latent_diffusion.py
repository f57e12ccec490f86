"""LatentDiffusion: quantized LDM UNet + float32 first stage + conditioner
(port of ``eda_dm_tpu/models/latent_diffusion.py``: the unconditional, the
class-conditional and the text-conditioned models).

The JAX package holds flax module definitions and passes variable trees;
here the object holds the modules.  ``cond="class"`` (ImageNet cin256-v2)
builds the ``ClassEmbedder`` as the conditioning stage: a label becomes a
one-token float32 context for the cross-attention.  Text conditioning runs
through the stand-in ``TinyTextEncoder`` (the CLIP weights are not in the
repository).  ``load_checkpoint`` grafts a reference LatentDiffusion
checkpoint through the converters of ``models/convert.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..quant.config import FP, QuantConfig, QuantMode
from .bridge import load_jax_variables
from .convert import (ldm_unet_state_dict_to_params, read_state_dict,
                      split_latent_diffusion_state_dict)
from .encoders import (ClassEmbedder, TinyTextEncoder,
                       class_embedder_state_dict_to_params)
from .ldm_unet import LDMUNet, LDMUNetConfig
from .vae import FirstStage, VAEConfig, vae_state_dict_to_params


@dataclasses.dataclass
class LatentDiffusionConfig:
    unet: LDMUNetConfig
    vae: VAEConfig
    timesteps: int = 1000
    linear_start: float = 0.0015
    linear_end: float = 0.0195
    scale_factor: float = 1.0
    cond: str = "none"            # 'none' | 'class' | 'text'
    n_classes: int = 1001         # cin256-v2.yaml: 1001 (1000 = uncond token)
    class_embed_dim: int = 512


class LatentDiffusion:
    """The UNet, the first stage and the conditioning stage (``cond="class"``
    the class embedder, ``cond="text"`` the stand-in text encoder) on
    ``device`` (the card unless the caller passes ``"cpu"``), random
    weights from ``seed``."""

    def __init__(self, cfg: LatentDiffusionConfig, qc: QuantConfig,
                 device=None, seed: int = 0):
        if cfg.cond not in ("none", "class", "text"):
            raise ValueError(f"unknown conditioning {cfg.cond!r}")
        self.cfg, self.qc = cfg, qc
        self.unet = LDMUNet(cfg.unet, qc, device=device, seed=seed)
        self.first_stage = FirstStage(cfg.vae, device=device, seed=seed,
                                      encoder=False)
        self.cond_stage = None
        if cfg.cond == "class":
            self.cond_stage = ClassEmbedder(cfg.class_embed_dim, cfg.n_classes,
                                            device=device, seed=seed)
        elif cfg.cond == "text":
            self.cond_stage = TinyTextEncoder(cfg.unet.context_dim, device=device,
                                              seed=seed)

    def load_checkpoint(self, path: str) -> "LatentDiffusion":
        """Graft a reference LatentDiffusion checkpoint in place: the UNet
        from ``model.diffusion_model.*`` (the raw weights: the ``model_ema.``
        shadows are not swapped in, as the JAX package's
        ``LatentDiffusion.load_checkpoint`` does not), the first stage's
        decode part from ``first_stage_model.*``, the class embedder from
        ``cond_stage_model.*``, and ``scale_factor`` where the checkpoint
        holds it (the ``scale_by_std`` models: church)."""
        state = read_state_dict(path)
        unet_sd, first_sd, cond_sd = split_latent_diffusion_state_dict(state)
        if "scale_factor" in state:
            self.cfg.scale_factor = float(np.asarray(state["scale_factor"]))
        load_jax_variables(self.unet, {"params": ldm_unet_state_dict_to_params(unet_sd)})
        if first_sd:
            params = vae_state_dict_to_params(first_sd)
            load_jax_variables(self.first_stage, {"params": {
                k: v for k, v in params.items() if k not in ("encoder", "quant_conv")}})
        if cond_sd and self.cfg.cond == "class":
            load_jax_variables(self.cond_stage, {
                "params": class_embedder_state_dict_to_params(cond_sd)})
        return self

    def apply_model(self, x: torch.Tensor, t: torch.Tensor, context=None,
                    mode: QuantMode = FP) -> torch.Tensor:
        return self.unet(x, t, context=context, mode=mode)

    @torch.no_grad()
    def get_learned_conditioning(self, cond) -> torch.Tensor:
        """Class labels → (B, 1, class_embed_dim), or text prompts →
        (B, 77, context_dim): float32 context rows."""
        if self.cond_stage is None:
            raise ValueError("this model takes no conditioning")
        if self.cfg.cond == "class":
            return self.cond_stage(cond)
        return self.cond_stage.encode(cond)

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


def imagenet_config() -> LatentDiffusionConfig:
    """LDM-4 class-conditional ImageNet (configs/latent-diffusion/
    cin256-v2.yaml): 64×64×3 latents, 192 channels at (1, 2, 3, 5), one
    head, a spatial transformer at the 32×32, 16×16 and 8×8 levels over a
    one-token class context of 512 (1001 labels, 1000 the unconditional
    one), the VQ-f4 first stage (embed_dim 3, 8192 codes) to 256×256."""
    return LatentDiffusionConfig(
        unet=LDMUNetConfig(image_size=64, in_channels=3, model_channels=192,
                           out_channels=3, num_res_blocks=2,
                           attention_resolutions=(8, 4, 2),
                           channel_mult=(1, 2, 3, 5), num_heads=1,
                           use_spatial_transformer=True, transformer_depth=1,
                           context_dim=512),
        vae=VAEConfig(ch=128, out_ch=3, ch_mult=(1, 2, 4), num_res_blocks=2,
                      attn_resolutions=(), in_channels=3, resolution=256,
                      z_channels=3, double_z=False, embed_dim=3, n_embed=8192),
        linear_start=0.0015, linear_end=0.0195, cond="class",
        n_classes=1001, class_embed_dim=512)


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
