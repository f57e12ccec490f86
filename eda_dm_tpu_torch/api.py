"""Top-level convenience API (port of ``eda_dm_tpu/api.py``).

    quantize_model(...)      → a quantization-aware model (its state inside)
    calibrate(...)           → the model with initialized scales
    reconstruct(...)         → the model with optimized rounding and scales
    export_for_serving(...)  → (serving copy, its serve mode)
    save_bundle / load_bundle → the packed deployment artifact

The JAX package returns new ``variables`` trees; here ``calibrate`` and
``reconstruct`` update the model in place and return it, and
``export_for_serving`` returns an exported copy, leaving the calibrated
model as it was.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import torch

from .calib.recon import ReconArgs, reconstruct as _reconstruct
from .calib.scale_init import set_act_quantize_params, set_weight_quantize_params
from .device import model_device
from .quant.config import DEPLOY, DEPLOY_INT8, QuantConfig, QuantMode
from .quant.export import (export_serving, export_serving_int8,
                           fold_quantized_weights, strip_alphas)


def quantize_model(model_family: str, arch=None, qc: Optional[QuantConfig] = None,
                   seed: int = 0, ckpt_path: Optional[str] = None, device=None):
    """A quantization-aware model on ``device``: ``'ddpm'`` (the pixel
    UNet) or ``'ldm'`` (the openai UNet), with N(0, 1/fan_in) weights from
    ``seed``, or a reference checkpoint's (``ckpt_path``): a DDPM state
    dict, or the UNet of a LatentDiffusion checkpoint with its
    ``model_ema.`` shadows swapped in (``load_ldm_checkpoint``)."""
    from .models.bridge import load_jax_variables
    qc = qc or QuantConfig()
    if model_family == "ddpm":
        from .models.convert import load_ddpm_checkpoint
        from .models.ddpm_unet import DDPMConfig, DDPMUNet
        model = DDPMUNet(arch or DDPMConfig(), qc, device=device, seed=seed)
        if ckpt_path:
            load_jax_variables(model, {"params": load_ddpm_checkpoint(ckpt_path)})
        return model
    if model_family == "ldm":
        from .models.convert import load_ldm_checkpoint
        from .models.ldm_unet import LDMUNet, LDMUNetConfig
        model = LDMUNet(arch or LDMUNetConfig(), qc, device=device, seed=seed)
        if ckpt_path:
            load_jax_variables(model, {"params": load_ldm_checkpoint(ckpt_path)[0]})
        return model
    raise ValueError(model_family)


def calibrate(model, cali_data: Sequence[torch.Tensor], act_batch_size: int = 256,
              device=None):
    """Weight and activation scale initialization over a calibration set."""
    set_weight_quantize_params(model, cali_data, device=device)
    return set_act_quantize_params(model, cali_data, batch_size=act_batch_size,
                                   device=device)


def reconstruct(model, cali_data: Sequence[torch.Tensor], plan=None,
                args: Optional[ReconArgs] = None,
                generator: Optional[torch.Generator] = None, mode: str = "block",
                progress=None, device=None):
    """AdaRound + FBR reconstruction over a plan: when omitted, the model
    family's block plan (``ddpm_recon_plan`` / ``ldm_recon_plan``) or, with
    ``mode='layer'``, its layer plan (``ddpm_layer_plan`` /
    ``ldm_layer_plan``)."""
    model_device(model, device)
    if plan is None:
        from .models.ddpm_unet import DDPMUNet, ddpm_layer_plan, ddpm_recon_plan
        from .models.ldm_unet import LDMUNet, ldm_layer_plan, ldm_recon_plan
        if isinstance(model, DDPMUNet):
            plan = (ddpm_recon_plan if mode == "block"
                    else ddpm_layer_plan)(model.cfg, model.qc)
        elif isinstance(model, LDMUNet):
            plan = (ldm_recon_plan if mode == "block"
                    else ldm_layer_plan)(model.cfg, model.qc)
        else:
            raise ValueError("pass an explicit plan for custom models")
    return _reconstruct(model, cali_data, plan, args or ReconArgs(), generator,
                        progress=progress)


def export_for_serving(model, qc: QuantConfig, kind: str = "int8",
                       lean: bool = True) -> Tuple[torch.nn.Module, QuantMode]:
    """Deployment export of a copy of the model; returns (copy, serve mode).
    Always forward with the returned mode.

    kind='int8' → integer weight codes for the int8 kernels, DEPLOY_INT8;
    kind='bf16' → folded weights on a bf16 carrier, DEPLOY;
    kind='fold' → folded weights at their dtype, DEPLOY.
    ``lean`` (int8 / bf16) replaces the AdaRound alphas, which serving
    never reads, with placeholders."""
    out = copy.deepcopy(model)
    if kind == "int8":
        export_serving_int8(out, qc)
        return (strip_alphas(out) if lean else out), DEPLOY_INT8
    if kind == "bf16":
        export_serving(out, qc)
        return (strip_alphas(out) if lean else out), DEPLOY
    if kind == "fold":
        return fold_quantized_weights(out, qc), DEPLOY
    raise ValueError(f"unknown export kind: {kind!r}")


def save_bundle(model, qc: QuantConfig, path: str):
    """Build and write the packed-int4 deployment artifact of a calibrated
    model; returns its size stats (bundle bytes, fp32 bytes, compression
    ratio)."""
    from .quant.export import serving_bundle
    from .utils.checkpointing import save_serving_bundle
    bundle, stats = serving_bundle(model, qc)
    save_serving_bundle(path, bundle, stats)
    return stats


def load_bundle(path: str, device=None) -> Tuple[torch.nn.Module, QuantMode]:
    """A :func:`save_bundle` artifact as a serve-ready model on ``device``:
    (model, DEPLOY_INT8), serving bit-identically to
    ``export_for_serving(kind='int8')``."""
    from .utils.checkpointing import load_serving_bundle
    return load_serving_bundle(path, device=device), DEPLOY_INT8
