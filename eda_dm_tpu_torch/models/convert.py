"""Reference checkpoint → parameter tree conversion (port of
``eda_dm_tpu/models/convert.py``).

The converters return the JAX package's flax-layout tree of float32 numpy
arrays, leaf for leaf; the port's modules mirror that tree, so
``models/bridge.py::load_jax_variables`` loads it.  Layout conventions:

* conv weight  (O, I, H, W) → kernel (H, W, I, O)
* conv1d weight (O, I, 1)   → dense kernel (I, O)
* linear weight (O, I)      → kernel (I, O)
* GroupNorm / LayerNorm weight → scale

Covers the DDPM (pixel-space) checkpoint family (the Heidelberg
``ema_cifar10`` / ``ema_lsun_*`` pickles), the openaimodel ``UNetModel``
of the latent tasks, and the LatentDiffusion wrapper (its three prefixes
and the ``model_ema.`` shadows).  Nothing is downloaded: a checkpoint is a
local file.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

# the reference's pretrained-checkpoint registry; offline, a name resolves
# to a local path under a root directory
DDPM_CKPT_NAMES = {
    "cifar10": "diffusion_cifar10_model/model-790000.ckpt",
    "ema_cifar10": "ema_diffusion_cifar10_model/model-790000.ckpt",
    "lsun_bedroom": "diffusion_lsun_bedroom_model/model-2388000.ckpt",
    "ema_lsun_bedroom": "ema_diffusion_lsun_bedroom_model/model-2388000.ckpt",
    "lsun_cat": "diffusion_lsun_cat_model/model-1761000.ckpt",
    "ema_lsun_cat": "ema_diffusion_lsun_cat_model/model-1761000.ckpt",
    "lsun_church": "diffusion_lsun_church_model/model-4432000.ckpt",
    "ema_lsun_church": "ema_diffusion_lsun_church_model/model-4432000.ckpt",
}

# published md5 digests of the Heidelberg checkpoints
DDPM_CKPT_MD5 = {
    "cifar10": "82ed3067fd1002f5cf4c339fb80c4669",
    "ema_cifar10": "1fa350b952534ae442b1d5235cce5cd3",
    "lsun_bedroom": "f70280ac0e08b8e696f42cb8e948ff1c",
    "ema_lsun_bedroom": "1921fa46b66a3665e450e42f36c2720f",
    "lsun_cat": "bbee0e7c3d7abfb6e2539eaf2fb9987b",
    "ema_lsun_cat": "646f23f4821f2459b8bafc57fd824558",
    "lsun_church": "eb619b8a5ab95ef80f94ce8a5488dae3",
    "ema_lsun_church": "fdc68a23938c2397caba4a260bc2445f",
}


def md5_hash(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def get_ckpt_path(name: str, root: str, check: bool = True) -> str:
    """Resolve and MD5-validate a pretrained DDPM checkpoint under ``root``.
    Never downloads: an absent or corrupt file raises, naming the source."""
    if "church_outdoor" in name:
        name = name.replace("church_outdoor", "church")
    if name not in DDPM_CKPT_NAMES:
        raise KeyError(f"unknown checkpoint '{name}'; "
                       f"known: {sorted(DDPM_CKPT_NAMES)}")
    path = os.path.join(root, DDPM_CKPT_NAMES[name])
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint '{name}' not found at {path}; this environment has "
            "no network egress — place the file there manually "
            "(Heidelberg heibox mirror, see reference ckpt_util.py URL_MAP)")
    if check:
        got = md5_hash(path)
        if got != DDPM_CKPT_MD5[name]:
            raise ValueError(f"md5 mismatch for {path}: got {got}, "
                             f"expected {DDPM_CKPT_MD5[name]}")
    return path


def as_numpy(val) -> np.ndarray:
    """A state-dict value (torch tensor or array) as float32 numpy."""
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu()
        val = (val.float() if val.dtype == torch.bfloat16 else val).numpy()
    return np.asarray(val, dtype=np.float32)


def _convert_leaf(key: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    leaf = key.split(".")[-1]
    if leaf == "weight":
        if value.ndim == 4:                       # conv OIHW → HWIO
            return "kernel", np.transpose(value, (2, 3, 1, 0))
        if value.ndim == 2:                       # linear OI → IO
            return "kernel", np.transpose(value, (1, 0))
        return "scale", value                     # norm weight → scale
    return leaf, value                            # bias


_DDPM_RULES = [
    (re.compile(r"^temb\.dense\.(\d+)\."), lambda m: f"temb_dense_{m.group(1)}."),
    (re.compile(r"^mid\."), lambda m: "mid_"),
    (re.compile(r"\.block\.(\d+)\."), lambda m: f".block_{m.group(1)}."),
    (re.compile(r"\.attn\.(\d+)\."), lambda m: f".attn_{m.group(1)}."),
    (re.compile(r"^down\.(\d+)\."), lambda m: f"down_{m.group(1)}."),
    (re.compile(r"^up\.(\d+)\."), lambda m: f"up_{m.group(1)}."),
    # the norms of ResnetBlock / AttnBlock are anonymous GroupNorms in flax
    (re.compile(r"\.norm1\."), lambda m: ".GroupNorm_0."),
    (re.compile(r"\.norm2\."), lambda m: ".GroupNorm_1."),
    (re.compile(r"\.norm\."), lambda m: ".GroupNorm_0."),
]


def _translate_ddpm_key(key: str) -> str:
    for pat, repl in _DDPM_RULES:
        key = pat.sub(repl, key)
    return key


def insert(tree: Dict[str, Any], path: list[str], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def ddpm_state_dict_to_params(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference DDPM ``Model`` state dict → the ``DDPMUNet`` params tree
    (numpy); ``logvar`` (the Bayesian variant's) is dropped."""
    params: Dict[str, Any] = {}
    for key, val in state_dict.items():
        if key == "logvar":
            continue
        tkey = _translate_ddpm_key(key)
        leaf, arr = _convert_leaf(tkey, as_numpy(val))
        insert(params, tkey.split(".")[:-1] + [leaf], arr)
    return params


# --------------------------------------------------------------------------
# LDM / Stable Diffusion UNet (openaimodel) and LatentDiffusion checkpoints
# --------------------------------------------------------------------------

_LDM_MERGE = [
    (re.compile(r"^time_embed\.(\d+)\."), lambda m: f"time_embed_{m.group(1)}."),
    (re.compile(r"^(input_blocks|output_blocks)\.(\d+)\.(\d+)\."),
     lambda m: f"{m.group(1)}_{m.group(2)}_{m.group(3)}."),
    (re.compile(r"^middle_block\.(\d+)\."), lambda m: f"middle_block_{m.group(1)}."),
    (re.compile(r"^out\.(\d+)\."), lambda m: f"out_{m.group(1)}."),
    (re.compile(r"\.(in_layers|out_layers|emb_layers)\.(\d+)\."),
     lambda m: f".{m.group(1)}_{m.group(2)}."),
    (re.compile(r"\.transformer_blocks\.(\d+)\."),
     lambda m: f".transformer_blocks_{m.group(1)}."),
    (re.compile(r"\.net\.0\.proj\."), lambda m: ".net_0_proj."),
    (re.compile(r"\.net\.2\."), lambda m: ".net_2."),
    (re.compile(r"\.to_out\.0\."), lambda m: ".to_out_0."),
]


def _translate_ldm_key(key: str) -> str:
    for pat, repl in _LDM_MERGE:
        key = pat.sub(repl, key)
    return key


def ldm_unet_state_dict_to_params(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference ``UNetModel`` state dict → the ``LDMUNet`` params tree.
    The legacy attention block's conv1d ``qkv`` / ``proj_out`` weights
    (O, I, 1) become dense kernels (I, O); ``label_emb.weight`` becomes
    ``label_emb.embedding``."""
    params: Dict[str, Any] = {}
    for key, val in state_dict.items():
        arr = as_numpy(val)
        parts = _translate_ldm_key(key).split(".")
        leaf = parts[-1]
        if key.startswith("label_emb."):
            leaf = "embedding"
        elif leaf == "weight":
            if arr.ndim == 4:
                leaf, arr = "kernel", np.transpose(arr, (2, 3, 1, 0))
            elif arr.ndim == 3:                       # conv1d → dense
                leaf, arr = "kernel", np.transpose(arr[..., 0], (1, 0))
            elif arr.ndim == 2:
                leaf, arr = "kernel", np.transpose(arr, (1, 0))
            else:
                leaf = "scale"                        # GroupNorm / LayerNorm
        insert(params, parts[:-1] + [leaf], arr)
    return params


def apply_ema_weights(state_dict: Mapping[str, Any], prefix: str = "model.",
                      ema_prefix: str = "model_ema."):
    """Swap the EMA shadow weights into the ``model.*`` entries of a
    checkpoint, as the reference's ``LitEma.copy_to`` does before every
    latent task quantizes.  ``LitEma`` names a parameter's shadow by the
    parameter's name with every ``.`` removed (``model_ema.<squashed>``);
    a name holding ``.model.`` is also looked up under the contracted name.
    Returns ``(new_state_dict, n_swapped)``; with no shadows the input comes
    back unchanged and ``n_swapped == 0``."""
    ema = {k[len(ema_prefix):]: v for k, v in state_dict.items()
           if k.startswith(ema_prefix)}
    if not ema:
        return dict(state_dict), 0
    out: Dict[str, Any] = {}
    n = 0
    for k, v in state_dict.items():
        if k.startswith(prefix) and not k.startswith(ema_prefix):
            pname = k[len(prefix):]
            squashed = pname.replace(".", "")
            contracted = pname.replace(".model.", ".").replace(".", "")
            if squashed in ema:
                v, n = ema[squashed], n + 1
            elif contracted in ema:
                v, n = ema[contracted], n + 1
        out[k] = v
    return out, n


def split_latent_diffusion_state_dict(state_dict: Mapping[str, Any]):
    """A LatentDiffusion checkpoint → (UNet, first stage, conditioner)
    dicts, by the ``model.diffusion_model.``, ``first_stage_model.`` and
    ``cond_stage_model.`` prefixes."""
    unet, first_stage, cond_stage = {}, {}, {}
    for k, v in state_dict.items():
        if k.startswith("model.diffusion_model."):
            unet[k[len("model.diffusion_model."):]] = v
        elif k.startswith("first_stage_model."):
            first_stage[k[len("first_stage_model."):]] = v
        elif k.startswith("cond_stage_model."):
            cond_stage[k[len("cond_stage_model."):]] = v
    return unet, first_stage, cond_stage


def read_state_dict(path: str) -> Dict[str, Any]:
    """``torch.load`` a checkpoint (tensors only) and unwrap a lightning
    ``state_dict``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return state


def load_ldm_checkpoint(path: str, use_ema: bool = True):
    """A LatentDiffusion checkpoint → (UNet params tree, first-stage state
    dict, conditioner state dict).  ``use_ema`` swaps the ``model_ema.*``
    shadows in where the checkpoint carries them."""
    state = read_state_dict(path)
    if use_ema:
        state, _ = apply_ema_weights(state)
    unet_sd, first_sd, cond_sd = split_latent_diffusion_state_dict(state)
    return ldm_unet_state_dict_to_params(unet_sd), first_sd, cond_sd


def load_ddpm_checkpoint(path: str) -> Dict[str, Any]:
    """A DDPM checkpoint file → the ``DDPMUNet`` params tree."""
    return ddpm_state_dict_to_params(read_state_dict(path))
