"""Parameter trees → state dicts in the reference's layout: the inverse of
the converters of ``models/convert.py``, ``models/vae.py`` and
``models/encoders.py``.

Each function takes a flax-layout tree of numpy arrays (from
``models/bridge.py::to_jax_variables``, or a JAX ``init``) and returns a
dict of float32 CPU tensors named and shaped as the reference's modules
name and shape them, ready for ``torch.save``:

* ``ddpm_state_dict``: a DDPM ``Model`` (``temb.dense.0``, ``down.0.block.1``,
  ``mid.block_1``; the anonymous ``GroupNorm_0`` / ``GroupNorm_1`` become
  ``norm1`` / ``norm2`` in a res block and ``norm`` in an attention block);
* ``ldm_unet_state_dict``: an openaimodel ``UNetModel`` (the legacy
  attention block's ``qkv`` / ``proj_out`` as conv1d (O, I, 1), the spatial
  transformer's ``proj_in`` / ``proj_out`` as 1×1 conv2d);
* ``vae_state_dict``: a taming VQ / KL autoencoder;
* ``class_embedder_state_dict`` and ``bert_state_dict``;
* ``latent_diffusion_state_dict``: the LatentDiffusion wrapper, its parts
  under ``model.diffusion_model.``, ``first_stage_model.`` and
  ``cond_stage_model.``, optional ``model_ema.`` shadows under
  ``LitEma``'s squashed names, and ``scale_factor``.

The tests and ``chip_smoke.py`` write checkpoints with it; no serving path
calls it.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


def _leaves(tree: Dict[str, Any], path=()) -> Iterator[Tuple[List[str], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield list(path + (k,)), np.asarray(v, np.float32)


def _weight(leaf: str, arr: np.ndarray, conv1d: bool = False):
    """A flax leaf → (the reference's leaf name, its array)."""
    if leaf == "kernel":
        if arr.ndim == 4:                                  # HWIO → OIHW
            return "weight", np.transpose(arr, (3, 2, 0, 1))
        arr = np.transpose(arr, (1, 0))                    # IO → OI
        return "weight", arr[..., None] if conv1d else arr
    if leaf in ("scale", "embedding"):
        return "weight", arr
    return leaf, arr


def _tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32))     # a writable copy


def ddpm_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``DDPMUNet`` params tree → a reference DDPM ``Model`` state dict."""
    out = {}
    for path, arr in _leaves(params):
        names: List[str] = []
        for i, p in enumerate(path[:-1]):
            m = re.fullmatch(r"(temb_dense|down|up|block|attn)_(\d+)", p)
            if i == 0 and p.startswith("mid_"):
                names += ["mid", p[4:]]
            elif m:
                names += m.group(1).split("_") + [m.group(2)]
            elif p in ("GroupNorm_0", "GroupNorm_1"):
                in_block = re.fullmatch(r"(mid_)?block_\d+", path[i - 1])
                names.append(("norm1", "norm2")[int(p[-1])] if in_block else "norm")
            else:
                names.append(p)
        leaf, arr = _weight(path[-1], arr)
        out[".".join(names + [leaf])] = _tensor(arr)
    return out


_LDM_ELEMENT = [
    (re.compile(r"(time_embed|middle_block)_(\d+)"), r"\1.\2"),
    (re.compile(r"(input_blocks|output_blocks)_(\d+)_(\d+)"), r"\1.\2.\3"),
    (re.compile(r"(in_layers|out_layers|emb_layers|transformer_blocks)_(\d+)"), r"\1.\2"),
    (re.compile(r"net_0_proj"), "net.0.proj"),
    (re.compile(r"net_2"), "net.2"),
    (re.compile(r"to_out_0"), "to_out.0"),
]


def ldm_unet_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """An ``LDMUNet`` params tree → a reference ``UNetModel`` state dict."""
    out = {}
    for path, arr in _leaves(params):
        names = []
        for i, p in enumerate(path[:-1]):
            if i == 0 and re.fullmatch(r"out_\d+", p):
                names.append(p.replace("_", "."))
                continue
            for pat, repl in _LDM_ELEMENT:
                if pat.fullmatch(p):
                    p = pat.sub(repl, p)
                    break
            names.append(p)
        # the legacy attention block's qkv / proj_out are conv1d; the spatial
        # transformer's proj_out is a 1×1 conv2d (a 4-d kernel)
        conv1d = path[-2] in ("qkv", "proj_out") and arr.ndim == 2
        leaf, arr = _weight(path[-1], arr, conv1d)
        out[".".join(names + [leaf])] = _tensor(arr)
    return out


def vae_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``FirstStage`` params tree (VQ or KL; the encoder where the tree
    has it) → a reference autoencoder state dict."""
    out = {}
    for path, arr in _leaves(params):
        if path == ["codebook"]:
            out["quantize.embedding.weight"] = _tensor(arr)
            continue
        names = [path[0]]
        for p in path[1:-1]:
            m = re.fullmatch(r"(down|up)_(\d+)_(block|attn)_(\d+)", p)
            s = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", p)
            if m:
                names += list(m.groups())
            elif s:
                names += list(s.groups()) + ["conv"]
            elif p.startswith("mid_"):
                names += ["mid", p[4:]]
            else:
                names.append(p)
        leaf, arr = _weight(path[-1], arr)
        out[".".join(names + [leaf])] = _tensor(arr)
    return out


def class_embedder_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``ClassEmbedder`` params tree → the reference's state dict."""
    return {"embedding.weight": _tensor(params["embedding"]["embedding"])}


def bert_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``BERTEmbedder`` params tree → the reference's state dict
    (``transformer.*``: x_transformers' ``TransformerWrapper`` with its
    ``attn_layers.layers.<j>.<0 norm | 1 block>`` entries and the
    feed-forward's ``net.0.0`` / ``net.2`` linears)."""
    pre, lay = "transformer.", "transformer.attn_layers.layers."
    out = {pre + "token_emb.weight": params["token_emb"]["embedding"],
           pre + "pos_emb.emb.weight": params["pos_emb"]["embedding"],
           pre + "norm.weight": params["norm"]["scale"],
           pre + "norm.bias": params["norm"]["bias"]}
    for name, node in params.items():
        m = re.fullmatch(r"(norm|attn|ff)_(\d+)(?:_(\w+))?", name)
        if not m:
            continue
        kind, j, part = m.group(1), m.group(2), m.group(3)
        if kind == "norm":
            out[f"{lay}{j}.0.weight"] = node["scale"]
            out[f"{lay}{j}.0.bias"] = node["bias"]
            continue
        mod = {"q": "to_q", "k": "to_k", "v": "to_v", "out": "to_out",
               "1": "net.0.0", "2": "net.2"}[part]
        out[f"{lay}{j}.1.{mod}.weight"] = np.transpose(node["kernel"])
        if "bias" in node:
            out[f"{lay}{j}.1.{mod}.bias"] = node["bias"]
    return {k: _tensor(np.asarray(v)) for k, v in out.items()}


def latent_diffusion_state_dict(unet: Dict[str, Any],
                                first_stage: Optional[Dict[str, Any]] = None,
                                cond_stage: Optional[Dict[str, Any]] = None,
                                ema_unet: Optional[Dict[str, Any]] = None,
                                scale_factor: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """A reference LatentDiffusion checkpoint's state dict from the parts'
    params trees.  ``ema_unet``: the EMA weights, stored as ``LitEma``
    stores them (``model_ema.<name with its dots removed>`` for every
    ``model.<name>``, and the ``decay`` / ``num_updates`` buffers).
    ``cond_stage``: a ``ClassEmbedder`` tree."""
    out = {f"model.diffusion_model.{k}": v for k, v in ldm_unet_state_dict(unet).items()}
    if first_stage is not None:
        out.update({f"first_stage_model.{k}": v
                    for k, v in vae_state_dict(first_stage).items()})
    if cond_stage is not None:
        out.update({f"cond_stage_model.{k}": v
                    for k, v in class_embedder_state_dict(cond_stage).items()})
    if ema_unet is not None:
        out["model_ema.decay"] = torch.tensor(0.9999)
        out["model_ema.num_updates"] = torch.tensor(0, dtype=torch.int32)
        for k, v in ldm_unet_state_dict(ema_unet).items():
            out["model_ema." + f"diffusion_model.{k}".replace(".", "")] = v
    if scale_factor is not None:
        out["scale_factor"] = torch.tensor(float(scale_factor))
    return out
