"""Weight bridge between the JAX package's ``variables`` trees and the port.

:func:`from_jax_variables` takes a ``{"params": ..., "quant": ...}`` tree of
numpy arrays (a calibrated tree or an ``export_serving(_int8)`` tree, after
``jax.tree.map(np.asarray, ...)``) and loads it into a ``DDPMUNet``;
:func:`load_jax_variables` does the same for any port module whose
submodules mirror the tree (``LDMUNet``: ``input_blocks_3_0``,
``middle_block_1``, ``time_embed_0``, ``out_2``, and in the SD UNet
``input_blocks_1_1/transformer_blocks_0/attn2/to_k``, ``.../norm1``;
``TinyTextEncoder``: ``attn_0/query``, ``ln_f``; ``ClassEmbedder``:
``embedding/embedding``; a ``num_classes`` UNet's ``label_emb/embedding``);
:func:`first_stage_from_jax`
loads the decode part of a ``FirstStage`` tree (VQ or KL).
:func:`to_jax_variables` is the inverse, so the port's own export can be
compared with the JAX export leaf by leaf.

Path rule: a name is the attribute's name; where no attribute has it, a
flax list entry ``down_0`` / ``up_1`` / ``block_0`` / ``attn_2`` is
``down[0]`` ... here.  A parameter ``weight`` is the tree's ``kernel``;
every other parameter (``bias``, ``scale``, ``codebook``, ``embedding``,
and the text encoder's ``kernel``, kept in the flax layout) keeps its
name; a bias-free dense (``to_q``) has no ``bias`` on either side.
Layouts: conv kernels HWIO ↔ ``[Cout, Cin, kh, kw]``, dense kernels
``[in, out]`` ↔ ``[out, in]``, weight codes HWIO ↔ ``[Cout, kh, kw, Cin]``,
per-channel ``(1, 1, 1, Cout)`` / ``(1, Cout)`` ↔ ``(Cout,)``.  An act
quantizer's leaves (``delta``, ``zero_point``, the calibration state
``running_min``, ``running_max``, ``one_side``, ``inited``, and ``a_bits``)
cross in both directions; a tree without the calibration state loads and
leaves the module's.  AdaRound alphas stay float32 (soft rounding trains
them); a stripped alpha (the ``(1,)`` placeholder) loads as it is.  The
quantizer of a layer whose act quantization is disabled has no leaves.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..nn.layers import ActQuantizer, QConv, QDense
from ..utils.tree import child as _child
from .ddpm_unet import DDPMConfig, DDPMUNet
from .vae import FirstStage, VAEConfig

_WLEAF = re.compile(r"(w\d)_(delta|zp|alpha|bits|int|isum)")


def _tensor(v, device) -> torch.Tensor:
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)     # a writable copy


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _to_port(arr: torch.Tensor, leaf: str, dense: bool) -> torch.Tensor:
    """JAX layout -> port layout for one weight-side leaf."""
    if leaf in ("delta", "zp"):
        return arr.reshape(-1).float()
    if leaf == "alpha" and arr.dim() == 1:               # stripped placeholder
        return arr.float()
    if leaf in ("alpha", "kernel"):
        arr = arr.t() if dense else arr.permute(3, 2, 0, 1)
        return arr.float() if leaf == "alpha" else arr
    if leaf == "int":
        return arr.t() if dense else arr.permute(3, 0, 1, 2)
    return arr


_ACT_LEAVES = {"delta": torch.float32, "zero_point": torch.float32,
               "running_min": torch.float32, "running_max": torch.float32,
               "one_side": torch.int32, "inited": torch.bool}


def _to_jax(arr: torch.Tensor, leaf: str, dense: bool) -> torch.Tensor:
    if leaf in ("delta", "zp"):
        return arr.reshape((1, -1) if dense else (1, 1, 1, -1))
    if leaf == "alpha" and arr.dim() == 1:
        return arr
    if leaf in ("alpha", "kernel"):
        return arr.t() if dense else arr.permute(2, 3, 1, 0)
    if leaf == "int":
        return arr.t() if dense else arr.permute(1, 2, 3, 0)
    return arr


def _load_params(module: nn.Module, tree: Dict[str, Any], device, seen, path):
    for k, v in tree.items():
        if isinstance(v, dict):
            _load_params(_child(module, k), v, device, seen, f"{path}{k}/")
            continue
        t = _tensor(v, device)
        weight = getattr(module, "weight", None)
        if k == "kernel" and isinstance(weight, nn.Parameter):
            t = _to_port(t, "kernel", weight.dim() == 2)
            target = weight
        elif k != "weight" and isinstance(getattr(module, k, None),
                                          nn.Parameter):
            target = getattr(module, k)
        else:
            raise KeyError(f"unexpected param leaf {path}{k}")
        if t.shape != target.shape:
            raise ValueError(f"{path}{k}: shape {tuple(t.shape)} != "
                             f"{tuple(target.shape)}")
        target.data = t.contiguous()
        seen.add(id(target))


def _load_quant(module: nn.Module, tree: Dict[str, Any], device, path):
    for k, v in tree.items():
        if isinstance(v, dict):
            _load_quant(_child(module, k), v, device, f"{path}{k}/")
            continue
        if isinstance(module, ActQuantizer):
            if k in _ACT_LEAVES:
                setattr(module, k, _tensor(v, device).to(_ACT_LEAVES[k]).reshape(()))
            elif k == "a_bits":
                if int(np.asarray(v)) != module.spec.n_bits:
                    raise ValueError(f"{path}a_bits {int(np.asarray(v))} != "
                                     f"{module.spec.n_bits}")
            else:
                raise KeyError(f"unexpected act-quant leaf {path}{k}")
            continue
        m = _WLEAF.fullmatch(k)
        if not (m and isinstance(module, (QConv, QDense))):
            raise KeyError(f"unexpected quant leaf {path}{k}")
        if m.group(2) == "bits":
            if int(np.asarray(v)) != module.wq.n_bits:
                raise ValueError(f"{path}{k} {int(np.asarray(v))} != "
                                 f"{module.wq.n_bits}")
            continue
        t = _to_port(_tensor(v, device), m.group(2), isinstance(module, QDense))
        setattr(module, k, t.contiguous())


def load_jax_variables(module: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Load a JAX ``variables`` tree (numpy leaves) into ``module`` in place.
    Every parameter of the module must be covered by the tree."""
    device = next(module.parameters()).device
    seen = set()
    with torch.no_grad():
        _load_params(module, tree["params"], device, seen, "")
        _load_quant(module, tree.get("quant", {}), device, "")
    missing = [n for n, p in module.named_parameters() if id(p) not in seen]
    if missing:
        raise KeyError(f"params missing from the tree: {missing[:5]}")
    return module


def from_jax_variables(tree: Dict[str, Any], cfg: DDPMConfig, qc,
                       device=None) -> DDPMUNet:
    """A ``DDPMUNet`` on ``device`` holding the JAX tree's weights and state."""
    return load_jax_variables(DDPMUNet(cfg, qc, device=device), tree)


def first_stage_from_jax(tree: Dict[str, Any], cfg: VAEConfig,
                         device=None, encoder: Optional[bool] = None) -> FirstStage:
    """A ``FirstStage`` on ``device`` holding a JAX ``FirstStage`` tree:
    the whole of it (``encoder``, ``quant_conv``, ``decoder``,
    ``post_quant_conv``, ``codebook``), or with ``encoder=False`` its decode
    part alone.  By default the encoder is read where the tree has it (a
    JAX ``init`` through ``decode`` makes none)."""
    params = tree["params"]
    if encoder is None:
        encoder = "encoder" in params
    if not encoder:
        params = {k: v for k, v in params.items() if k not in ("encoder", "quant_conv")}
    return load_jax_variables(FirstStage(cfg, device=device, encoder=encoder),
                              {"params": params})


def to_jax_variables(module: nn.Module) -> Dict[str, Any]:
    """The module's weights and quant state as a JAX-layout tree of numpy
    arrays (bf16 leaves come back as float32)."""
    params, quant = {}, {}
    for name, child in module.named_children():
        if name == "act_quantizer" and getattr(module, "disable_act_quant", False):
            continue                      # never called: JAX has no leaves
        entries = ([(f"{name}_{i}", c) for i, c in enumerate(child)]
                   if isinstance(child, nn.ModuleList) else [(name, child)])
        for key, c in entries:
            sub = to_jax_variables(c)
            if sub["params"]:
                params[key] = sub["params"]
            if sub["quant"]:
                quant[key] = sub["quant"]
    if isinstance(module, ActQuantizer):
        quant.update({k: _numpy(getattr(module, k)) for k in _ACT_LEAVES},
                     a_bits=np.asarray(module.spec.n_bits, np.int32))
    for name, p in module.named_parameters(recurse=False):
        if name == "weight":
            params["kernel"] = _numpy(_to_jax(p, "kernel", p.dim() == 2))
        else:
            params[name] = _numpy(p)
    if isinstance(module, (QConv, QDense)):
        dense = isinstance(module, QDense)
        for name, _, _ in module._parts:
            quant[f"{name}_bits"] = np.asarray(module.wq.n_bits, np.int32)
            for leaf in ("delta", "zp", "alpha", "int", "isum"):
                t = getattr(module, f"{name}_{leaf}")
                if t is not None:
                    quant[f"{name}_{leaf}"] = _numpy(_to_jax(t, leaf, dense))
    return {"params": params, "quant": quant}
