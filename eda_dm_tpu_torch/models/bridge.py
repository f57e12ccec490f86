"""Weight bridge between the JAX package's ``variables`` trees and the port.

:func:`from_jax_variables` takes a ``{"params": ..., "quant": ...}`` tree of
numpy arrays (a calibrated tree or an ``export_serving(_int8)`` tree, after
``jax.tree.map(np.asarray, ...)``) and loads it into a ``DDPMUNet``;
:func:`load_jax_variables` does the same for any port module whose
submodules mirror the tree.  :func:`to_jax_variables` is the inverse, so
the port's own export can be compared with the JAX export leaf by leaf.

Path rule: a flax list entry ``down_0`` / ``up_1`` / ``block_0`` /
``attn_2`` is ``down[0]`` ... here; every other name is the attribute name.
Layouts: conv kernels HWIO ↔ ``[Cout, Cin, kh, kw]``, dense kernels
``[in, out]`` ↔ ``[out, in]``, weight codes HWIO ↔ ``[Cout, kh, kw, Cin]``,
per-channel ``(1, 1, 1, Cout)`` / ``(1, Cout)`` ↔ ``(Cout,)``.  The act
quantizers' calibration state (EMA range, one-side flag) is not read.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from ..nn.layers import ActQuantizer, GNorm, QConv, QDense
from .ddpm_unet import DDPMConfig, DDPMUNet

_LIST = re.compile(r"(down|up|block|attn)_(\d+)")
_WLEAF = re.compile(r"(w\d)_(delta|zp|alpha|bits|int|isum)")
_ACT_CALIB_STATE = ("running_min", "running_max", "one_side", "inited")


def _child(module: nn.Module, name: str) -> nn.Module:
    m = _LIST.fullmatch(name)
    if m:
        return getattr(module, m.group(1))[int(m.group(2))]
    child = getattr(module, name, None)
    if not isinstance(child, nn.Module):
        raise KeyError(f"{type(module).__name__} has no submodule {name!r}")
    return child


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
    if leaf in ("alpha", "kernel"):
        return arr.t() if dense else arr.permute(3, 2, 0, 1)
    if leaf == "int":
        return arr.t() if dense else arr.permute(3, 0, 1, 2)
    return arr


def _to_jax(arr: torch.Tensor, leaf: str, dense: bool) -> torch.Tensor:
    if leaf in ("delta", "zp"):
        return arr.reshape((1, -1) if dense else (1, 1, 1, -1))
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
        if k == "kernel" and isinstance(module, (QConv, QDense)):
            t = _to_port(t, "kernel", isinstance(module, QDense))
            target = module.weight
        elif k in ("bias", "scale") and isinstance(getattr(module, k, None),
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
            if k in ("delta", "zero_point"):
                setattr(module, k, _tensor(v, device).float().reshape(()))
            elif k == "a_bits":
                if int(np.asarray(v)) != module.spec.n_bits:
                    raise ValueError(f"{path}a_bits {int(np.asarray(v))} != "
                                     f"{module.spec.n_bits}")
            elif k not in _ACT_CALIB_STATE:
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


def to_jax_variables(module: nn.Module) -> Dict[str, Any]:
    """The module's weights and serving state as a JAX-layout tree of numpy
    arrays (bf16 leaves come back as float32)."""
    params, quant = {}, {}
    for name, child in module.named_children():
        entries = ([(f"{name}_{i}", c) for i, c in enumerate(child)]
                   if isinstance(child, nn.ModuleList) else [(name, child)])
        for key, c in entries:
            sub = to_jax_variables(c)
            if sub["params"]:
                params[key] = sub["params"]
            if sub["quant"]:
                quant[key] = sub["quant"]
    if isinstance(module, ActQuantizer):
        quant.update(delta=_numpy(module.delta),
                     zero_point=_numpy(module.zero_point),
                     a_bits=np.asarray(module.spec.n_bits, np.int32))
    elif isinstance(module, GNorm):
        params.update(scale=_numpy(module.scale), bias=_numpy(module.bias))
    elif isinstance(module, (QConv, QDense)):
        dense = isinstance(module, QDense)
        params["kernel"] = _numpy(_to_jax(module.weight, "kernel", dense))
        params["bias"] = _numpy(module.bias)
        for name, _, _ in module._parts:
            quant[f"{name}_bits"] = np.asarray(module.wq.n_bits, np.int32)
            for leaf in ("delta", "zp", "alpha", "int", "isum"):
                t = getattr(module, f"{name}_{leaf}")
                if t is not None:
                    quant[f"{name}_{leaf}"] = _numpy(_to_jax(t, leaf, dense))
    return {"params": params, "quant": quant}
