"""Deployment export on the port's module state (port of
``eda_dm_tpu/quant/export.py``, serving part).

The JAX package rewrites a ``variables`` tree; here the functions update a
model's ``QConv``/``QDense`` modules in place and return the model:

* :func:`fold_quantized_weights` bakes the hard-AdaRound dequantized
  weights into ``weight``;
* :func:`export_serving` folds, then casts every floating parameter to the
  serving carrier dtype (quantizer buffers stay float32);
* :func:`export_serving_int8` additionally stores, for every layer whose
  weight width gives ≤ 128 levels, the centered integer codes
  ``w{i}_int`` (int8, kernel layout) and their per-channel sums
  ``w{i}_isum`` (float32), computed from the unfolded weights.

Weight widths come from each layer's spec (the bridge checks them against
the JAX tree's ``w{i}_bits``).  The serving modes DEPLOY / DEPLOY_INT8 are
in ``quant/config.py``; DEPLOY_FUSED, which serves the ``export_serving``
weights, is re-exported here, where the JAX package defines it.

The serving bundle (:func:`serving_bundle`, :func:`restore_serving_bundle`)
is the compact deployment artifact: ``{"arch", "params", "quant"}`` with
module-qualified keys, the ≤4-bit weight codes packed two to a byte and
every leaf that is rebuilt exactly at load dropped.  It holds the leaves
the JAX package's bundle holds, so their byte counts agree.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..nn.layers import ActQuantizer, QConv, QDense
from .config import DEPLOY_FUSED, QuantConfig  # noqa: F401  (re-export)


def _quant_layers(model: torch.nn.Module):
    return [m for m in model.modules() if isinstance(m, (QConv, QDense))]


@torch.no_grad()
def fold_quantized_weights(model: torch.nn.Module, qc: QuantConfig = None):
    del qc  # widths come from the per-layer specs
    for m in _quant_layers(model):
        m.weight.data = m.folded_weight()
    return model


@torch.no_grad()
def export_serving(model: torch.nn.Module, qc: QuantConfig = None,
                   dtype: torch.dtype = torch.bfloat16):
    fold_quantized_weights(model, qc)
    for p in model.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return model


@torch.no_grad()
def export_serving_int8(model: torch.nn.Module, qc: QuantConfig = None,
                        dtype: torch.dtype = torch.bfloat16):
    codes = {m: m.weight_codes() for m in _quant_layers(model)
             if m.wq.n_levels <= 128}            # centered codes fit int8
    export_serving(model, qc, dtype)
    for m, parts in codes.items():
        for name, q, isum in parts:
            setattr(m, f"{name}_int", q)
            setattr(m, f"{name}_isum", isum)
    return model


@torch.no_grad()
def strip_alphas(model: torch.nn.Module):
    """Replace every AdaRound alpha with a ``(1,)`` placeholder in place: the
    serving modes never read them (they are consumed by the export).
    Serve-only: a calibration mode on a stripped model fails."""
    for m in _quant_layers(model):
        for name, _, _ in m._parts:
            alpha = getattr(m, f"{name}_alpha")
            setattr(m, f"{name}_alpha", torch.zeros((1,), device=alpha.device))
    return model


def pack_int4_codes(codes, zp):
    """Pack centered ≤4-bit integer codes two to a byte: codes + zp (the
    grid position q ∈ [0, 15]) low nibble first.  ``zp`` broadcasts against
    ``codes``.  Returns (1-D uint8 array of ceil(n/2) bytes, code shape)."""
    zp_i = np.asarray(zp)
    zp_int = np.rint(zp_i).astype(np.int32)
    assert np.all(zp_i == zp_int), "zero-point must be integer-valued"
    uns = np.asarray(codes, np.int32) + zp_int
    assert uns.min() >= 0 and uns.max() <= 15, \
        f"codes+zp out of nibble range: [{uns.min()}, {uns.max()}]"
    flat = uns.reshape(-1).astype(np.uint8)
    if flat.size % 2:
        flat = np.concatenate([flat, np.zeros((1,), np.uint8)])
    return flat[0::2] | (flat[1::2] << 4), uns.shape


def unpack_int4_codes(packed, shape, zp):
    """Inverse of :func:`pack_int4_codes`: centered int8 codes of ``shape``."""
    packed = np.asarray(packed, np.uint8)
    n = int(np.prod(shape))
    flat = np.empty((packed.size * 2,), np.int32)
    flat[0::2] = packed & 0xF
    flat[1::2] = packed >> 4
    zp_int = np.rint(np.asarray(zp)).astype(np.int32)
    return (flat[:n].reshape(shape) - zp_int).astype(np.int8)


def tree_nbytes(tree) -> int:
    """Total bytes of the tensors and arrays in a nested dict."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    return 0


def _families():
    from ..models.ddpm_unet import DDPMConfig, DDPMUNet
    from ..models.ldm_unet import LDMUNet, LDMUNetConfig
    return {"ddpm": (DDPMUNet, DDPMConfig), "ldm": (LDMUNet, LDMUNetConfig)}


def _arch(model) -> Dict[str, Any]:
    """The bundle's model description: the family and the configs the
    model is rebuilt from."""
    family = next((f for f, (cls, _) in _families().items()
                   if isinstance(model, cls)), None)
    if family is None:
        raise NotImplementedError(f"serving bundles of {type(model).__name__} "
                                  "are not ported")
    return {"family": family, "cfg": dataclasses.asdict(model.cfg),
            "qc": dataclasses.asdict(model.qc)}


def _zp_rows(zp: torch.Tensor, ndim: int) -> np.ndarray:
    """Per-output-channel zero-points shaped against codes ``[Cout, ...]``."""
    return zp.cpu().numpy().reshape((-1,) + (1,) * (ndim - 1))


@torch.no_grad()
def serving_bundle(model: torch.nn.Module, qc: QuantConfig = None,
                   dtype: torch.dtype = torch.bfloat16):
    """The compact deployment artifact of a calibrated model (the model is
    not changed).  From :func:`export_serving_int8` of a copy: layers with
    integer codes drop their folded weight (``codes·Δ`` at load), their
    alphas and code sums; ≤4-bit codes become ``w{i}_pack`` (uint8
    nibbles, the port's code layout ``[Cout, kh, kw, Cin]``) and
    ``w{i}_packshape``.  Folded-only layers (8-bit first/last) keep their
    weight and alphas.  Returns (bundle, stats: bundle bytes, the fp32
    model's bytes, the compression ratio)."""
    arch = _arch(model)
    serving = export_serving_int8(copy.deepcopy(model), qc, dtype)
    params, quant = {}, {}
    skip = {id(m.act_quantizer) for m in _quant_layers(serving) if m.disable_act_quant}
    for name, m in serving.named_modules():
        pre = f"{name}." if name else ""
        for pname, p in m.named_parameters(recurse=False):
            params[pre + pname] = p.detach().cpu()
        if isinstance(m, ActQuantizer) and id(m) not in skip:
            for leaf in ("delta", "zero_point", "running_min", "running_max",
                         "one_side", "inited", "a_bits"):
                quant[pre + leaf] = getattr(m, leaf).detach().cpu()
        if not isinstance(m, (QConv, QDense)):
            continue
        has_codes = m.w0_int is not None
        if has_codes:
            del params[pre + "weight"]
        for part, _, _ in m._parts:
            quant[f"{pre}{part}_bits"] = torch.tensor(m.wq.n_bits, dtype=torch.int32)
            for leaf in ("delta", "zp"):
                quant[f"{pre}{part}_{leaf}"] = getattr(m, f"{part}_{leaf}").cpu()
            if not has_codes:
                quant[f"{pre}{part}_alpha"] = getattr(m, f"{part}_alpha").cpu()
                continue
            codes = getattr(m, f"{part}_int").cpu()
            if m.wq.n_bits <= 4:
                packed, shape = pack_int4_codes(
                    codes.numpy(), _zp_rows(getattr(m, f"{part}_zp"), codes.dim()))
                quant[f"{pre}{part}_pack"] = torch.from_numpy(packed)
                quant[f"{pre}{part}_packshape"] = torch.tensor(shape, dtype=torch.int32)
            else:
                quant[f"{pre}{part}_int"] = codes
    bundle = {"arch": arch, "params": params, "quant": quant}
    fp32_bytes = 4 * sum(p.numel() for p in model.parameters())
    nbytes = tree_nbytes({"params": params, "quant": quant})
    return bundle, {"bundle_bytes": nbytes, "fp32_bytes": fp32_bytes,
                    "compression": fp32_bytes / max(nbytes, 1)}


@torch.no_grad()
def restore_serving_bundle(bundle: Dict[str, Any], device=None, dtype=None):
    """A serve-ready model on ``device`` from a :func:`serving_bundle`
    artifact: nibble codes unpacked, code sums and folded weights
    (``codes·Δ`` in float32, cast to the carrier) rebuilt, ``(1,)``
    placeholder alphas.  DEPLOY / DEPLOY_INT8 forwards are bit-identical to
    the in-memory export's."""
    arch = bundle["arch"]
    if arch["family"] not in _families():
        raise NotImplementedError(f"bundle family {arch['family']!r}")
    cls, cfg_cls = _families()[arch["family"]]
    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    model = cls(cfg_cls(**tup(arch["cfg"])), QuantConfig(**tup(arch["qc"])),
                device=device)
    dev = next(model.parameters()).device
    params, quant = bundle["params"], bundle["quant"]
    dtype = dtype or next(v.dtype for v in params.values() if v.is_floating_point())
    for name, p in model.named_parameters():
        if name in params:
            p.data = params[name].to(dev)
    for name, t in quant.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        if leaf.endswith(("_pack", "_packshape", "_bits")) or leaf == "a_bits":
            continue
        setattr(mod, leaf, t.to(dev))
    for name, m in model.named_modules():
        if not isinstance(m, (QConv, QDense)):
            continue
        pre = f"{name}." if name else ""
        if pre + "weight" in params:
            continue
        parts = []
        for part, _, _ in m._parts:
            if f"{pre}{part}_pack" in quant:
                shape = tuple(int(s) for s in quant[f"{pre}{part}_packshape"])
                codes = torch.from_numpy(unpack_int4_codes(
                    quant[f"{pre}{part}_pack"].numpy(), shape,
                    _zp_rows(quant[f"{pre}{part}_zp"], len(shape))))
            else:
                codes = quant[f"{pre}{part}_int"]
            codes = codes.to(dev).contiguous()
            setattr(m, f"{part}_int", codes)
            cf = codes.float()
            setattr(m, f"{part}_isum", cf.sum(dim=tuple(range(1, cf.dim()))))
            setattr(m, f"{part}_alpha", torch.zeros((1,), device=dev))
            w = cf * m._per_channel(getattr(m, f"{part}_delta"))
            parts.append(w.permute(0, 3, 1, 2) if w.dim() == 4 else w)
        m.weight.data = torch.cat(parts, dim=1).to(dtype)
    return model
