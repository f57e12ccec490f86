"""Checkpoint and resume of quantization state (port of
``eda_dm_tpu/utils/checkpointing.py``).

The port's quant state is the buffers of its modules; the files are
``torch.save`` archives of ``{module-qualified name: tensor}`` beside a
JSON meta file.  The JAX package writes orbax checkpoints; the two formats
do not read each other (cross-package state goes through
``models/bridge.py``).  Block reconstruction saves after every group, so an
interrupted calibration resumes after the last completed group.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn


def quant_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every buffer of the model (scales, zero-points, alphas, EMA ranges,
    integer codes), on the host."""
    return {name: b.detach().cpu() for name, b in model.named_buffers()}


def save_quant_state(path: str, model: nn.Module,
                     meta: Optional[Dict[str, Any]] = None) -> None:
    """Persist the model's quant state (and optionally metadata)."""
    path = os.path.abspath(path)
    torch.save(quant_state(model), path)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def load_quant_state(path: str, model: nn.Module) -> nn.Module:
    """Restore a saved quant state into ``model`` in place.  Buffers the
    file lacks keep their values (a file from before a buffer existed
    still loads)."""
    state = torch.load(os.path.abspath(path), map_location="cpu")
    device = next(model.parameters()).device
    with torch.no_grad():
        for name, t in state.items():
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf, t.to(device))
    return model


def save_serving_bundle(path: str, bundle: Dict[str, Any],
                        stats: Optional[Dict[str, Any]] = None) -> None:
    """Persist a :func:`~eda_dm_tpu_torch.quant.export.serving_bundle`
    artifact (packed-int4 codes and scales)."""
    path = os.path.abspath(path)
    torch.save(bundle, path)
    if stats is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(stats, f)


def load_serving_bundle(path: str, device=None, dtype=None) -> nn.Module:
    """Load a serving bundle into a new model on ``device``, serve-ready
    (DEPLOY / DEPLOY_INT8 forwards bit-identical to the in-memory
    export)."""
    from ..quant.export import restore_serving_bundle
    raw = torch.load(os.path.abspath(path), map_location="cpu", weights_only=False)
    return restore_serving_bundle(raw, device=device, dtype=dtype)


def load_meta(path: str) -> Optional[Dict[str, Any]]:
    meta_path = os.path.abspath(path) + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return None


def resumable_reconstruct(model: nn.Module, cali_data, plan, args,
                          checkpoint_dir: str, seed: int = 0, progress=None,
                          group_size: int = 1, group_window: int = 0):
    """``calib.recon.reconstruct`` with a checkpoint after every group: the
    quant state and the count of completed targets.  On restart the
    completed groups are skipped and the saved state restored (the state
    after group k fully determines group k+1's captures).  Group k draws
    from a generator seeded by the k-th of ``seed``'s per-group seeds, so a
    resumed run draws what an uninterrupted one does."""
    from ..calib.recon import group_plan, reconstruct

    os.makedirs(checkpoint_dir, exist_ok=True)
    ckpt = os.path.join(checkpoint_dir, "recon_state.pt")
    start = 0
    meta = load_meta(ckpt)
    if meta is not None and meta.get("plan_len") == len(plan):
        load_quant_state(ckpt, model)
        start = int(meta["completed"])
        if start:
            print(f"  [recon] resuming after {start}/{len(plan)} targets "
                  f"(last: {meta.get('last_target')})", flush=True)
    groups = (group_plan(plan, group_size, group_window) if group_size > 1
              else [[t] for t in plan])
    seeds = np.random.SeedSequence(seed).generate_state(len(groups), np.uint64)
    dev = cali_data[0].device
    done = 0
    for grp, s in zip(groups, seeds):
        if done + len(grp) <= start:          # completed before the restart
            done += len(grp)
            continue
        gen = torch.Generator(device=dev).manual_seed(int(s) >> 1)
        reconstruct(model, cali_data, grp, args, gen, progress=progress,
                    group_size=group_size, group_window=group_window)
        done += len(grp)
        save_quant_state(ckpt, model, meta={"completed": done, "plan_len": len(plan),
                                            "last_target": grp[-1].name})
    return model
