"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  With no
card and no explicit ``"cpu"`` they raise: a serving or measurement path
never carries on silently on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the host")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device")
    return device


def model_device(model: torch.nn.Module, device=None) -> torch.device:
    """Resolve ``device`` as :func:`resolve_device` does and check that the
    model's parameters live there; returns the device."""
    device = resolve_device(device)
    here = next(model.parameters()).device
    if here.type != device.type:
        raise RuntimeError(f"the model is on {here}, not on {device}")
    return here
