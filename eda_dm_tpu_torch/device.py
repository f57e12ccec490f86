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
