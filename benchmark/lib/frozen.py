"""Frozen copies of the yardstick's arithmetic, taken from ``chip_smoke.py``
at commit 34da27b (the port's smoke run on the H100).  Later changes to
that script or to the port do not move them.

* ``bound`` (``chip_smoke.bound``): the least time of a kernel, the larger
  of its bytes over the memory rate and its operations over their peak;
* ``HAND_WRITTEN`` and ``hand_written`` (the name grouping of
  ``chip_smoke.profile_forward``): the port's own kernels, each name
  matched where it starts a word, so cuBLAS's ``..._align..._kernel`` is no
  ``gn_kernel``;
* the H100 SXM data sheet's peaks at 700 W (``chip_smoke.INT8_PEAK``,
  ``BF16_PEAK``, ``F32_PEAK``, ``HBM``).
"""

from __future__ import annotations

import re
from typing import Optional

INT8_PEAK, BF16_PEAK, F32_PEAK, HBM = 1979e12, 989e12, 67e12, 3.35e12

HAND_WRITTEN = ("int8_conv_kernel", "int8_bmm_nt_kernel", "softmax_codes_kernel",
                "int8_attention_kernel", "int8_flash_attention_kernel",
                "int8_flash_sweep_kernel", "gn_kernel", "fakequant_matmul")

_PATTERNS = [(n, re.compile(rf"(?<!\w){n}")) for n in HAND_WRITTEN]


def bound(nbytes: float, ops: float, peak: float, other_ms: float = 0.0):
    """(ms, "bytes" | "operations"): the larger of bytes over the memory
    rate and operations over their peak (``other_ms``: a further operation
    time, e.g. the exponentials)."""
    tb, to = nbytes / HBM * 1e3, max(ops / peak * 1e3, other_ms)
    return (tb, "bytes") if tb >= to else (to, "operations")


def hand_written(kernel_name: str) -> Optional[str]:
    """The port's kernel a device kernel's name belongs to, or None."""
    for name, pat in _PATTERNS:
        if pat.search(kernel_name):
            return name
    return None
