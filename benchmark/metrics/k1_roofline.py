"""K1's share of its roofline from the program's own launch record: over
the K1 launches that ``ops/_build.py::launch_record`` holds for the traced
stretch, the sum of each launch's least time (the larger of its operations
over the int8 peak and its bytes over the memory rate, ``lib/counts.py``
and the frozen ``bound``) over K1's device time (``int8_conv_kernel``).
``int8_conv_roofline``'s formula, with no hooks.  The record has to hold as
many K1 launches as the trace holds K1 kernels, else nothing is read."""

import sys

from benchmark.lib.counts import conv_macs, k1_bytes
from benchmark.lib.frozen import INT8_PEAK, bound, hand_written


def read(r):
    if not r.trace:
        return None
    try:
        from eda_dm_tpu_torch.ops._build import launch_record
    except ImportError:                      # a program without the record
        return None
    calls = [c for k, c in launch_record if k == "int8_conv"]
    k1 = [d for n, d in r.trace["kernels"] if hand_written(n) == "int8_conv_kernel"]
    print(f"k1_roofline: {len(calls)} K1 launches in the record, "
          f"{r.launches.get('int8_conv', 0)} in launch_counts' delta, {len(k1)} K1 kernels "
          "in the trace", file=sys.stderr)
    if not calls or len(calls) != len(k1) or sum(k1) <= 0:
        return None
    least_ms = sum(bound(k1_bytes(c), 2 * conv_macs(c["n"], c["ho"], c["wo"], c["cout"],
                                                    c["kh"], c["kw"], c["cin"]), INT8_PEAK)[0]
                   for c in calls)
    return 100.0 * least_ms * 1e-3 / sum(k1)
