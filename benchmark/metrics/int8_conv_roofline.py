"""K1's share of its roofline: over its launches in the traced stretch,
the sum of each launch's least time (the larger of its operations over
the int8 peak and its bytes over the memory rate, ``lib/counts.py`` and
the frozen ``bound``) over K1's device time (``int8_conv_kernel``).  The
launches are the convs the shape hooks saw on K1's path; their number has
to equal the program's own launch count, else nothing is read."""

from benchmark.lib.counts import k1_bytes, k1_calls, macs
from benchmark.lib.frozen import INT8_PEAK, bound, hand_written


def read(r):
    if not r.trace:
        return None
    calls = k1_calls(r.shapes)
    device_s = sum(d for n, d in r.trace["kernels"] if hand_written(n) == "int8_conv_kernel")
    if not calls or len(calls) != r.launches.get("int8_conv", 0) or device_s <= 0:
        return None
    least_ms = sum(bound(k1_bytes(c), 2 * macs(c), INT8_PEAK)[0] for c in calls)
    return 100.0 * least_ms * 1e-3 / device_s
