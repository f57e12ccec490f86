"""The whole denoise step's share of the int8 peak: 2 × the multiply-adds
of every convolution, dense layer and attention product a step makes (the
shapes of the traced stretch, ``lib/counts.py``) over the mean step time
(CUDA events between forwards of one batch, untraced) × 1,979 TOP/s."""

import statistics

from benchmark.lib.counts import macs
from benchmark.lib.frozen import INT8_PEAK


def read(r):
    steps = r.window.inner_step_ms()
    if not r.shapes or not steps:
        return None
    ops = 2 * sum(macs(c) for c in r.shapes) / r.traced_steps
    return 100.0 * ops / (statistics.fmean(steps) * 1e-3 * INT8_PEAK)
