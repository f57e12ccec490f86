"""The 95th percentile of the times between successive UNet forward
starts over the whole window (CUDA events recorded on the stream, no
synchronise per step), batch boundaries included."""

from benchmark.lib.stats import percentile


def read(r):
    gaps = r.window.step_gaps_ms()
    return percentile(gaps, 95) if len(gaps) >= 20 else None
