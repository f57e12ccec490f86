"""Mean device time of a UNet forward: CUDA events from a forward pre-hook
and a forward hook on the served UNet, over every forward of the window
outside the traced stretch (layer: model)."""

import statistics


def read(r):
    ms = r.window.unet_ms()
    return statistics.fmean(ms) if ms else None
