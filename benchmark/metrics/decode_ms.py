"""Mean time of a first-stage decode (``decode_first_stage``), CUDA events
around the program's method, over the decodes that began in the window
(layer: pipeline)."""

import statistics


def read(r):
    ms = r.window.decode_ms()
    return statistics.fmean(ms) if ms else None
