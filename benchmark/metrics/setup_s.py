"""Seconds from the process's start to the window's: import, the program's
pipeline, the weights from the seed, the stand-in quant state, the
export, the kernels' build or load and the warm-up of this cell's
shapes."""


def read(r):
    return r.setup_s
