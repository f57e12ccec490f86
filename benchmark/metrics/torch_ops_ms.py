"""Device milliseconds a denoise step of the kernels that are not the
port's own (PyTorch's elementwise passes, norms, copies, cuBLAS and
cuDNN), by the frozen name grouping (layer: layers)."""

from benchmark.lib.frozen import hand_written


def read(r):
    if not r.trace or not r.trace["kernels"]:
        return None
    s = sum(d for n, d in r.trace["kernels"] if hand_written(n) is None)
    return s * 1e3 / r.traced_steps
