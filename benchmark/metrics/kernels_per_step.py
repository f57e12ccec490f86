"""Device kernels a denoise step: the kernels the profiler saw launched in
the traced stretch over its steps (layer: dispatch)."""


def read(r):
    if not r.trace or not r.trace["kernels"]:
        return None
    return len(r.trace["kernels"]) / r.traced_steps
