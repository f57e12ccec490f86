"""Host ms a forward inside the op wrappers in the host-paced cell: the
outermost ``edm.op.*`` spans inside each whole ``edm.unet.forward`` (the
checks, plans, ``ctypes`` and the launch of each of the port's kernels, or
the plain route's work), summed, over the whole forwards (``lib/spans.py``;
layer: dispatch)."""

from benchmark.lib import spans


def read(r):
    s = spans.read(r)
    if s is None:
        return None
    fwd = s.named(spans.FORWARD)
    total = sum(o.end - o.start for f in fwd for o in s.inside(f, spans.OP))
    return spans.ms_per(total * 1e-9, len(fwd))
