"""Host wall time of a UNet forward in the host-paced cell: the program's
``edm.unet.forward`` spans in the traced stretch, mean over the whole ones
(``lib/spans.py``; layer: dispatch).  It holds the spans' own cost while
tracing."""

from benchmark.lib import spans


def read(r):
    s = spans.read(r)
    return spans.mean_ms(f.end - f.start for f in s.named(spans.FORWARD)) if s else None
