"""Device idle ms a forward that the host's forward leaves in the
host-paced cell: the traced stretch's idle gaps that began while the host
was inside a whole ``edm.unet.forward`` span, summed, over the whole
forwards (``lib/spans.py``; layer: device).  The rest of the stretch's idle
time began between forwards: in the sampler, guidance and the harness."""

from benchmark.lib import spans


def read(r):
    s = spans.read(r)
    if s is None or not s.gaps:
        return None
    fwd = s.named(spans.FORWARD)
    return spans.ms_per(s.idle_in(fwd), len(fwd))
