"""The sampler's own host ms a step in the host-paced cell: each whole
``edm.sampler.step`` span less the ``edm.unet.forward`` spans inside it
(the update, guidance's concatenation, split and combine, and the window's
forward hooks), mean over the whole steps (``lib/spans.py``; layer:
sampler)."""

from benchmark.lib import spans


def read(r):
    s = spans.read(r)
    if s is None:
        return None
    return spans.mean_ms((st.end - st.start) - sum(f.end - f.start
                                                   for f in s.inside(st, spans.FORWARD))
                         for st in s.named(spans.STEP))
