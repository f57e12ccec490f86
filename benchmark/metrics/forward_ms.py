"""Device ms of a UNet forward read from the program's span: the busy
device time (the union of the intervals) of the activity launched under
each whole ``edm.unet.forward`` span of the traced stretch, mean
(``lib/spans.py``; layer: model).  The idle gaps between them are left
out, since the traced host lengthens them.  ``unet_ms`` reads the same
from hooks the harness puts on the UNet, over the untraced forwards."""

from benchmark.lib import spans


def read(r):
    s = spans.read(r)
    if s is None or not s.device:
        return None
    busy = [s.device_busy_ms(f) for f in s.named(spans.FORWARD)]
    busy = [b for b in busy if b is not None]
    return sum(busy) / len(busy) if busy else None
