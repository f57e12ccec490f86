"""Images a second: the images the window's work amounts to (finished
batches whole, the batch running at the close by the share of its UNet
forwards done, less the decode's share of a batch's time, since its
decode has not run) over the window's wall time, the card synchronised at
both ends (host clock)."""

from benchmark.lib.stats import credited_images


def read(r):
    w = r.window
    return credited_images(w.finished, w.partial, r.system.forwards_per_batch,
                           r.system.images_per_batch, w.decode_share()) / (w.t_end - w.t0)
