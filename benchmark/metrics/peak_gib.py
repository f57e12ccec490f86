"""``torch.cuda.max_memory_allocated()`` over the window (reset at its
start, decode included), in GiB."""


def read(r):
    return r.window.peak / 2 ** 30 if r.window.peak else None
