"""The share of the traced stretch (first kernel's start to last kernel's
end, device clock) in which no kernel, copy or set ran (layer: device)."""


def read(r):
    if not r.trace or r.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
