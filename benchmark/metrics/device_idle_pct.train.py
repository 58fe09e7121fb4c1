"""The share of the traced window in which no operation ran on the
device (kernels, copies and fills, their union)."""


def read(out):
    r = out.reduced
    if r is None or r.window_s <= 0 or r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
