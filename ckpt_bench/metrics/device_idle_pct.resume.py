"""The share of the traced window in which no operation ran on the
device (kernels, copies, memsets), in a resume cell."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
