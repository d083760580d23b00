"""From the start of the process to the start of the window: loading,
building the kernels where a checkout has not built them yet, making
the inputs, the first steps and every warm-up (host clock)."""


def read(rec):
    return rec.setup_s
