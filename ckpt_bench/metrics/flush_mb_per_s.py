"""Bytes written to the PFS over the flushes' durations (``FlushResult``
of the window's saves, the program's own timers)."""


def read(rec):
    flushes = [s["stats"].flush for s in rec.saves if s["stats"].flush is not None]
    if not flushes:
        return None
    return sum(f.bytes_written for f in flushes) / sum(f.duration for f in flushes) / 1e6
