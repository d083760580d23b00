"""Bytes read from the PFS over the reads' durations (``ReadResult`` of
the window's restores, the program's own timers)."""


def read(rec):
    reads = [r["read"] for r in rec.restores if r["read"] is not None]
    if not reads:
        return None
    return sum(r.bytes_read for r in reads) / sum(r.duration for r in reads) / 1e6
