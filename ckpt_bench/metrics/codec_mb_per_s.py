"""Raw bytes over the encode time of the window's saves (``SaveStats``:
``raw_bytes`` / ``encode_time``, the program's own timers): the host
chunk codec with its L1 writes."""


def read(rec):
    stats = [s["stats"] for s in rec.saves]
    if not stats:
        return None
    return sum(s.raw_bytes for s in stats) / sum(s.encode_time for s in stats) / 1e6
