"""From each ``restore()`` call in the window until the restored state
is on the device (synchronised), over the number of restores (host
clock)."""


def read(rec):
    if not rec.restores:
        return None
    return sum(r["t1"] - r["t0"] for r in rec.restores) / len(rec.restores)
