"""The mean time of the steps that ran beside a ``stage()`` (its fused
pass and the copy of the dirty chunks to the host) over the median
clean step of the same window (host clock, synchronised)."""

import statistics


def read(rec):
    beside = [s["t1"] - s["t0"] for s in rec.steps if s["beside_stage"]]
    clean = [s["t1"] - s["t0"] for s in rec.steps if not s["beside_stage"]]
    if not beside or not clean:
        return None
    return statistics.fmean(beside) / statistics.median(clean)
