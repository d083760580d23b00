"""The mean time of the window's steps that overlap a flush (the
program's ``flush`` spans, on the flush thread) and ran beside no
``stage()``, over the median of the steps that overlap neither (host
clock, synchronised; both on ``perf_counter``)."""

import statistics

from ckpt_bench.program_spans import spans


def read(rec):
    flushes = [(s.start_ns / 1e9, s.end_ns / 1e9) for s in spans(rec)
               if s.name == "flush"]
    if not flushes:
        return None
    hit, clean = [], []
    for s in rec.steps:
        if s["beside_stage"]:
            continue
        over = any(a < s["t1"] and s["t0"] < b for a, b in flushes)
        (hit if over else clean).append(s["t1"] - s["t0"])
    if not hit or not clean:
        return None
    return statistics.fmean(hit) / statistics.median(clean)
