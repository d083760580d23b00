"""Model FLOPs of the window's clean steps (none beside a ``stage()``)
over their synchronised host-clock time, as a share of the card's
bfloat16 peak (``ckpt_bench.counts``: shapes only, remat's recompute
not counted)."""

from ckpt_bench.counts import PEAK_FLOPS


def read(rec):
    clean = [s["t1"] - s["t0"] for s in rec.steps if not s["beside_stage"]]
    if rec.flops_per_step is None or not clean:
        return None
    return 100.0 * rec.flops_per_step * len(clean) / sum(clean) / PEAK_FLOPS
