"""The routed experts' grouped products against the card's bfloat16
peak: their FLOPs in the window (``counts_deepseek_v2.grouped_mm_flops``
of the program's ``moe.held_slots``: forward, remat's recompute and
both backward products) over the device time of the grouped-product
kernels in the trace: ``torch._grouped_mm``'s CUTLASS kernels for the
H100 (``GemmUniversal<GroupProblemShape<...>, ...>``), whose names, as
the trace prints them (mangled), carry ``KERNEL``."""

from ckpt_bench.counts import PEAK_FLOPS
from ckpt_bench.counts_deepseek_v2 import HELD_SLOTS, grouped_mm_flops
from ckpt_bench.program_spans import collect

KERNEL = "GroupProblemShape"


def read(rec):
    if rec.trace is None:
        return None
    held = collect()[1].get(HELD_SLOTS)
    secs = sum(t for name, t in rec.trace.op_s.items() if KERNEL in name)
    if not held or secs <= 0:
        return None
    return 100.0 * grouped_mm_flops(rec.cfg, held) / secs / PEAK_FLOPS
