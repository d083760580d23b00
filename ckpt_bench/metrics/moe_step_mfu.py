"""Model FLOPs of the window's clean steps over their synchronised
host-clock time, as a share of the card's bfloat16 peak, for a
DeepSeek-V2 configuration (``ckpt_bench.counts_deepseek_v2``): the
routed experts' FLOPs from the program's ``moe.held_slots`` counter over
the window's steps, the rest from shapes; remat's recompute not
counted. Without the counter (a program that has none) it gives
nothing."""

from ckpt_bench.counts import PEAK_FLOPS
from ckpt_bench.counts_deepseek_v2 import HELD_SLOTS, train_flops
from ckpt_bench.program_spans import collect


def read(rec):
    if rec.trace is None or not rec.steps:
        return None
    held = collect()[1].get(HELD_SLOTS)
    clean = [s["t1"] - s["t0"] for s in rec.steps if not s["beside_stage"]]
    if held is None or not clean:
        return None
    t = rec.traffic
    per_step = train_flops(rec.cfg, t["global_batch"], t["seq_len"], held / len(rec.steps))
    return 100.0 * per_step * len(clean) / sum(clean) / PEAK_FLOPS
