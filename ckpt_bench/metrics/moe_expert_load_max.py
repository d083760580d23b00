"""How unevenly the router loads the experts held here: the busiest held
expert's slots (the program's ``moe.held_max_slots``, summed over the
layers and the window's steps) over the mean held expert's
(``moe.held_slots`` over the experts held). 1 is an even load."""

from ckpt_bench.counts_deepseek_v2 import HELD_MAX_SLOTS, HELD_SLOTS
from ckpt_bench.program_spans import collect


def read(rec):
    if rec.trace is None:
        return None
    counts = collect()[1]
    held, busiest = counts.get(HELD_SLOTS), counts.get(HELD_MAX_SLOTS)
    if not held or busiest is None:
        return None
    m = rec.cfg["moe"]
    return busiest / (held / (m.get("n_held") or m["n_experts"]))
