"""The mean over the window's restores of each restore's seconds in the
decode of its stored bytes: its ``restore.base`` (a delta's base stream,
read and decoded) and ``restore.decode`` spans, the program's own
(``repro_torch.utils.telemetry``, recording while the trace runs)."""

import statistics

from ckpt_bench.program_spans import spans, within


def read(rec):
    per = within(spans(rec), "restore", ("restore.base", "restore.decode"))
    return statistics.fmean(per) if per else None
