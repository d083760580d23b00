"""The mean over the window's restores of each restore's seconds in
placing the decoded leaves on the device (its ``restore.place`` span, the
program's own: pageable copies from the host to the card)."""

import statistics

from ckpt_bench.program_spans import spans, within


def read(rec):
    per = within(spans(rec), "restore", ("restore.place",))
    return statistics.fmean(per) if per else None
