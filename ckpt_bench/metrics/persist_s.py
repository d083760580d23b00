"""For each save, from the end of its step (host clock, after a
synchronize) to the ``subscribe`` callback of its flush reaching
``flush_done`` on the PFS, over the number of saves: the work a crash
could lose. A save whose flush never came gives no number."""


def read(rec):
    if not rec.saves or any(s.get("flush_done") is None for s in rec.saves):
        return None
    return sum(s["flush_done"] - s["step_end"] for s in rec.saves) / len(rec.saves)
