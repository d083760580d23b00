"""The time the loop spent inside ``stage()`` and ``save()`` in the
window, over the number of saves (host clock, from the loop's side)."""


def read(rec):
    if not rec.saves:
        return None
    return sum(s["block_s"] for s in rec.saves) / len(rec.saves)
