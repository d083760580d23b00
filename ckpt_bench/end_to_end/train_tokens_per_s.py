"""Tokens trained in the window over the window's whole wall time: every
step's ``global_batch`` x ``seq_len`` tokens, the saves' stalls and the
steps slowed beside checkpoint work included (host clock)."""


def read(rec):
    if rec.traffic["loop"] != "train" or not rec.steps:
        return None
    return len(rec.steps) * rec.tokens_per_step / (rec.window[1] - rec.window[0])
