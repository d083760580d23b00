"""The program's own spans in a traced run's window, for the metrics that
read them.

``repro_torch``'s recorder (``repro_torch.utils.telemetry``) records
while a ``torch.profiler`` session runs, so a traced run's window fills
it and an untraced run leaves it empty. Its spans have ``name``,
``start_ns``, ``end_ns`` (``time.perf_counter_ns``), ``thread``, ``id``,
``parent`` and ``step``. A program without the recorder gives none, and
the metrics that read them are then left out of the line.
"""
from __future__ import annotations

import bisect
import importlib
from collections import defaultdict
from typing import Dict, List, Tuple

from ckpt_bench.trace import Spans

RECORDER = "repro_torch.utils.telemetry"

_kept: list = []
_counts: Dict[str, int] = defaultdict(int)


def recorder():
    """The program's recorder, or ``None`` where the program has none."""
    try:
        return importlib.import_module(RECORDER)
    except ModuleNotFoundError as e:
        if e.name != RECORDER:
            raise
        return None


def collect() -> Tuple[list, Dict[str, int]]:
    """Every span and the sum of each counter the recorder has handed
    over in this process: what it holds now is drained and kept here, for
    each reader to find."""
    tele = recorder()
    if tele is not None:
        got, counts = tele.drain()
        _kept.extend(got)
        for name, n in counts.items():
            _counts[name] += n
    return _kept, dict(_counts)


def spans(rec) -> list:
    """The program's spans that began in ``rec``'s traced window (on
    ``perf_counter``, as the window is); none in an untraced run."""
    if rec.trace is None:
        return []
    a, b = (int(t * 1e9) for t in rec.window)
    return [s for s in collect()[0] if a <= s.start_ns <= b]


def within(program: list, top: str, names: tuple) -> List[float]:
    """For each program span named ``top``, in order, the seconds of the
    spans under it named in ``names`` (one under another of ``names`` is
    counted with it, not again)."""
    by_id = {s.id: s for s in program}
    sums = {s.id: 0.0 for s in sorted(program, key=lambda s: s.start_ns) if s.name == top}
    for s in program:
        if s.name not in names:
            continue
        p = by_id.get(s.parent)
        while p is not None and p.name not in names and p.id not in sums:
            p = by_id.get(p.parent)
        if p is not None and p.id in sums:
            sums[p.id] += (s.end_ns - s.start_ns) / 1e9
    return list(sums.values())


def nest(spans: Spans, program: list, thread: int) -> Spans:
    """``spans`` cut by the program's spans of the loop's ``thread``: each
    part of a benchmark span that a program span covers is labelled
    ``<label>/<name>`` after the innermost program span over it; a part
    that none covers keeps its label. The program's clock is mapped onto
    the trace's by the same offset as ``spans``."""
    pieces = _innermost([(s.name, s.start_ns + spans._offset, s.end_ns + spans._offset)
                         for s in program if s.thread == thread])
    out = Spans()
    out._offset = spans._offset
    starts = [a for a, _, _ in pieces]
    for label, a, b in spans.items:
        t = a
        for i in range(max(0, bisect.bisect_right(starts, a) - 1), len(pieces)):
            s, e, name = pieces[i]
            if s >= b:
                break
            s, e = max(s, a), min(e, b)
            if e <= s:
                continue
            if s > t:
                out.add(label, t, s)
            out.add(f"{label}/{name}", s, e)
            t = e
        if b > t:
            out.add(label, t, b)
    return out


def _innermost(program: list) -> List[Tuple[int, int, str]]:
    """Spans of one thread ``(name, start, end)``, each inside any span
    it began in, as ``(start, end, name)`` pieces in order, each named
    after the innermost span over it."""
    pieces: List[Tuple[int, int, str]] = []
    stack: List[Tuple[str, int]] = []
    t = None
    for name, s, e in sorted(program, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][1] <= s:
            top, end = stack.pop()
            if end > t:
                pieces.append((t, end, top))
                t = end
        if stack and s > t:
            pieces.append((t, s, stack[-1][0]))
        stack.append((name, e))
        t = s
    while stack:
        top, end = stack.pop()
        if end > t:
            pieces.append((t, end, top))
            t = end
    return pieces
