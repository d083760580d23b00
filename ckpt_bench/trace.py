"""The device trace of a run's window, reduced to what the metrics read.

``torch.profiler`` records the card's activity alone (kernels, copies,
memsets, through CUPTI): the host's operators are not recorded, so the
trace costs the window little. What the host was doing comes from the
benchmark's own spans around its calls into the program (``step``,
``stage``, ``save``, ``restore``, ...), on the same clock as the
trace's timestamps. ``reduce`` gives the seconds in which any operation
ran on the device within the window (``busy_s``), the window's length,
the device time of each operation by name, and the idle time between
device operations by the host span under it.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch


class Spans:
    """Host spans ``(label, start_ns, end_ns)`` on the wall clock that
    the profiler stamps its events with."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []
        self._offset = time.time_ns() - time.perf_counter_ns()

    def now(self) -> int:
        return time.perf_counter_ns() + self._offset

    def add(self, label: str, start: int, end: int) -> None:
        self.items.append((label, start, end))


@dataclass
class Trace:
    busy_s: float
    window_s: float
    op_s: Dict[str, float] = field(default_factory=dict)
    idle_s: Dict[str, float] = field(default_factory=dict)


def start():
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop(prof) -> list:
    """Stop ``prof``; its device events ``(start_ns, end_ns, name)``."""
    prof.__exit__(None, None, None)
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.start_ns(), e.end_ns(), e.name())
            for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]


def reduce(events: list, spans: Spans, t0: int, t1: int) -> Trace:
    op_s: Dict[str, float] = defaultdict(float)
    merged: List[List[int]] = []
    for a, b, name in sorted(events):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        op_s[name] += (b - a) / 1e9
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps, last = [], t0
    for a, b in merged:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if t1 > last:
        gaps.append((last, t1))
    idle: Dict[str, float] = defaultdict(float)
    order = sorted(spans.items, key=lambda s: s[1])
    ends = [e for _, _, e in order]
    for a, b in gaps:
        _split(a, b, order, bisect.bisect_right(ends, a), idle)
    return Trace(busy_s=busy / 1e9, window_s=(t1 - t0) / 1e9, op_s=dict(op_s), idle_s=dict(idle))


def _split(a: int, b: int, spans: list, first: int, idle: Dict[str, float]) -> None:
    """Add the idle interval [a, b) to ``idle`` by the host spans over it
    (``spans`` in order, not overlapping; ``first``: the first that ends
    after ``a``); what no span covers is ``other``."""
    covered = 0
    for i in range(first, len(spans)):
        label, s, e = spans[i]
        if s >= b:
            break
        part = min(b, e) - max(a, s)
        if part > 0:
            idle[label] += part / 1e9
            covered += part
    if b - a > covered:
        idle["other"] += (b - a - covered) / 1e9


def top(d: Dict[str, float], n: int = 10, width: int = 160) -> list:
    """The ``n`` largest entries, names cut to ``width`` characters."""
    return [[k[:width], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
