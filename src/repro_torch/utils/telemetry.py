"""Spans and counters of the port's own work, kept in memory, off by default.

A span is one interval of work on one thread: its name, its start and
end on ``time.perf_counter_ns()``, the thread (``threading.get_ident()``),
its own id, the id of the span open on the same thread when it began
(``parent``, else ``None``) and, where the call site has it as a host
integer, the checkpoint step. A counter is a named integer sum.

The recorder is on after :func:`enable` and while a ``torch.profiler``
session runs (the spans then label that trace's idle time): no
environment variable, flag or config field switches it. :func:`drain`
hands over and forgets what was recorded. While the recorder is off,
:func:`span` returns one shared no-op context and :func:`count` returns
at once, after a check of two module-level flags.
A :class:`Timer` always reads the clock, for the stats fields that carry
an interval's seconds (``SaveStats.encode_time``, ``ReadResult.duration``,
...), and, where it has a name, records the same interval as a span
while the recorder is on: one pair of clock reads serves both. The buffer holds the newest
``MAX_SPANS`` spans, so a job that leaves the recorder on stays bounded.

No device tensor is read to label a span: a train step's spans carry no
step id, since its step counter lives on the device. Counters computed on
the device (:func:`count_device`: the dropless MoE layers' routing
counts) are added up there, one small add a call, and read back once, by
:func:`drain`: nothing in a step waits for them.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from time import perf_counter_ns
from typing import Dict, List, NamedTuple, Optional, Tuple

# ``_is_profiler_enabled`` is the flag torch keeps for fast checks: true
# from a profiler's start to its stop
import torch
from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 16


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: Optional[int]
    step: Optional[int]


_on = False
_spans: "deque[Span]" = deque(maxlen=MAX_SPANS)
_counts: Dict[str, int] = {}
_counts_lock = threading.Lock()
_device_counts: Dict[Tuple[str, ...], "torch.Tensor"] = {}
_ids = itertools.count(1)
_local = threading.local()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    """Whether spans and counters are recorded: after :func:`enable`, or
    while a ``torch.profiler`` session runs."""
    return _on or _profiler._is_profiler_enabled


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """The spans (in the order they ended) and counters recorded since
    the last drain; the recorder keeps neither."""
    spans: List[Span] = []
    while True:
        try:
            spans.append(_spans.popleft())
        except IndexError:
            break
    with _counts_lock:
        counts = dict(_counts)
        _counts.clear()
        held = list(_device_counts.items())
        _device_counts.clear()
    for names, total in held:
        for name, n in zip(names, total.tolist()):
            counts[name] = counts.get(name, 0) + int(n)
    return spans, counts


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``."""
    if not (_on or _profiler._is_profiler_enabled):
        return
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def count_device(names: Tuple[str, ...], values: "torch.Tensor") -> None:
    """Add ``values`` (an integer tensor of ``len(names)`` entries, on any
    device) to the counters ``names``, on that device: no read back
    until :func:`drain`."""
    if not (_on or _profiler._is_profiler_enabled):
        return
    with _counts_lock:
        total = _device_counts.get(names)
        _device_counts[names] = (values.detach().to(torch.int64) if total is None
                                 else total + values.detach())


def _stack() -> List[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Timer:
    """One interval on ``perf_counter_ns`` (``seconds`` once the ``with``
    block has ended), recorded as a span when it has a ``name`` and the
    recorder is on as it begins and as it ends; without a name, a clock
    alone."""

    __slots__ = ("name", "step", "start_ns", "end_ns", "_id", "_parent")

    def __init__(self, name: Optional[str] = None, step: Optional[int] = None):
        self.name, self.step = name, step
        self.start_ns = self.end_ns = 0
        self._id: Optional[int] = None
        self._parent: Optional[int] = None

    def __enter__(self) -> "Timer":
        if self.name is not None and (_on or _profiler._is_profiler_enabled):
            stack = _stack()
            self._parent = stack[-1] if stack else None
            self._id = next(_ids)
            stack.append(self._id)
        self.start_ns = perf_counter_ns()
        return self

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __exit__(self, *exc) -> bool:
        self.end_ns = perf_counter_ns()
        if self._id is not None:
            _stack().pop()
            if _on or _profiler._is_profiler_enabled:
                _spans.append(Span(self.name, self.start_ns, self.end_ns,
                                   threading.get_ident(), self._id, self._parent,
                                   self.step))
        return False


class _Off:
    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP = _Off()


def span(name: str, step: Optional[int] = None):
    """A context that records ``name`` as a span while the recorder is
    on; the shared :data:`NOOP` while it is off."""
    if not (_on or _profiler._is_profiler_enabled):
        return NOOP
    return Timer(name, step)
