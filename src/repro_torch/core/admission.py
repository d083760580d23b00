"""Cluster-wide flush admission control shared by co-located managers.

The seed runtime bounded its flush pipeline with a *per-manager*
``threading.BoundedSemaphore`` (``CheckpointManager._slots``), so two
managers checkpointing through one PFS could hold ``2 x
max_pending_flushes`` slots between them — exactly the
many-writers-one-PFS collision the paper's aggregation strategies
exist to avoid.  :class:`AdmissionController` replaces it: one slot
pool for every manager attached to the same storage target
(``CheckpointConfig.max_pending_flushes`` becomes a cluster-wide
budget when the control plane hands all tenants the same controller;
a private controller preserves the single-job semantics).

Priority preemption: when the pool is full and a higher-priority
tenant asks for a slot, the lowest-priority holder that registered a
``yield_fn`` is asked to give one back.  The engine's yield callback
parks its oldest *queued* (never mid-flight) flush as a journaled
``flush_partial`` — the PR-5 resumable-flush machinery — so the
preempted step loses its place in line, not its bytes, and drains
once the budget has room again.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["AdmissionController", "AdmissionSlot"]


@dataclass
class AdmissionSlot:
    """One held slot: who holds it and how it can be reclaimed."""

    owner: Any
    priority: float
    yield_fn: Optional[Callable[[], bool]]


class AdmissionController:
    """A preemptible counting semaphore over the pending-flush budget.

    ``acquire``/``release`` match the blocking semantics the engine's
    old per-manager semaphore had; ``yield_fn`` (returns True after
    parking one queued flush *and* calling :meth:`release`) is what
    makes a holder preemptible.  The condition uses an RLock so a
    victim's release — executed on the preemptor's thread, inside the
    wait loop — re-enters cleanly.
    """

    def __init__(self, total: int):
        self.total = max(1, int(total))
        self._cv = threading.Condition(threading.RLock())
        self._held: List[AdmissionSlot] = []
        self.preemptions = 0  # telemetry: slots reclaimed by priority

    # ------------------------------------------------------------- acquire

    def acquire(
        self,
        owner: Any,
        *,
        priority: float = 1.0,
        yield_fn: Optional[Callable[[], bool]] = None,
        timeout: Optional[float] = None,
    ) -> bool:
        """Block until a slot is granted (or ``timeout`` elapses).

        When the pool is full, holders with strictly lower priority
        that offered a ``yield_fn`` are asked — lowest priority first —
        to park a queued flush and return their slot before this caller
        falls back to waiting.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                if len(self._held) < self.total:
                    self._held.append(AdmissionSlot(owner, priority, yield_fn))
                    return True
                if not self._preempt_locked(priority):
                    remain: Optional[float] = None
                    if deadline is not None:
                        remain = deadline - time.monotonic()
                        if remain <= 0:
                            return False
                    # Bounded nap even with no deadline: a victim whose
                    # queue was momentarily unpreemptible (all jobs
                    # mid-flight) may become preemptible next round.
                    self._cv.wait(min(0.05, remain) if remain else 0.05)

    def try_acquire(self, owner: Any, *, priority: float = 1.0) -> bool:
        with self._cv:
            if len(self._held) < self.total:
                self._held.append(AdmissionSlot(owner, priority, None))
                return True
            return False

    def _preempt_locked(self, priority: float) -> bool:
        """Ask one strictly-lower-priority holder to yield; True if a
        slot was freed (the victim's yield path called release)."""
        victims = sorted(
            (s for s in self._held
             if s.priority < priority and s.yield_fn is not None),
            key=lambda s: s.priority,
        )
        before = len(self._held)
        for v in victims:
            try:
                if v.yield_fn() and len(self._held) < before:
                    self.preemptions += 1
                    return True
            except Exception:
                continue  # a broken victim must not wedge the pool
        return False

    # ------------------------------------------------------------- release

    def release(self, owner: Any) -> None:
        with self._cv:
            for i, s in enumerate(self._held):
                if s.owner is owner:
                    del self._held[i]
                    self._cv.notify_all()
                    return
        raise ValueError("release() without a held slot for this owner")

    # ----------------------------------------------------------- telemetry

    def held(self) -> int:
        with self._cv:
            return len(self._held)

    def available(self) -> int:
        with self._cv:
            return self.total - len(self._held)

    def snapshot(self) -> List[Tuple[str, float]]:
        with self._cv:
            return [(getattr(s.owner, "name", repr(s.owner)), s.priority)
                    for s in self._held]
