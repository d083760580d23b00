"""Real filesystem executor: runs FlushPlans against actual files.

Directory layout (``root`` is the checkpoint root):

.. code-block:: text

    root/
      local/node_{j}/step_{s}/rank_{r}.blob      # L1 node-local files
      local/node_{j}/step_{s}/rank_{r}.partner   # optional peer replica
      local/manifests/step_{s}.json              # manifest @ local_done
      pfs/step_{s}/<plan files>                  # L2 aggregated/unaggregated
      pfs/step_{s}/manifest.json                 # manifest @ flush_done

"Network sends" in a single-process harness are leader-side reads of the
source node's L1 file — the executor never touches the in-memory blobs
during the flush, so the flush path exercises exactly what a distributed
deployment would: node-local read -> (ship) -> pwrite at the planned
offset of the shared file.

Fault injection: the canonical surface is a seeded
:class:`~repro_torch.core.faults.FaultPlan` (``faults=`` on this executor and
on :class:`LocalStore`) scheduling faults at exact op indices per
domain; the legacy ``fault_hook(write_item)`` callback survives for
targeted tests and may still raise to simulate an active-backend crash
mid-flush.  Either way, partially written PFS state is left behind with
the manifest still at ``local_done``/``flush_partial`` — restart logic
must (and does, see tests) fall back to L1 or resume from the journal.

Transient-fault tolerance: every raw blob/extent I/O can be wrapped in
a :class:`RetryPolicy` — errno-classified transient failures
(:func:`classify_error`) are retried with bounded exponential backoff
+ deterministic jitter under a per-op deadline, sleeping through
``CancelToken.wait`` so a superseded flush cancels mid-backoff.
Retry/giveup counts surface in :class:`FlushResult`/:class:`ReadResult`.
Permanent failures propagate unchanged, so a failed flush keeps its
journal and stays resumable.  L1 blob reads that still fail after
retries are re-raised as structured :class:`StorageError`\\ s carrying
``(level, step, rank, path)`` so ladder-fallback logs say exactly
which copy failed and why.

The read side mirrors the write side: :meth:`RealExecutor.
execute_read_plan` runs a columnar :class:`~repro_torch.core.plan.ReadPlan`
as ranged ``pread``\\ s through the same work-stealing thread pool, so
aggregated checkpoints are *read* as aggregated files — full elastic
restores, reshards and partial (per-leaf) restores all go through one
plan instead of per-rank whole-blob loops.

Adaptive flush runtime primitives (engine-facing; see
docs/OPERATIONS.md for the lifecycle):

* :class:`CancelToken` — cooperative cancellation, checked by the
  executor at *safe request boundaries* (between writes, never inside
  one), raising :class:`FlushCancelled`;
* :class:`TokenBucket` — a global byte-rate limiter the engine hangs on
  executor writes so the background drain does not steal the
  application's NIC share (the ``flush_bw_cap`` / ``app_net_load``
  policy, priced identically by :mod:`repro_torch.core.sim`);
* :class:`FlushJournal` — an append-only *columnar* progress cursor
  (little-endian int64 ``(file_id, file_offset, size)`` triples)
  persisted next to the manifest: every completed destination extent is
  journaled, so a flush interrupted by ``close()``, a fault hook or
  process death resumes from the last completed extent
  (:meth:`RealExecutor.execute_resume`) instead of rewriting the whole
  checkpoint.
"""
from __future__ import annotations

import errno
import os
import random
import shutil
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor, as_completed
from concurrent.futures import wait as futures_wait
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.plan import (
    FileLayout,
    FlushPlan,
    ReadPlan,
    WriteColumns,
    WriteItem,
    build_read_plan,
    coalesce_write_columns,
    merge_intervals,
)
from repro_torch.core.faults import FaultPlan, inject_write
from repro_torch.core.serialize import Manifest, Placement
from repro_torch.utils import telemetry


class FlushCancelled(Exception):
    """An executing flush observed its :class:`CancelToken` fired.

    Deliberately *not* an ``IOError``: the engine treats cancellation
    (supersession, ``close()`` deadline) as a scheduling outcome, not a
    flush failure — it must never land in ``flush_errors``.
    """


class CancelToken:
    """Cooperative cancellation for one in-flight flush.

    The executor polls :attr:`cancelled` at safe request boundaries
    (before each coalesced write row) and while sleeping in the rate
    limiter, so cancellation latency is one write (or one throttle
    tick), never a partial ``pwrite``.
    """

    __slots__ = ("_ev",)

    def __init__(self) -> None:
        self._ev = threading.Event()

    def cancel(self) -> None:
        self._ev.set()

    @property
    def cancelled(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: float) -> bool:
        return self._ev.wait(timeout)


#: errno values classified transient: the storage under us hiccuped but
#: a retried attempt can plausibly succeed.  Everything else (ENOSPC,
#: ENOENT, EACCES, EROFS, errno-less IOErrors, ...) is permanent.
TRANSIENT_ERRNOS = frozenset(
    {
        errno.EIO,
        errno.EAGAIN,
        errno.EINTR,
        errno.EBUSY,
        errno.ETIMEDOUT,
        errno.ESTALE,
        errno.ECONNRESET,
        errno.ENETRESET,
    }
)


def classify_error(e: BaseException) -> str:
    """``"transient"`` or ``"permanent"`` for one I/O exception.

    Only ``OSError``\\ s with an errno in :data:`TRANSIENT_ERRNOS` are
    transient; an errno-less ``IOError`` (e.g. a test's injected
    backend crash) is deliberately permanent so legacy ``fault_hook``
    semantics — one raise fails the flush — are preserved.
    """
    if isinstance(e, OSError) and e.errno in TRANSIENT_ERRNOS:
        return "transient"
    return "permanent"


class StorageError(OSError):
    """A blob/extent I/O failure with full ladder attribution.

    Carries ``(level, step, rank, path)`` so restore-ladder fallback
    log lines say exactly which copy failed and why, instead of a bare
    ``[Errno 2] No such file or directory``.  Subclasses ``OSError``
    (errno preserved from the cause) so every existing
    ``except OSError`` fallback keeps working.
    """

    def __init__(self, level: str, step: int, rank: int, path, cause=None):
        eno = cause.errno if isinstance(cause, OSError) else None
        msg = (
            f"{level} copy failed: step {step} rank {rank} at {path}"
            f" ({cause if cause is not None else 'unknown error'})"
        )
        super().__init__(eno, msg)
        self.level = level
        self.step = int(step)
        self.rank = int(rank)
        self.path = str(path)
        self.filename = str(path)

    def __str__(self) -> str:  # no "[Errno n] msg: path" re-assembly
        return self.args[1] if len(self.args) > 1 else super().__str__()


class MissingBlobError(StorageError, FileNotFoundError):
    """A :class:`StorageError` whose cause was a missing file — also a
    ``FileNotFoundError`` so existence-based fallbacks still match."""


def wrap_storage_error(level: str, step: int, rank: int, path, cause) -> StorageError:
    cls = (
        MissingBlobError
        if isinstance(cause, FileNotFoundError)
        else StorageError
    )
    return cls(level, step, rank, path, cause)


class CircuitOpenError(OSError):
    """Fail-fast: the storage domain's circuit breaker is open.

    Raised *before* the raw op is attempted, so an unavailable domain
    costs microseconds instead of a full retry schedule.  Carries
    ``errno.EHOSTDOWN`` — deliberately **not** in
    :data:`TRANSIENT_ERRNOS`, so the retry layer re-raises it
    immediately (no backoff, no giveup accounting): the breaker, not
    the retry budget, owns recovery timing.
    """

    def __init__(self, domain: str, retry_in: float = 0.0):
        super().__init__(
            errno.EHOSTDOWN,
            f"storage domain {domain!r} circuit open"
            + (f" (probe in {retry_in:.2f}s)" if retry_in > 0 else ""),
        )
        self.domain = domain
        self.retry_in = float(retry_in)


@dataclass
class DomainHealth:
    """Point-in-time health snapshot of one storage domain."""

    domain: str
    state: str  # "closed" | "open" | "half_open"
    ops: int
    errors: int
    giveups: int
    error_rate: float  # over the sliding window
    p50_latency: float
    p95_latency: float
    opened_at: Optional[float] = None
    probes_ok: int = 0


class _DomainStats:
    __slots__ = (
        "outcomes", "lats", "ops", "errors", "giveups",
        "state", "opened_at", "probes_ok", "half_inflight",
    )

    def __init__(self, window: int):
        self.outcomes: deque = deque(maxlen=window)  # True=ok per attempt
        self.lats: deque = deque(maxlen=window)  # success latencies (s)
        self.ops = 0
        self.errors = 0
        self.giveups = 0
        self.state = "closed"
        self.opened_at: Optional[float] = None
        self.probes_ok = 0
        self.half_inflight = 0


class StorageHealth:
    """Per-domain sliding-window health registry + circuit breaker.

    Domains are free-form strings — the runtime uses ``"pfs"``,
    per-node ``"l1:n{j}"``/``"partner:n{j}"``, and per-reader
    ``"reader:n{k}"`` (latency-only, for straggler demotion).  Outcomes
    are fed per *attempt* by :meth:`RetryPolicy.run` (``domain=`` at
    the call sites), so the registry sees exactly what the retry layer
    sees: every transient failure, every giveup, every success with its
    latency.

    Circuit states (per domain):

    * **closed** — healthy.  Trips to *open* when a retry budget gives
      up (``open_on_giveup``) or when the sliding-window error rate
      reaches ``error_threshold`` over ≥ ``min_ops`` attempts — with
      concurrent writers each failed attempt lands here *between*
      backoff sleeps, so a real outage opens the circuit before any
      single op can burn its whole budget.
    * **open** — :meth:`check` raises :class:`CircuitOpenError`
      immediately.  After ``cooldown`` seconds the next ``check``
      admits up to ``probe_parallel`` ops as half-open probes.
    * **half_open** — probe ops flow, everything else still fails
      fast.  ``probe_successes`` consecutive successes close the
      circuit (window reset); one failure re-opens it with a fresh
      cooldown.

    ``clock`` is injectable so circuit-transition tests are pure
    functions of their fault schedule, not of wall-clock scheduling.
    """

    def __init__(
        self,
        *,
        window: int = 64,
        min_ops: int = 8,
        error_threshold: float = 0.5,
        open_on_giveup: bool = True,
        cooldown: float = 2.0,
        probe_successes: int = 2,
        probe_parallel: int = 2,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.window = max(4, int(window))
        self.min_ops = max(1, int(min_ops))
        self.error_threshold = float(error_threshold)
        self.open_on_giveup = bool(open_on_giveup)
        self.cooldown = float(cooldown)
        self.probe_successes = max(1, int(probe_successes))
        self.probe_parallel = max(1, int(probe_parallel))
        self.clock = clock
        self._lock = threading.Lock()
        self._domains: Dict[str, _DomainStats] = {}
        self.trips = 0  # closed->open transitions (telemetry)

    def _dom(self, domain: str) -> _DomainStats:
        d = self._domains.get(domain)
        if d is None:
            d = self._domains[domain] = _DomainStats(self.window)
        return d

    def _trip(self, d: _DomainStats) -> None:
        d.state = "open"
        d.opened_at = self.clock()
        d.probes_ok = 0
        d.half_inflight = 0
        d.outcomes.clear()
        self.trips += 1

    def record(
        self,
        domain: str,
        ok: bool,
        latency: float = 0.0,
        *,
        giveup: bool = False,
    ) -> None:
        """Feed one attempt outcome (the retry layer calls this)."""
        with self._lock:
            d = self._dom(domain)
            d.ops += 1
            d.outcomes.append(bool(ok))
            if ok and latency > 0.0:
                d.lats.append(float(latency))
            if d.state == "half_open":
                d.half_inflight = max(0, d.half_inflight - 1)
                if ok:
                    d.probes_ok += 1
                    if d.probes_ok >= self.probe_successes:
                        d.state = "closed"
                        d.opened_at = None
                        d.outcomes.clear()
                else:
                    d.errors += 1
                    if giveup:
                        d.giveups += 1
                    self._trip(d)  # failed probe: fresh cooldown
                return
            if ok:
                return
            d.errors += 1
            if giveup:
                d.giveups += 1
            if d.state != "closed":
                return
            if giveup and self.open_on_giveup:
                self._trip(d)
                return
            n = len(d.outcomes)
            bad = n - sum(d.outcomes)
            if n >= self.min_ops and bad / n >= self.error_threshold:
                self._trip(d)

    def note_latency(self, domain: str, latency: float) -> None:
        """Latency-only sample (read-side reader stats): no outcome,
        no circuit effect — feeds quantiles for hedging/demotion."""
        with self._lock:
            d = self._dom(domain)
            d.ops += 1
            d.lats.append(float(latency))

    def check(self, domain: str) -> None:
        """Gate one op: no-op when closed, admits probes when
        half-open, raises :class:`CircuitOpenError` otherwise."""
        with self._lock:
            d = self._domains.get(domain)
            if d is None or d.state == "closed":
                return
            now = self.clock()
            if d.state == "open":
                waited = now - (d.opened_at or now)
                if waited < self.cooldown:
                    raise CircuitOpenError(domain, self.cooldown - waited)
                d.state = "half_open"
                d.probes_ok = 0
                d.half_inflight = 0
            if d.half_inflight < self.probe_parallel:
                d.half_inflight += 1  # admitted as a half-open probe
                return
            raise CircuitOpenError(domain)

    def allow(self, domain: str) -> bool:
        """Non-raising :meth:`check` (restore-ladder gating)."""
        try:
            self.check(domain)
            return True
        except CircuitOpenError:
            return False

    def state(self, domain: str) -> str:
        with self._lock:
            d = self._domains.get(domain)
            if d is None:
                return "closed"
            if (
                d.state == "open"
                and d.opened_at is not None
                and self.clock() - d.opened_at >= self.cooldown
            ):
                return "half_open"  # a check() would admit probes now
            return d.state

    def probe_due(self, domain: str) -> bool:
        """True when an explicit probe op would be admitted — the
        engine's degraded tick drives :meth:`RealExecutor.probe_pfs`
        off this, so a fully parked scheduler still recovers."""
        return self.state(domain) in ("half_open",)

    def latency_quantile(
        self, domain: str, q: float, default: float = 0.0
    ) -> float:
        with self._lock:
            d = self._domains.get(domain)
            if d is None or not d.lats:
                return default
            arr = sorted(d.lats)
            i = min(len(arr) - 1, max(0, int(q * len(arr))))
            return float(arr[i])

    def snapshot(self) -> Dict[str, DomainHealth]:
        with self._lock:
            out: Dict[str, DomainHealth] = {}
            for name, d in self._domains.items():
                n = len(d.outcomes)
                bad = n - sum(d.outcomes)
                lats = sorted(d.lats)
                out[name] = DomainHealth(
                    domain=name,
                    state=d.state,
                    ops=d.ops,
                    errors=d.errors,
                    giveups=d.giveups,
                    error_rate=(bad / n) if n else 0.0,
                    p50_latency=lats[len(lats) // 2] if lats else 0.0,
                    p95_latency=(
                        lats[min(len(lats) - 1, int(0.95 * len(lats)))]
                        if lats
                        else 0.0
                    ),
                    opened_at=d.opened_at,
                    probes_ok=d.probes_ok,
                )
            return out


@dataclass
class RetryPolicy:
    """Bounded retry with errno classification for raw storage ops.

    ``run(fn)`` retries ``fn`` while :func:`classify_error` (or the
    ``classify`` override) says the failure is transient, up to
    ``attempts`` total tries and a per-op wall-clock ``deadline``.
    Backoff is exponential from ``base_delay`` capped at ``max_delay``,
    with deterministic seeded jitter (multiplier in ``[1, 1+jitter]``).
    Sleeps go through ``CancelToken.wait`` when a token is passed, so a
    cancelled flush aborts mid-backoff with :class:`FlushCancelled`
    instead of sleeping out its schedule.

    Policy-level totals (``retries``/``giveups``) accumulate across all
    callers; per-call deltas go to the optional ``stats`` dict (keys
    ``"retries"``/``"giveups"``, updated under the policy lock) which
    the executor uses to fill :class:`FlushResult`/:class:`ReadResult`.

    When a :class:`StorageHealth` registry is attached (``health``) and
    the caller names its ``domain``, every attempt is gated by
    ``health.check(domain)`` — **before each try, including re-tries
    mid-backoff** — and every outcome is recorded.  That per-attempt
    gate is what makes an outage cheap: once concurrent failures trip
    the domain's breaker, every op still inside its retry schedule
    fails fast with :class:`CircuitOpenError` on its next attempt
    instead of sleeping out the budget and giving up.
    """

    attempts: int = 5
    base_delay: float = 0.02
    max_delay: float = 0.5
    deadline: float = 30.0
    jitter: float = 0.5
    seed: Optional[int] = None
    classify: Optional[Callable[[BaseException], str]] = None
    health: Optional[StorageHealth] = None

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self.retries = 0  # total sleeps taken before a re-attempt
        self.giveups = 0  # transient failures that exhausted the budget

    def _bump(self, key: str, stats: Optional[dict]) -> None:
        with self._lock:
            setattr(self, key, getattr(self, key) + 1)
            if stats is not None:
                stats[key] = stats.get(key, 0) + 1

    def run(
        self,
        fn: Callable,
        *,
        cancel: Optional[CancelToken] = None,
        stats: Optional[dict] = None,
        domain: Optional[str] = None,
    ):
        health = self.health if domain is not None else None
        t0 = time.monotonic()
        attempt = 0
        while True:
            if health is not None:
                health.check(domain)  # fail fast while the circuit is open
            t_att = time.monotonic()
            try:
                r = fn()
            except FlushCancelled:
                raise  # a scheduling outcome, never an I/O failure
            except CircuitOpenError:
                # a *nested* domain's breaker (our own check already
                # passed): propagate unrecorded — it is not an outcome
                # of this domain, and never worth a backoff
                raise
            except OSError as e:
                attempt += 1
                kind = (self.classify or classify_error)(e)
                if kind != "transient":
                    # ENOENT is a *correct answer* from a healthy medium
                    # — the fallback ladder probes for missing blobs all
                    # the time — so it must never charge the circuit
                    if health is not None and not isinstance(
                        e, FileNotFoundError
                    ):
                        health.record(domain, False)
                    raise
                elapsed = time.monotonic() - t0
                if attempt >= max(1, self.attempts) or elapsed >= self.deadline:
                    self._bump("giveups", stats)
                    if health is not None:
                        health.record(domain, False, giveup=True)
                    raise
                if health is not None:
                    health.record(domain, False)
                delay = min(self.max_delay, self.base_delay * (2 ** (attempt - 1)))
                with self._lock:
                    delay *= 1.0 + self.jitter * self._rng.random()
                delay = min(delay, max(0.0, self.deadline - elapsed))
                if cancel is not None:
                    if cancel.wait(delay):
                        raise FlushCancelled("cancelled while backing off")
                elif delay > 0:
                    time.sleep(delay)
                self._bump("retries", stats)
            else:
                if health is not None:
                    health.record(domain, True, time.monotonic() - t_att)
                return r


class TokenBucket:
    """Global token-bucket byte-rate limiter for executor writes.

    ``rate`` is bytes/second shared by *all* writer threads (one bucket
    per manager — the real-executor twin of the single extra capacity
    the simulator prices a ``flush_bw_cap`` as).  Requests may exceed
    ``burst``: a thread pays its bytes into the bucket debt and later
    acquirers wait until the debt refills, so arbitrarily large
    coalesced rows still observe the long-run rate.  ``acquire``
    returns the seconds it slept; a fired :class:`CancelToken` aborts
    the sleep with :class:`FlushCancelled`.
    """

    def __init__(self, rate: float, burst: Optional[float] = None):
        if rate <= 0:
            raise ValueError("TokenBucket rate must be positive")
        self.rate = float(rate)
        self.burst = float(burst) if burst else max(1 << 20, self.rate / 8)
        self._tokens = self.burst
        self._last = time.monotonic()
        self._lock = threading.Lock()
        self.wait_total = 0.0  # cumulative sleep across all acquirers

    def acquire(self, n: int, cancel: Optional[CancelToken] = None) -> float:
        if n <= 0:
            return 0.0
        waited = 0.0
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(
                    self.burst, self._tokens + (now - self._last) * self.rate
                )
                self._last = now
                if self._tokens > 0:
                    self._tokens -= n  # may go negative: pay-ahead debt
                    self.wait_total += waited
                    return waited
                # the exact refill time is computable from the debt:
                # sleep it once instead of polling 0.25 s slices (the
                # loop re-checks only because a concurrent acquirer may
                # have deepened the debt meanwhile)
                delay = (1 - self._tokens) / self.rate
            if cancel is not None:
                if cancel.wait(delay):
                    raise FlushCancelled("cancelled while throttled")
            else:
                time.sleep(delay)
            waited += delay

    def set_rate(self, rate: float) -> None:
        """Retarget the refill rate in place (fair-share rebalances).

        Accrued tokens/debt are settled at the *old* rate first, so a
        tenant cannot bank the pre-rebalance rate into a burst, and the
        burst ceiling follows the constructor's sizing rule.
        """
        rate = max(1e-6, float(rate))
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
            self._last = now
            self.rate = rate
            self.burst = max(1 << 20, rate / 8)
            self._tokens = min(self._tokens, self.burst)


def fair_share_rates(weights, demands, cap: float):
    """Weighted max-min (water-filling) split of one byte-rate cap.

    ``weights[i]`` is tenant *i*'s priority weight, ``demands[i]`` its
    offered rate (bytes/s it could use right now; 0 = idle).  Returns
    the granted rates: repeatedly hand every unsatisfied tenant its
    weighted share of the leftover cap, cap each grant at the tenant's
    remaining demand, and redistribute what saturated tenants returned.
    Invariants (the property-tested contract of the control plane's
    quota layer):

    - ``sum(granted) <= cap`` and ``granted[i] <= demands[i]``;
    - every backlogged tenant is granted ``> 0`` (no starvation) and
      at least its weighted share of ``cap`` unless its own demand is
      smaller;
    - idle tenants are granted exactly 0 — their share is fully
      redistributed, so ``sum(granted) == min(cap, sum(demands))``.
    """
    w = np.asarray(weights, dtype=np.float64)
    d = np.asarray(demands, dtype=np.float64)
    if w.shape != d.shape:
        raise ValueError("weights and demands must have the same length")
    r = np.zeros_like(d)
    if cap <= 0 or not len(d):
        return r
    active = (d > 0) & (w > 0)
    remaining = float(cap)
    # Each pass saturates >= 1 tenant or exhausts the cap: <= n passes.
    while remaining > 1e-12 * max(1.0, cap) and active.any():
        share = remaining * w[active] / w[active].sum()
        need = d[active] - r[active]
        grant = np.minimum(share, need)
        r[active] += grant
        remaining -= float(grant.sum())
        # a tenant granted its whole need is saturated, also where
        # r + (d - r) rounded to just under d - 1e-9
        full = np.zeros_like(active)
        full[active] = share >= need
        still = active & (r < d - 1e-9) & ~full
        if still.sum() == active.sum():
            break  # nobody saturated: every share was granted in full
        active = still
    return r


class TenantLimiter:
    """One tenant's leaf of a :class:`FairShareLimiter` hierarchy.

    Drop-in for :class:`TokenBucket` at the executor boundary — only
    ``acquire(n, cancel=)`` and ``wait_total`` are consumed there.  A
    charge pays two buckets in order: the tenant bucket (rate = the
    fair share the parent last granted) and the parent's root bucket
    (rate = the global cap), which bounds the aggregate during the
    window between a demand change and the next rebalance.
    """

    def __init__(self, parent: "FairShareLimiter", name: str, weight: float):
        self.parent = parent
        self.name = name
        self.weight = float(weight)
        self.backlog = 0  # offered-load signal, maintained by add/sub_demand
        self.bucket = TokenBucket(max(1e-6, parent.cap))
        self.wait_total = 0.0

    @property
    def rate(self) -> float:
        return self.bucket.rate

    def add_demand(self, n: int) -> None:
        self.parent._adjust_demand(self, int(n))

    def sub_demand(self, n: int) -> None:
        self.parent._adjust_demand(self, -int(n))

    def acquire(self, n: int, cancel: Optional[CancelToken] = None) -> float:
        if n <= 0:
            return 0.0
        # An acquire IS demand: a tenant that charges without having
        # declared a backlog (sync flushes, resumes) must not starve on
        # a stale zero-rate grant.
        if self.backlog <= 0:
            self.parent._adjust_demand(self, int(n))
        waited = self.bucket.acquire(n, cancel)
        waited += self.parent.root.acquire(n, cancel)
        self.wait_total += waited
        return waited


class FairShareLimiter:
    """Hierarchical token buckets: one global ``flush_bw_cap`` shared
    by N tenants, split by weighted fair share of the *backlogged*
    tenants (:func:`fair_share_rates` with demand = "wants the full
    cap" while a tenant has queued flush bytes, 0 when idle).

    Every demand transition rebalances the per-tenant bucket rates, so
    an idle tenant's share is redistributed immediately and returns to
    it on its next save.  The root bucket enforces the aggregate cap
    even mid-transition.  This is the real-runtime twin of
    ``sim.simulate_flush_shared``: both price tenant *i* exactly like a
    single-job ``flush_bw_cap`` equal to its granted share.
    """

    def __init__(self, cap: float):
        if cap <= 0:
            raise ValueError("FairShareLimiter cap must be positive")
        self.cap = float(cap)
        self.root = TokenBucket(self.cap)
        self._lock = threading.Lock()
        self._tenants: Dict[str, TenantLimiter] = {}

    def register(self, name: str, weight: float = 1.0) -> TenantLimiter:
        if weight <= 0:
            raise ValueError("tenant weight must be positive")
        with self._lock:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            t = TenantLimiter(self, name, weight)
            self._tenants[name] = t
            self._rebalance_locked()
        return t

    def unregister(self, name: str) -> None:
        with self._lock:
            self._tenants.pop(name, None)
            self._rebalance_locked()

    def rate_of(self, name: str) -> float:
        return self._tenants[name].rate

    def tenants(self) -> List[str]:
        with self._lock:
            return list(self._tenants)

    def _adjust_demand(self, t: TenantLimiter, delta: int) -> None:
        with self._lock:
            was = t.backlog > 0
            t.backlog = max(0, t.backlog + delta)
            if (t.backlog > 0) != was:
                self._rebalance_locked()

    def _rebalance_locked(self) -> None:
        ts = list(self._tenants.values())
        if not ts:
            return
        weights = [t.weight for t in ts]
        demands = [self.cap if t.backlog > 0 else 0.0 for t in ts]
        rates = fair_share_rates(weights, demands, self.cap)
        total_w = sum(weights)
        for t, r in zip(ts, rates):
            if r <= 0:
                # Idle standby trickle: first post-idle bytes flow at a
                # token share until the implicit-demand bump rebalances.
                r = self.cap * (t.weight / total_w) * 1e-3
            t.bucket.set_rate(r)


class FlushJournal:
    """Append-only columnar progress cursor for one step's flush.

    On-disk format: little-endian int64 triples ``(file_id,
    file_offset, size)``, one per completed destination extent —
    ``file_id`` indexes the manifest placement's ``file_names``.  The
    executor journals each row *after* its ``pwrite`` returns, buffered
    (``flush_every`` records) and fsynced on flush, so after a crash
    the journal only under-reports: every journaled extent is truly on
    the PFS — ``pre_sync`` (the executor passes a data-fd fsync) runs
    before each batch of records is persisted, so a record can never
    outlive a page-cache-only write through a power loss — and at most
    one buffer's worth of completed writes gets redone on resume.  A
    torn trailing record (process death mid-append) is truncated away
    on load.

    Coverage queries (:meth:`covers`) run against the extents loaded at
    construction, merged per file (``merge_intervals``) — the resume
    pass skips any write row whose destination interval is fully
    covered, regardless of how the original flush coalesced its rows.
    """

    RECORD = 24  # 3 x int64

    def __init__(
        self,
        path,
        flush_every: int = 32,
        *,
        fresh: bool = False,
        pre_sync: Optional[Callable[[], None]] = None,
    ):
        """``fresh=True`` discards any journal left on disk first — a
        *new* flush of a step must never inherit extents journaled by a
        previous incarnation of that step (different bytes!); only the
        resume path loads the existing cursor.  ``pre_sync`` runs
        before each batch of records is written (the executor fsyncs
        the data fds there) so the journal never claims durability the
        data does not have."""
        self.path = Path(path)
        self._flush_every = max(1, flush_every)
        self._buf: List[Tuple[int, int, int]] = []
        self._lock = threading.Lock()
        self.pre_sync = pre_sync
        if fresh:
            try:
                self.path.unlink()
            except FileNotFoundError:
                pass
        self.done = self._load(self.path)
        self._cov: Optional[Dict[int, Tuple[np.ndarray, np.ndarray]]] = None

    @staticmethod
    def _load(path: Path) -> np.ndarray:
        try:
            raw = path.read_bytes()
        except FileNotFoundError:
            return np.empty((0, 3), np.int64)
        n = len(raw) // FlushJournal.RECORD  # drop a torn trailing record
        if n == 0:
            return np.empty((0, 3), np.int64)
        return (
            np.frombuffer(raw[: n * FlushJournal.RECORD], dtype="<i8")
            .reshape(n, 3)
            .astype(np.int64)
        )

    @property
    def completed_bytes(self) -> int:
        """Journaled payload (may double-count overlapping rewrites)."""
        return int(self.done[:, 2].sum())

    def _coverage(self) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        if self._cov is None:
            cov: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
            for f in np.unique(self.done[:, 0]).tolist():
                rows = self.done[self.done[:, 0] == f]
                start, size = merge_intervals(rows[:, 1], rows[:, 2])
                cov[int(f)] = (start, start + size)
            self._cov = cov
        return self._cov

    def covers(self, file_id: int, offset: int, size: int) -> bool:
        """True iff ``[offset, offset+size)`` of ``file_id`` is fully
        inside the journaled (merged) extents loaded at construction."""
        iv = self._coverage().get(int(file_id))
        if iv is None:
            return False
        start, end = iv
        i = int(np.searchsorted(start, offset, side="right")) - 1
        return i >= 0 and int(end[i]) >= offset + size

    def record(self, file_id: int, file_offset: int, size: int) -> None:
        with self._lock:
            self._buf.append((int(file_id), int(file_offset), int(size)))
            if len(self._buf) >= self._flush_every:
                self._flush_locked()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buf:
            return
        if self.pre_sync is not None:
            self.pre_sync()  # data durability strictly before the claim
        arr = np.asarray(self._buf, dtype="<i8")
        with open(self.path, "ab") as f:
            f.write(arr.tobytes())
            f.flush()
            try:
                os.fsync(f.fileno())
            except OSError:  # pragma: no cover - fs without fsync
                pass
        self._buf.clear()

    def unlink(self) -> None:
        """Remove the journal (flush completed — the cursor is moot)."""
        with self._lock:
            self._buf.clear()
        try:
            self.path.unlink()
        except FileNotFoundError:
            pass


class LocalStore:
    """L1: per-node local directories (simulated node-local SSDs).

    ``faults`` is the deterministic injection surface (domains ``l1``
    for home blobs, ``partner`` for replicas); ``retry`` wraps every
    raw blob read/write so transient hiccups heal in place.  Read
    failures that survive retries are re-raised as structured
    :class:`StorageError`\\ s with ``(level, step, rank, path)``.
    """

    def __init__(
        self,
        root: Path,
        n_nodes: int,
        *,
        faults: Optional[FaultPlan] = None,
        retry: Optional[RetryPolicy] = None,
    ):
        self.root = Path(root)
        self.n_nodes = n_nodes
        self.faults = faults
        self.retry = retry
        # created-directory cache: the parallel local phase writes one
        # file per rank, and a paper-scale node dir must not pay a
        # mkdir round trip per blob
        self._dirs_seen: set = set()
        self._dirs_lock = threading.Lock()

    def _ensure_dir(self, d: Path) -> None:
        key = str(d)
        with self._dirs_lock:
            if key in self._dirs_seen:
                return
        d.mkdir(parents=True, exist_ok=True)
        with self._dirs_lock:
            self._dirs_seen.add(key)

    def _forget_dirs(self) -> None:
        with self._dirs_lock:
            self._dirs_seen.clear()

    def node_dir(self, node: int, step: int) -> Path:
        return self.root / f"node_{node:04d}" / f"step_{step:08d}"

    def blob_path(self, node: int, step: int, rank: int, partner: bool = False) -> Path:
        ext = "partner" if partner else "blob"
        return self.node_dir(node, step) / f"rank_{rank:06d}.{ext}"

    def write_blob(
        self, node: int, step: int, rank: int, data, *,
        partner: bool = False, sync: bool = True, atomic: bool = True,
    ) -> None:
        """Write one rank blob (any bytes-like buffer).

        ``sync=True`` (the seed behaviour) fsyncs the file;
        ``atomic=True`` (also the seed behaviour) writes through a tmp
        file + rename.  The parallel local phase passes both as False:
        the local *manifest* — replaced atomically after every blob
        landed — is the step's commit point, so a **process** crash
        mid-save leaves no manifest pointing at torn blobs.  Against
        node power loss this path is deliberately weaker than the seed
        (data blocks ride on OS writeback; :meth:`sync_dir` fsyncs
        directory metadata only): L1 is the level the multi-level
        ladder already assumes lost on node failure — partner replicas
        and the PFS level cover it, and restore CRC-checks every blob
        before trusting it.  Per-file power-loss durability remains
        available via the sequential local phase (``parallel_local=False``).

        The atomic+sync path fsyncs the *parent directory* after the
        rename: ``os.replace`` alone leaves the new directory entry in
        volatile metadata, so without the dir fsync the blob could
        vanish across power loss even though its data blocks were
        synced — the rename itself must be made durable.
        """
        p = self.blob_path(node, step, rank, partner)
        self._ensure_dir(p.parent)
        domain = "partner" if partner else "l1"

        def _write(buf) -> None:
            if atomic:
                tmp = p.with_suffix(p.suffix + ".tmp")
                with open(tmp, "wb") as f:
                    f.write(buf)
                    f.flush()
                    if sync:
                        os.fsync(f.fileno())
                os.replace(tmp, p)
                if sync:
                    self._fsync_dir(p.parent)
            else:
                with open(p, "wb") as f:
                    f.write(buf)
                    f.flush()
                    if sync:
                        os.fsync(f.fileno())

        def attempt() -> None:
            inject_write(
                self.faults, domain, f"step{step}/rank{rank}", data, _write,
                node=node,
            )

        if self.retry is not None:
            self.retry.run(attempt, domain=f"{domain}:n{node}")
        else:
            attempt()

    @staticmethod
    def _fsync_dir(d: Path) -> None:
        """Directory-entry durability: fsync ``d`` through an fd."""
        try:
            fd = os.open(str(d), os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:  # pragma: no cover - fs without dir fsync
            pass
        finally:
            os.close(fd)

    def sync_dir(self, node: int, step: int) -> None:
        """Batched metadata-durability point for one node's step
        directory: a single directory fsync covering every entry that
        landed there.  Blob *data* durability on the parallel path is
        explicitly entrusted to OS writeback + the level ladder (see
        :meth:`write_blob`); the sequential per-file-fsync local phase
        (``parallel_local=False``) keeps the stronger guarantee."""
        self._fsync_dir(self.node_dir(node, step))

    def read_blob(
        self, node: int, step: int, rank: int, *, partner: bool = False
    ) -> bytes:
        p = self.blob_path(node, step, rank, partner)
        domain = "partner" if partner else "l1"

        def attempt() -> bytes:
            if self.faults is not None:
                self.faults.on_op(domain, "read", str(p), node=node)
            return p.read_bytes()

        try:
            if self.retry is not None:
                return self.retry.run(attempt, domain=f"{domain}:n{node}")
            return attempt()
        except OSError as e:
            raise wrap_storage_error(domain, step, rank, p, e) from e

    def read_slice(
        self, node: int, step: int, rank: int, offset: int, size: int,
        *, partner: bool = False,
    ) -> bytes:
        p = self.blob_path(node, step, rank, partner)
        domain = "partner" if partner else "l1"

        def attempt() -> bytes:
            if self.faults is not None:
                self.faults.on_op(domain, "read", str(p), node=node)
            with open(p, "rb") as f:
                f.seek(offset)
                return f.read(size)

        try:
            if self.retry is not None:
                return self.retry.run(attempt, domain=f"{domain}:n{node}")
            return attempt()
        except OSError as e:
            raise wrap_storage_error(domain, step, rank, p, e) from e

    def has_blob(self, node: int, step: int, rank: int, *, partner: bool = False) -> bool:
        return self.blob_path(node, step, rank, partner).exists()

    def drop_node(self, node: int, step: Optional[int] = None) -> None:
        """Simulate node-local storage loss (node failure)."""
        p = (
            self.root / f"node_{node:04d}"
            if step is None
            else self.node_dir(node, step)
        )
        if p.exists():
            shutil.rmtree(p)
        self._forget_dirs()

    def gc_step(self, step: int) -> None:
        for nd in self.root.glob("node_*"):
            p = nd / f"step_{step:08d}"
            if p.exists():
                shutil.rmtree(p)
        self._forget_dirs()


@dataclass
class FlushResult:
    step: int
    duration: float
    bytes_written: int
    n_writes: int
    failed: bool = False
    error: Optional[str] = None
    # adaptive-runtime telemetry: extents skipped because the progress
    # journal proved them already on the PFS (resume), and total seconds
    # writer threads slept in the rate limiter (throttle pressure).
    bytes_skipped: int = 0
    throttle_wait: float = 0.0
    # retry-layer telemetry: transient PFS-write failures healed by a
    # re-attempt, and ops that exhausted the retry budget anyway.
    io_retries: int = 0
    io_giveups: int = 0


@dataclass
class ReadResult:
    """Aggregate stats of one executed :class:`ReadPlan`."""

    step: int
    duration: float
    bytes_read: int
    n_reads: int
    n_readers: int
    io_retries: int = 0
    io_giveups: int = 0
    # tail-robustness telemetry: hedge requests issued past the latency
    # deadline, and how many beat their primary to the buffer.
    hedges_issued: int = 0
    hedge_wins: int = 0


@dataclass
class HedgePolicy:
    """Deadline-aware read hedging for :meth:`RealExecutor.execute_read_plan`.

    When a pread has been in flight longer than the hedge deadline —
    the ``quantile`` of latencies observed so far in this plan (seeded
    from the health registry's PFS history when attached), floored at
    ``min_delay_s`` — the extent is re-issued through ``alt_read`` (the
    engine maps it back to the L1/partner copy, ordered by health).
    First success wins and claims the destination; the loser's bytes
    are discarded (a blocking ``pread`` cannot be interrupted, so
    "cancellation" is claim-or-discard at the buffer boundary).
    Hedge *failures* are silent: hedging may only ever help the tail,
    never fail a plan the primary path would have completed.
    """

    alt_read: Callable[[int, int, int], Optional[bytes]]
    quantile: float = 0.95
    min_delay_s: float = 0.02
    poll_s: float = 0.005
    max_hedges: int = 16
    min_samples: int = 4  # latency samples needed before quantile kicks in


class RealExecutor:
    """Executes a FlushPlan against files under ``pfs_dir``.

    The write hot path iterates :class:`~repro_torch.core.plan.PlanArrays`
    columns directly (mirroring :meth:`execute_read_plan`) — the lazy
    ``WriteItem`` dataclass lists are never materialized unless a
    ``fault_hook`` needs the item view — and all batches, rounds and
    steps share **one persistent thread pool** instead of constructing a
    fresh ``ThreadPoolExecutor`` per round.  Adjacent writes that are
    contiguous in both the source blob and the destination file coalesce
    into a single L1 pread + PFS pwrite before being issued.  The seed
    item-loop executor is a spec of the ``repro`` package only.
    """

    def __init__(
        self,
        pfs_dir: Path,
        local: LocalStore,
        *,
        io_threads: int = 2,
        fault_hook: Optional[Callable[[WriteItem], None]] = None,
        faults: Optional[FaultPlan] = None,
        retry: Optional[RetryPolicy] = None,
    ):
        self.pfs_dir = Path(pfs_dir)
        self.local = local
        self.io_threads = max(1, io_threads)
        self.fault_hook = fault_hook
        self.faults = faults  # deterministic injection (domain "pfs")
        self.retry = retry  # transient-retry wrap for pwrites/preads
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()

    # ---- shared worker pool ----------------------------------------------

    POOL_CAP = 16  # the global worker cap every sizing heuristic min()s with

    def pool(self, workers: int = POOL_CAP) -> ThreadPoolExecutor:
        """The persistent shared worker pool, reused across rounds,
        batches, steps and read plans.  Created **once**, sized at the
        global cap (or the first caller's larger request), and never
        replaced — concurrent holders (an in-flight flush, a save()'s
        local phase) must never have their pool shut down under them.
        Per-call ``workers`` below the cap only decides inline-vs-pool
        execution in :meth:`_run_rows`, not pool size."""
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=max(self.POOL_CAP, int(workers)),
                    thread_name_prefix="ckpt-io",
                )
            return self._pool

    def close(self) -> None:
        with self._pool_lock:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None

    def step_dir(self, step: int) -> Path:
        return self.pfs_dir / f"step_{step:08d}"

    def execute(
        self,
        plan: FlushPlan,
        step: int,
        *,
        cancel: Optional[CancelToken] = None,
        limiter: Optional[TokenBucket] = None,
        journal: Optional[FlushJournal] = None,
    ) -> FlushResult:
        """Run a flush plan.  ``cancel`` is polled at safe request
        boundaries (raising :class:`FlushCancelled` between writes),
        ``limiter`` throttles writer bytes through the shared token
        bucket, and ``journal`` both *skips* destination extents it
        already covers (resume) and records each completed write."""
        pa = plan.ensure_arrays()
        # Coalesce adjacent same-source reads: rows contiguous in both
        # (src_rank, src_offset) and (file, file_offset) become one
        # pread + one pwrite (pipeline-chunked and multi-round plans
        # split one rank's bytes into many such rows).
        w = coalesce_write_columns(pa.writes)
        homes = plan.cluster.nodes_of_ranks(w.src_rank)
        # Global worker pool == work stealing across backends: idle
        # backends' threads drain the shared queue (the straggler
        # mitigation used by our §3 implementation; see DESIGN.md).
        n_backends = len(np.unique(w.backend)) or 1
        workers = min(16, self.io_threads * n_backends)
        return self._execute_columns(
            plan.files, pa.file_names, w, homes, step,
            workers=workers, barrier_per_round=plan.barrier_per_round,
            cancel=cancel, limiter=limiter, journal=journal,
        )

    def execute_resume(
        self,
        manifest: Manifest,
        step: int,
        *,
        cancel: Optional[CancelToken] = None,
        limiter: Optional[TokenBucket] = None,
        journal: Optional[FlushJournal] = None,
    ) -> FlushResult:
        """Finish an interrupted flush from its persisted placement.

        A ``flush_partial`` manifest already carries the full write set
        (columnar :class:`~repro_torch.core.serialize.Placement` — the same
        rows the original plan coalesced from) and its file size table,
        so resume needs no strategy re-run: rows are rebuilt straight
        from the placement columns, rows whose destination extents the
        ``journal`` covers are skipped, and only the remainder is read
        from L1 and rewritten.  Rows are deliberately **not**
        re-coalesced: placement rows are at least as fine as anything
        the original flush journaled (coalescing merges rows, never
        splits them), so every fully-flushed extent skips exactly —
        re-merging across what were different backends/rounds would
        glue flushed and unflushed extents into one row and force its
        rewrite.  Round barriers are irrelevant on resume (destinations
        are disjoint and writes idempotent), so the remainder runs as
        one free-running batch.
        """
        pl = manifest.placement
        homes_src = pl.rank // max(1, manifest.procs_per_node)
        w = WriteColumns(
            backend=homes_src,
            file_id=pl.file_id,
            file_offset=pl.file_offset,
            size=pl.size,
            src_rank=pl.rank,
            src_offset=pl.src_offset,
            round=np.zeros(len(pl.rank), np.int64),
        )
        homes = w.backend  # backend == the source rank's home node here
        workers = min(16, self.io_threads * (len(np.unique(w.backend)) or 1))
        return self._execute_columns(
            dict(manifest.files), list(pl.file_names), w, homes, step,
            workers=workers, barrier_per_round=False,
            cancel=cancel, limiter=limiter, journal=journal,
        )

    def _execute_columns(
        self,
        files: Dict[str, int],
        names: Sequence[str],
        w: WriteColumns,
        homes: np.ndarray,
        step: int,
        *,
        workers: int,
        barrier_per_round: bool,
        cancel: Optional[CancelToken] = None,
        limiter: Optional[TokenBucket] = None,
        journal: Optional[FlushJournal] = None,
    ) -> FlushResult:
        """Shared column runner behind :meth:`execute` and
        :meth:`execute_resume`: open+size the files, stream the rows
        through the persistent pool, fsync on success.  ``ftruncate``
        to an unchanged size preserves existing contents, so re-opening
        a partially flushed step never clobbers resumed extents."""
        with telemetry.Timer() as clock:
            fields = self._write_columns(
                files, names, w, homes, step,
                workers=workers, barrier_per_round=barrier_per_round,
                cancel=cancel, limiter=limiter, journal=journal,
            )
        return FlushResult(step=step, duration=clock.seconds, **fields)

    def _write_columns(
        self,
        files: Dict[str, int],
        names: Sequence[str],
        w: WriteColumns,
        homes: np.ndarray,
        step: int,
        *,
        workers: int,
        barrier_per_round: bool,
        cancel: Optional[CancelToken],
        limiter: Optional[TokenBucket],
        journal: Optional[FlushJournal],
    ) -> Dict[str, float]:
        """``_execute_columns``'s body: the fields of its
        :class:`FlushResult` other than ``step`` and ``duration``."""
        sdir = self.step_dir(step)
        sdir.mkdir(parents=True, exist_ok=True)

        # Pre-create + size every file (the metadata phase).
        fds: Dict[str, int] = {}
        try:
            for fname, size in files.items():
                path = sdir / fname
                fd = os.open(str(path), os.O_CREAT | os.O_WRONLY, 0o644)
                os.ftruncate(fd, size)
                fds[fname] = fd
            if journal is not None:
                # a journal record is a durability claim: fsync the data
                # fds before any batch of records is persisted
                journal.pre_sync = lambda: [os.fsync(f) for f in fds.values()]

            lock = threading.Lock()
            total = {"bytes": 0, "writes": 0, "skipped": 0, "throttle": 0.0}
            retry_stats = {"retries": 0, "giveups": 0}
            hook = self.fault_hook

            def do_write(row: Tuple[int, ...]) -> None:
                backend, fid, foff, size, src_rank, soff, rnd, home = row
                if cancel is not None and cancel.cancelled:
                    # safe request boundary: nothing of this row started
                    raise FlushCancelled(f"step {step}: flush cancelled")
                if journal is not None and journal.covers(fid, foff, size):
                    with lock:
                        total["skipped"] += size
                    return
                if hook is not None:
                    # fault-injection surface: materialize the item view
                    # for this row only (never a whole-plan list)
                    hook(WriteItem(backend=backend, file=names[fid],
                                   file_offset=foff, size=size,
                                   src_rank=src_rank, src_offset=soff,
                                   round=rnd))
                waited = (
                    limiter.acquire(size, cancel=cancel)
                    if limiter is not None else 0.0
                )
                # leader pulls from the source node's L1 file ("the
                # send"); if the home node's copy is gone (node loss),
                # the partner replica on node+1 — the same invariant
                # restore uses — keeps the flush finishable
                try:
                    data = self.local.read_slice(
                        home, step, src_rank, soff, size
                    )
                except OSError:
                    partner = (home + 1) % max(1, self.local.n_nodes)
                    data = self.local.read_slice(
                        partner, step, src_rank, soff, size, partner=True
                    )
                if len(data) != size:
                    raise IOError(
                        f"short read: rank {src_rank} [{soff}:{soff + size})"
                    )

                def attempt() -> None:
                    # the injection + pwrite is the retried unit: a torn
                    # write's re-attempt rewrites the full extent
                    inject_write(
                        self.faults, "pfs", f"{names[fid]}@{foff}", data,
                        lambda buf: os.pwrite(fds[names[fid]], buf, foff),
                    )

                if self.retry is not None:
                    self.retry.run(
                        attempt, cancel=cancel, stats=retry_stats, domain="pfs"
                    )
                else:
                    attempt()
                if journal is not None:
                    journal.record(fid, foff, size)
                with lock:
                    total["bytes"] += size
                    total["writes"] += 1
                    total["throttle"] += waited

            rows = list(zip(
                w.backend.tolist(), w.file_id.tolist(),
                w.file_offset.tolist(), w.size.tolist(),
                w.src_rank.tolist(), w.src_offset.tolist(),
                w.round.tolist(), homes.tolist(),
            ))
            if barrier_per_round and len(rows) > 1:
                order = np.argsort(w.round, kind="stable")
                rnds = w.round[order]
                starts = np.flatnonzero(
                    np.concatenate(([True], rnds[1:] != rnds[:-1]))
                ).tolist()
                ordered = [rows[i] for i in order.tolist()]
                for b0, b1 in zip(starts, starts[1:] + [len(ordered)]):
                    self._run_rows(ordered[b0:b1], do_write, workers)
            else:
                self._run_rows(rows, do_write, workers)

            for fd in fds.values():
                os.fsync(fd)
            return dict(
                bytes_written=total["bytes"],
                n_writes=total["writes"],
                bytes_skipped=total["skipped"],
                throttle_wait=total["throttle"],
                io_retries=retry_stats["retries"],
                io_giveups=retry_stats["giveups"],
            )
        finally:
            if journal is not None:
                # persist whatever completed — cancellation/failure paths
                # rely on the journal under-reporting, never losing rows
                try:
                    journal.flush()
                finally:
                    journal.pre_sync = None  # fds close right below
            for fd in fds.values():
                try:
                    os.close(fd)
                except OSError:
                    pass

    def _run_rows(
        self, rows: List, fn: Callable, workers: int
    ) -> None:
        """Run one barrier batch through the persistent pool.

        On a worker exception every outstanding future is cancelled and
        the loop still drains to completion before re-raising: with a
        pool that outlives the batch, abandoning in-flight tasks would
        let them pwrite through fds the caller is about to close (and
        the OS may reuse for the next step's files)."""
        if not rows:
            return
        if workers <= 1 or len(rows) == 1:
            for r in rows:
                fn(r)
            return
        pool = self.pool(workers)
        futs = [pool.submit(fn, r) for r in rows]
        first_err: Optional[BaseException] = None
        for f in as_completed(futs):
            try:
                f.result()
            except BaseException as e:
                if first_err is None:
                    first_err = e
                    for g in futs:
                        g.cancel()
                # subsequent failures/cancellations: drain silently
        if first_err is not None:
            raise first_err

    # ---- read side --------------------------------------------------------

    def execute_read_plan(
        self, rp: ReadPlan, step: int,
        *, on_request: Optional[Callable[[int, memoryview], None]] = None,
        hedge: Optional[HedgePolicy] = None,
        out: Optional[np.ndarray] = None,
    ) -> Tuple[List[memoryview], ReadResult]:
        """Run a :class:`ReadPlan` as ranged ``pread``s via the thread pool.

        Returns one buffer per request (``rp.req_size[i]`` bytes each)
        plus aggregate stats.  The buffers are writable ``memoryview``
        slices, in request order, of one block allocated without a fill
        (``out``, a writable contiguous ``uint8`` array of
        ``rp.req_size.sum()`` bytes, where the caller gives one), which
        each pread lands in directly: ``os.preadv``, no temporary, no
        copy under the GIL.  The worker-pool sizing mirrors the write
        side: idle readers steal from the shared queue, so one straggling
        consumer node does not serialize the restore.  Short reads raise
        ``IOError`` — corruption is then surfaced by the caller's CRC
        check, truncation right here.

        ``on_request(req_idx, buf)``, when given, fires on the worker
        thread that completes the *last* read of each request — the
        engine hangs arrival CRC verification here, so integrity checks
        of early blobs overlap the preads of later ones instead of
        running as a serial pass after the plan drains.  Exceptions it
        raises fail the plan like read errors.  Requests needing zero
        reads (zero-size, or none mapped) fire before the preads start.

        ``hedge``, when given, arms deadline-aware tail hedging: a
        watchdog re-issues any extent whose pread outlives the rolling
        latency-quantile deadline through ``hedge.alt_read`` — first
        success claims the destination buffer, the loser is discarded
        (see :class:`HedgePolicy`).  A hedged plan reads both sides into
        temporaries and only the claim's winner copies into place: a
        losing primary must not write into a buffer already claimed and
        CRC-checked.  The counters ``pfs.read_direct_bytes`` and
        ``pfs.read_copied_bytes`` say which of the two a plan took.
        """
        n = int(rp.req_size.sum())
        if out is not None and (out.dtype != np.uint8 or out.shape != (n,)
                                or not out.flags.writeable or not out.flags.c_contiguous):
            raise ValueError(
                f"read destination must be a writable contiguous uint8 array of {n} bytes"
            )
        with telemetry.Timer() as clock:
            bufs, fields = self._read_plan(rp, step, on_request, hedge, out)
        return bufs, ReadResult(step=step, duration=clock.seconds, **fields)

    def _read_plan(
        self, rp: ReadPlan, step: int,
        on_request: Optional[Callable[[int, memoryview], None]],
        hedge: Optional[HedgePolicy], out: Optional[np.ndarray],
    ) -> Tuple[List[memoryview], Dict[str, int]]:
        """``execute_read_plan``'s body: the buffers, and the fields of
        its :class:`ReadResult` other than ``step`` and ``duration``."""
        sdir = self.step_dir(step)
        # no fill: the plan's reads tile every request, and the pages of
        # a new block fault in inside the preads, off the GIL
        sizes = rp.req_size.tolist()
        block = memoryview(np.empty(sum(sizes), np.uint8) if out is None else out)
        bufs = [block[e - n : e] for n, e in zip(sizes, np.cumsum(sizes).tolist())]
        r = rp.reads
        remaining = np.bincount(
            r.dst_req, minlength=rp.n_requests
        ).astype(np.int64) if len(r) else np.zeros(rp.n_requests, np.int64)
        if on_request is not None:
            for q in np.flatnonzero(remaining == 0).tolist():
                on_request(q, bufs[q])
        if not len(r):
            return bufs, dict(bytes_read=0, n_reads=0, n_readers=0)
        fds: Dict[int, int] = {}
        lock = threading.Lock()
        total = {
            "bytes": 0, "reads": 0, "hedges": 0, "hedge_wins": 0,
            "claimed": 0,
        }
        retry_stats = {"retries": 0, "giveups": 0}
        health = self.retry.health if self.retry is not None else None
        rows = list(
            zip(
                r.file_id.tolist(), r.file_offset.tolist(), r.size.tolist(),
                r.dst_req.tolist(), r.dst_offset.tolist(), r.reader.tolist(),
            )
        )
        # per-row race state (hedging): start time, winner claim, done
        starts: Dict[int, float] = {}
        claimed = [False] * len(rows)
        finished = [False] * len(rows)
        hedged = [False] * len(rows)
        lat_samples: List[float] = (
            [health.latency_quantile("pfs", 0.5)]
            if health is not None and health.latency_quantile("pfs", 0.5) > 0
            else []
        )
        stop = threading.Event()
        all_claimed = threading.Event()
        hedge_threads: List[threading.Thread] = []
        # unhedged, each row has one reader, which reads into its place
        direct = hedge is None

        def complete(i: int, row, data, *, won_hedge: bool) -> bool:
            """Claim row ``i`` for this result; the winner fills the
            destination (``data`` None: the pread already did) and fires
            request completion.  Returns False if the other side already
            won (loser's bytes discarded)."""
            fid, foff, size, req, doff, reader = row
            with lock:
                if claimed[i]:
                    finished[i] = True
                    return False
                claimed[i] = True
                finished[i] = True
            if data is not None:
                bufs[req][doff : doff + size] = data
            with lock:
                total["bytes"] += size
                total["reads"] += 1
                if won_hedge:
                    total["hedge_wins"] += 1
                total["claimed"] += 1
                if total["claimed"] == len(rows):
                    all_claimed.set()  # plan complete: stop waiting on losers
                remaining[req] -= 1
                done = on_request is not None and remaining[req] == 0
            if done:
                on_request(req, bufs[req])
            return True

        def do_read(item) -> None:
            i, row = item
            fid, foff, size, req, doff, reader = row
            with lock:
                if claimed[i]:  # hedge already won while we queued
                    finished[i] = True
                    return
                starts[i] = time.monotonic()
            fd = fds[fid]
            dest = bufs[req][doff : doff + size]

            def attempt():
                """The row's bytes (hedged), else how many of them
                landed in ``dest`` before the end of the file."""
                if self.faults is not None:
                    self.faults.on_op(
                        "pfs", "read", rp.file_names[fid], node=reader
                    )
                if not direct:
                    return os.pread(fd, size, foff)
                got = 0
                while got < size:
                    n = os.preadv(fd, [dest[got:]], foff + got)
                    if n == 0:
                        break
                    got += n
                return got

            try:
                data = (
                    self.retry.run(attempt, stats=retry_stats, domain="pfs")
                    if self.retry is not None
                    else attempt()
                )
            except OSError:
                with lock:
                    finished[i] = True
                    if claimed[i]:
                        return  # the hedge already delivered this extent
                raise
            dt = time.monotonic() - starts[i]
            got = data if direct else len(data)
            if got != size:
                with lock:
                    finished[i] = True
                raise IOError(
                    f"short PFS read: {rp.file_names[fid]} "
                    f"[{foff}:{foff + size})"
                )
            if health is not None:
                health.note_latency(f"reader:n{reader}", dt)
            with lock:
                lat_samples.append(dt)
            complete(i, row, None if direct else data, won_hedge=False)

        def run_hedge(i: int, row) -> None:
            fid, foff, size, req, doff, reader = row
            with lock:
                if claimed[i]:
                    return
            try:
                data = hedge.alt_read(fid, foff, size)
            except Exception:
                return  # hedge may only help, never hurt
            if data is None or len(data) != size:
                return
            complete(i, row, data, won_hedge=True)

        def watchdog() -> None:
            while not stop.wait(hedge.poll_s):
                now = time.monotonic()
                fire: List[int] = []
                with lock:
                    if total["hedges"] >= hedge.max_hedges:
                        return
                    if len(lat_samples) >= hedge.min_samples:
                        arr = sorted(lat_samples)
                        q = arr[min(len(arr) - 1, int(hedge.quantile * len(arr)))]
                        deadline = max(hedge.min_delay_s, q)
                    else:
                        deadline = hedge.min_delay_s
                    for i, t_start in starts.items():
                        if (
                            not finished[i]
                            and not hedged[i]
                            and now - t_start > deadline
                            and total["hedges"] < hedge.max_hedges
                        ):
                            hedged[i] = True
                            total["hedges"] += 1
                            fire.append(i)
                for i in fire:
                    th = threading.Thread(
                        target=run_hedge, args=(i, rows[i]), daemon=True
                    )
                    th.start()
                    hedge_threads.append(th)

        stragglers: List = []
        try:
            for f in np.unique(r.file_id).tolist():
                fds[f] = os.open(str(sdir / rp.file_names[f]), os.O_RDONLY)
            n_readers = len(np.unique(r.reader))
            workers = min(16, self.io_threads * max(1, n_readers))
            mon: Optional[threading.Thread] = None
            if hedge is not None:
                mon = threading.Thread(target=watchdog, daemon=True)
                mon.start()
            items = list(enumerate(rows))
            try:
                if hedge is None or workers <= 1 or len(items) == 1:
                    self._run_rows(items, do_read, workers)
                else:
                    # claim-aware variant of _run_rows: the plan returns
                    # as soon as every row is *claimed* (by its primary
                    # pread or a winning hedge) — a stragglered loser
                    # keeps running in the background, its bytes are
                    # discarded at the claim boundary, and the fds stay
                    # open until it returns (deferred close below).
                    pool = self.pool(workers)
                    futs = [pool.submit(do_read, it) for it in items]
                    first_err: Optional[BaseException] = None
                    pending = set(futs)
                    while pending:
                        done, pending = futures_wait(
                            pending, timeout=hedge.poll_s
                        )
                        for f in done:
                            try:
                                f.result()
                            except BaseException as e:
                                if first_err is None:
                                    first_err = e
                                    for g in futs:
                                        g.cancel()
                        if first_err is None and all_claimed.is_set():
                            stragglers = [
                                f for f in pending if not f.cancel()
                            ]
                            pending = set()
                    if first_err is not None:
                        raise first_err
            finally:
                stop.set()
                if mon is not None:
                    mon.join()
                for th in hedge_threads:
                    th.join()
            telemetry.count("pfs.read_direct_bytes", total["bytes"] if direct else 0)
            telemetry.count("pfs.read_copied_bytes", 0 if direct else total["bytes"])
            return bufs, dict(
                bytes_read=total["bytes"],
                n_reads=total["reads"],
                n_readers=n_readers,
                io_retries=retry_stats["retries"],
                io_giveups=retry_stats["giveups"],
                hedges_issued=total["hedges"],
                hedge_wins=total["hedge_wins"],
            )
        finally:
            if stragglers:
                # the losing preads still hold these fds; closing now
                # would hand their fd numbers to the next step's files.
                # A waiter owns the close instead — result() also
                # swallows the losers' post-claim exceptions.
                def _close_after(fs=list(stragglers), fdmap=dict(fds)):
                    for f in fs:
                        try:
                            f.result()
                        except BaseException:
                            pass
                    for fd in fdmap.values():
                        try:
                            os.close(fd)
                        except OSError:
                            pass

                threading.Thread(target=_close_after, daemon=True).start()
            else:
                for fd in fds.values():
                    try:
                        os.close(fd)
                    except OSError:
                        pass

    def read_rank_blob(
        self, manifest: Manifest, step: int, rank: int,
        layout: Optional["FileLayout"] = None,
    ) -> bytes:
        """Reassemble one rank's stored blob from the PFS placement.

        Kept as the single-rank convenience view; it is now a one-request
        :class:`ReadPlan` so the ranged-pread path is the only read path.
        Callers looping over many ranks should pass a pre-built
        ``layout`` (``manifest.file_layout()``) — or better, batch the
        ranks into one plan — instead of re-inverting the placement per
        call.
        """
        offsets = manifest.stored_offsets()
        rp = build_read_plan(
            layout if layout is not None else manifest.file_layout(),
            [int(offsets[rank])],
            [manifest.ranks[rank].stored_size],
        )
        bufs, _ = self.execute_read_plan(rp, step)
        return bytes(bufs[0])

    # ---- health probes -----------------------------------------------------

    def probe_pfs(self, payload: bytes = b"\x00" * 16) -> float:
        """One **single-attempt** write+readback through the ``pfs``
        fault surface — the half-open circuit's probe op.

        Deliberately unretried and unthrottled: a probe answers "is the
        domain back?" and must fail in one op if it is not.  Returns
        the op latency in seconds; raises the underlying ``OSError``
        on failure (the caller records the outcome into
        :class:`StorageHealth`).
        """
        self.pfs_dir.mkdir(parents=True, exist_ok=True)
        path = self.pfs_dir / ".health_probe"
        t0 = time.monotonic()
        inject_write(
            self.faults, "pfs", "health_probe", payload,
            lambda buf: path.write_bytes(bytes(buf)),
        )
        if self.faults is not None:
            self.faults.on_op("pfs", "read", "health_probe")
        if path.read_bytes() != bytes(payload):
            raise IOError("health probe readback mismatch")
        return time.monotonic() - t0


def placement_from_plan(plan: FlushPlan) -> Placement:
    """Columnar :class:`~repro_torch.core.serialize.Placement` of the plan's
    write set — five int64 column copies, no per-item Python loop, and
    JSON-encodes as flat lists (the 32k-rank manifest fix)."""
    pa = plan.ensure_arrays()
    w = pa.writes
    return Placement(
        file_names=list(pa.file_names),
        rank=w.src_rank.copy(),
        file_id=w.file_id.copy(),
        file_offset=w.file_offset.copy(),
        src_offset=w.src_offset.copy(),
        size=w.size.copy(),
    )
