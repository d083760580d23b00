"""Deterministic fault injection for the storage runtime.

The chaos surface for the self-healing storage stack: a seeded
:class:`FaultPlan` schedules faults at **exact operation indices** in
each storage domain, so a failure scenario is a pure function of its
seed — rerunning a seed replays the same schedule, and a sweep of seeds
(``benchmarks/chaos.py``) becomes a reproducible robustness suite.
This supersedes the ad-hoc ``fault_hook(write_item)`` callback as the
injection surface (the hook survives for targeted tests).

Domains and operations
----------------------

Every raw I/O call in the storage layer is an *operation* in one of
three domains:

* ``l1`` — home-node blob reads/writes (:class:`~repro_torch.core.storage.
  LocalStore`);
* ``partner`` — partner-replica blob reads/writes;
* ``pfs`` — aggregated-file ``pwrite``/``pread`` through
  :class:`~repro_torch.core.storage.RealExecutor`.

Each ``(domain, op)`` stream keeps a monotonically increasing counter
(every *attempt* counts, including retries); a :class:`FaultSpec`
fires when its stream's counter reaches ``index``.

Fault kinds
-----------

=================  ======================================================
``transient_eio``  raises ``OSError(EIO)`` for ``count`` consecutive
                   attempts, then heals — the retry policy's bread and
                   butter.
``enospc``         raises ``OSError(ENOSPC)`` once — classified
                   permanent, never retried; the flush fails but stays
                   journal-resumable.
``torn_write``     writes only a prefix (``frac``) of the payload, then
                   raises ``OSError(EIO)`` — a retried attempt rewrites
                   the full extent (idempotent destinations).
``bit_flip``       silently flips one bit of the payload before the
                   write — caught later by CRC scrub, never by errno.
``stall``          sleeps ``delay`` seconds, then proceeds — exercises
                   deadline accounting without failing the op.
``node_crash``     drops node ``node``'s L1 directory mid-flush
                   (:meth:`~repro_torch.core.storage.LocalStore.drop_node`)
                   — subsequent source reads fall back to the partner
                   replica or fail the flush.
``outage``         the whole domain fails (``OSError(EIO)`` on every
                   op, both reads and writes) from attempt ``index``
                   until the window closes — ``duration`` seconds of
                   wall clock, or ``count`` ops when ``duration`` is 0,
                   or an explicit :meth:`FaultPlan.heal`.  The signal
                   the PFS circuit breaker exists to absorb.
``brownout``       sustained high latency: every op in the domain
                   sleeps ``delay`` seconds for the same window shape
                   as ``outage`` — slow, not failing.
``straggler``      node ``node`` is slow for the *whole armed phase*:
                   every op that reports that node sleeps ``delay``
                   seconds — exercises hedged reads and reader
                   demotion, not retries.
=================  ======================================================

``outage``/``brownout``/``straggler`` are *windowed* kinds: they are
listed in :data:`FAULT_KINDS_V2` but deliberately **not** in the
:data:`FAULT_KINDS` default of :meth:`FaultPlan.generate`, so existing
seeded chaos schedules (``benchmarks/chaos.py``) are byte-identical to
before.

Phases
------

Specs carry a ``phase`` (``"save"`` or ``"verify"``); only specs of
the currently armed phase fire.  :meth:`FaultPlan.arm` switches phase
and zeroes all counters, so a chaos schedule can target the
save→flush window and, separately, the scrub→restore window with
index spaces that both start at zero.
"""
from __future__ import annotations

import errno
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

FAULT_KINDS = (
    "transient_eio",
    "enospc",
    "torn_write",
    "bit_flip",
    "stall",
    "node_crash",
)
#: windowed availability kinds (PR 8) — valid in specs, excluded from
#: the ``generate`` default so old seeds replay identically
WINDOW_KINDS = ("outage", "brownout", "straggler")
FAULT_KINDS_V2 = FAULT_KINDS + WINDOW_KINDS
DOMAINS = ("l1", "partner", "pfs")
PHASES = ("save", "verify")

#: kinds that errno-classify as transient — a schedule made only of
#: these must produce zero ``flush_errors`` (the retry layer heals them)
TRANSIENT_KINDS = frozenset({"transient_eio", "stall"})


@dataclass
class FaultSpec:
    """One scheduled fault: ``kind`` fires at attempt ``index`` of the
    ``(domain, op)`` operation stream while ``phase`` is armed."""

    kind: str
    domain: str = "pfs"
    op: str = "write"  # "write" | "read"
    index: int = 0
    count: int = 1  # consecutive failing attempts (transient_eio)
    phase: str = "save"
    frac: float = 0.5  # fraction actually written by a torn write
    bit: int = 0  # bit position flipped by bit_flip (mod payload bits)
    delay: float = 0.02  # stall / brownout / straggler seconds per op
    node: int = 0  # node dropped by node_crash, or slowed by straggler
    duration: float = 0.0  # outage/brownout wall-clock window (0 -> count ops)

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS_V2:
            raise ValueError(f"unknown fault kind: {self.kind!r}")
        if self.domain not in DOMAINS:
            raise ValueError(f"unknown fault domain: {self.domain!r}")
        if self.op not in ("write", "read"):
            raise ValueError(f"unknown fault op: {self.op!r}")
        if self.phase not in PHASES:
            raise ValueError(f"unknown fault phase: {self.phase!r}")


def flip_bit(data, bit: int) -> bytes:
    """Return ``data`` with one bit flipped (position ``bit`` modulo
    the payload's bit length); empty payloads pass through."""
    buf = bytearray(data)
    if not buf:
        return bytes(buf)
    b = bit % (len(buf) * 8)
    buf[b >> 3] ^= 1 << (b & 7)
    return bytes(buf)


class FaultPlan:
    """A seeded, deterministic schedule of :class:`FaultSpec`\\ s.

    Thread-safe: the per-``(domain, op)`` attempt counters and the
    armed-spec state live behind one lock, so concurrent writer/reader
    threads observe a single global index space per stream.  Which
    thread's attempt lands on a scheduled index may vary with
    interleaving; *that an attempt does*, and what happens to it, is
    fixed by the seed.

    ``fired`` records every injection as ``(kind, domain, op, index)``
    tuples for assertions and harness telemetry.
    """

    def __init__(self, specs: Sequence[FaultSpec], *, seed: Optional[int] = None):
        self.specs = list(specs)
        self.seed = seed
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._remaining = {id(s): max(1, int(s.count)) for s in self.specs}
        self._armed: dict = {}  # (domain, op) -> spec currently failing
        self._phase = "save"
        self._local = None  # bound LocalStore (node_crash target)
        self._enabled = True
        # domain -> (spec, deadline_monotonic | None, ops_left | None)
        self._windows: dict = {}
        self._straggler_fired: set = set()
        self.window_hits: dict = {}  # domain -> ops hit while a window was active
        self.fired: List[Tuple[str, str, str, int]] = []

    # ---- lifecycle --------------------------------------------------------

    def bind(self, local) -> None:
        """Attach the :class:`~repro_torch.core.storage.LocalStore` that
        ``node_crash`` specs drop nodes from (the manager does this)."""
        self._local = local

    def arm(self, phase: str) -> None:
        """Switch the active phase and zero every stream counter."""
        if phase not in PHASES:
            raise ValueError(f"unknown fault phase: {phase!r}")
        with self._lock:
            self._phase = phase
            self._enabled = True
            self._counters.clear()
            self._armed.clear()
            self._windows.clear()
            self._straggler_fired.clear()

    def disarm(self) -> None:
        """Stop injecting entirely (schedule exhausted / out of window)."""
        with self._lock:
            self._enabled = False
            self._windows.clear()

    def heal(self, domain: Optional[str] = None) -> None:
        """Close active outage/brownout windows (all domains, or one).

        Lets a harness end an op-count or long wall-clock window at an
        exact point instead of waiting out the clock.
        """
        with self._lock:
            if domain is None:
                self._windows.clear()
            else:
                self._windows.pop(domain, None)

    def outage_active(self, domain: str) -> bool:
        """True while an ``outage``/``brownout`` window covers ``domain``."""
        with self._lock:
            return self._window_check(domain) is not None

    @property
    def phase(self) -> str:
        return self._phase

    def fired_kinds(self) -> set:
        return {k for (k, _, _, _) in self.fired}

    # ---- injection surface -----------------------------------------------

    def _window_check(self, domain: str, consume: bool = False):
        """Return the spec of an active outage/brownout window covering
        ``domain`` (or ``None``), expiring stale windows.  Lock held by
        the caller; ``consume`` burns one op of an op-count window."""
        w = self._windows.get(domain)
        if w is None:
            return None
        spec, deadline, ops_left = w
        if deadline is not None and time.monotonic() >= deadline:
            del self._windows[domain]
            return None
        if ops_left is not None:
            if ops_left <= 0:
                del self._windows[domain]
                return None
            if consume:
                self._windows[domain] = (spec, deadline, ops_left - 1)
        return spec

    def on_op(
        self, domain: str, op: str, what: str = "", node: Optional[int] = None
    ) -> Optional[FaultSpec]:
        """Account one attempt of ``(domain, op)`` and inject its fault.

        Raises for ``transient_eio``/``enospc``/``torn-write-less``
        error kinds, sleeps for ``stall``, drops a node for
        ``node_crash``; returns the spec for the data-transforming
        kinds (``bit_flip``, ``torn_write``) so the write site can
        apply them, else ``None``.

        ``node`` identifies the L1/partner node or the PFS reader the
        op runs on — ``straggler`` specs match it; windowed
        ``outage``/``brownout`` specs cover every op of the domain
        regardless of node once activated at their stream ``index``.
        """
        sleep_s = 0.0
        with self._lock:
            if not self._enabled:
                return None
            key = (domain, op)
            idx = self._counters.get(key, 0)
            self._counters[key] = idx + 1
            # stragglers are ambient: every matching-node op of the
            # armed phase is slowed, no index bookkeeping
            for s in self.specs:
                if (
                    s.kind == "straggler"
                    and s.phase == self._phase
                    and s.domain == domain
                    and node is not None
                    and s.node == node
                ):
                    sleep_s += max(0.0, s.delay)
                    fkey = (id(s), self._phase)
                    if fkey not in self._straggler_fired:
                        self._straggler_fired.add(fkey)
                        self.fired.append((s.kind, domain, op, idx))
            wspec = self._window_check(domain, consume=True)
            if wspec is not None:
                self.window_hits[domain] = self.window_hits.get(domain, 0) + 1
            spec = None
            if wspec is None:
                spec = self._armed.get(key)
                if spec is None:
                    for s in self.specs:
                        if (
                            s.phase == self._phase
                            and s.domain == domain
                            and s.op == op
                            and s.index == idx
                            and self._remaining[id(s)] > 0
                            and s.kind != "straggler"
                        ):
                            spec = s
                            break
                if spec is not None:
                    self._remaining[id(spec)] -= 1
                    if spec.kind == "transient_eio" and self._remaining[id(spec)] > 0:
                        self._armed[key] = spec  # keep failing the next attempts
                    else:
                        self._armed.pop(key, None)
                    self.fired.append((spec.kind, domain, op, idx))
                    if spec.kind in ("outage", "brownout"):
                        deadline = (
                            time.monotonic() + spec.duration
                            if spec.duration > 0
                            else None
                        )
                        ops_left = (
                            None
                            if spec.duration > 0
                            else max(0, int(spec.count) - 1)
                        )
                        self._windows[domain] = (spec, deadline, ops_left)
                        self.window_hits[domain] = (
                            self.window_hits.get(domain, 0) + 1
                        )
                        wspec = spec
                        spec = None  # handled as a window below
            local = self._local
        if sleep_s > 0.0:
            time.sleep(sleep_s)
        if wspec is not None:
            if wspec.kind == "outage":
                raise OSError(
                    errno.EIO, f"injected outage: {domain}/{op}[{idx}] {what}"
                )
            time.sleep(max(0.0, wspec.delay))  # brownout: slow, not failing
            return None
        if spec is None:
            return None
        if spec.kind == "transient_eio":
            raise OSError(
                errno.EIO, f"injected transient EIO: {domain}/{op}[{idx}] {what}"
            )
        if spec.kind == "enospc":
            raise OSError(
                errno.ENOSPC, f"injected ENOSPC: {domain}/{op}[{idx}] {what}"
            )
        if spec.kind == "stall":
            time.sleep(max(0.0, spec.delay))
            return None
        if spec.kind == "node_crash":
            if local is not None:
                local.drop_node(spec.node)
            return None
        return spec  # bit_flip / torn_write: caller applies

    # ---- seeded generation ------------------------------------------------

    #: minimum index gap between same-stream specs — keeps the worst
    #: consecutive-failure run below the default retry budget
    MIN_GAP = 8

    @staticmethod
    def generate(
        seed: int,
        *,
        n_faults: Optional[int] = None,
        kinds: Sequence[str] = FAULT_KINDS,
        domains: Sequence[str] = DOMAINS,
        max_index: int = 40,
        n_nodes: int = 2,
        verify_reads: bool = True,
    ) -> "FaultPlan":
        """Build a deterministic schedule from ``seed``.

        Constraints keep schedules *survivable by design*: transient
        counts stay ≤ 2, same-stream indices are spaced ≥
        :attr:`MIN_GAP` apart (a retry run can never eat through more
        than one transient spec plus its neighbour), and verify-phase
        specs are restricted to read-side transient kinds so a restore
        is delayed, never doomed, by them.
        """
        rng = random.Random(seed)
        n = n_faults if n_faults is not None else rng.randint(1, 3)
        specs: List[FaultSpec] = []
        used: dict = {}  # (phase, domain, op) -> list of taken indices
        for _ in range(int(n)):
            kind = rng.choice(list(kinds))
            if kind == "node_crash":
                domain, op = "pfs", "write"
            elif kind in ("enospc", "torn_write", "bit_flip"):
                domain, op = rng.choice(list(domains)), "write"
            else:  # transient_eio / stall: either side
                domain = rng.choice(list(domains))
                op = rng.choice(["write", "read"]) if domain != "partner" else "write"
            phase = "save"
            if (
                verify_reads
                and kind in TRANSIENT_KINDS
                and rng.random() < 0.25
            ):
                phase, domain, op = "verify", "pfs", "read"
            key = (phase, domain, op)
            taken = used.setdefault(key, [])
            for _try in range(16):
                idx = rng.randrange(0, max(1, max_index))
                if all(abs(idx - t) >= FaultPlan.MIN_GAP for t in taken):
                    break
            else:
                continue  # stream too crowded: drop this fault
            taken.append(idx)
            specs.append(
                FaultSpec(
                    kind=kind,
                    domain=domain,
                    op=op,
                    index=idx,
                    count=rng.randint(1, 2) if kind == "transient_eio" else 1,
                    phase=phase,
                    frac=rng.uniform(0.1, 0.9),
                    bit=rng.randrange(0, 1 << 20),
                    delay=rng.uniform(0.005, 0.03),
                    node=rng.randrange(0, max(1, n_nodes)),
                )
            )
        return FaultPlan(specs, seed=seed)

    @staticmethod
    def generate_fleet(
        seed: int,
        n_tenants: int,
        *,
        victim: Optional[int] = None,
        outage_duration: float = 0.0,
        outage_ops: int = 24,
        transient_rate: float = 0.25,
        max_index: int = 40,
    ) -> List["FaultPlan"]:
        """Per-tenant schedules for the multi-tenant (control-plane)
        path, derived from ONE seed.

        One tenant — ``victim``, or a seeded pick — gets a windowed PFS
        ``outage`` (wall-clock ``outage_duration`` seconds, or
        ``outage_ops`` write ops when the duration is 0) opening at a
        seeded op index of its *own* flush stream.  Because tenants
        share one PFS, the harness is expected to wire all tenants'
        managers to one :class:`~repro_torch.core.storage.StorageHealth`
        (the control plane does): the victim's giveups open the shared
        circuit, and the invariant under test is isolation — other
        tenants' **L1 saves** keep succeeding (their flushes may park,
        that is the breaker doing its job) and the post-heal drain
        order honors tenant priority.  Non-victim tenants get either a
        clean plan or (with probability ``transient_rate`` each) one
        survivable L1-side transient, so the multi-tenant path also
        sees the retry machinery without a second breaker trip.
        """
        if n_tenants <= 0:
            raise ValueError("n_tenants must be positive")
        rng = random.Random(seed)
        v = rng.randrange(n_tenants) if victim is None else int(victim)
        plans: List[FaultPlan] = []
        for t in range(n_tenants):
            if t == v:
                specs = [
                    FaultSpec(
                        kind="outage",
                        domain="pfs",
                        op="write",
                        index=rng.randrange(0, max(1, max_index // 2)),
                        count=max(1, int(outage_ops)),
                        duration=float(outage_duration),
                    )
                ]
            elif rng.random() < transient_rate:
                specs = [
                    FaultSpec(
                        kind="transient_eio",
                        domain="l1",
                        op="write",
                        index=rng.randrange(0, max(1, max_index)),
                        count=rng.randint(1, 2),
                    )
                ]
            else:
                specs = []
            plans.append(FaultPlan(specs, seed=seed * 1009 + t))
        return plans


def inject_write(
    faults: Optional[FaultPlan],
    domain: str,
    what: str,
    data,
    write_fn: Callable,
    node: Optional[int] = None,
) -> None:
    """Run one write through the injection surface.

    ``write_fn(buf)`` performs the raw write.  Error kinds raise before
    any byte lands; ``bit_flip`` corrupts the payload silently;
    ``torn_write`` writes a prefix and then raises ``EIO`` (the retry
    layer rewrites the full extent — destinations are idempotent).
    """
    spec = (
        faults.on_op(domain, "write", what, node=node) if faults is not None else None
    )
    if spec is None:
        write_fn(data)
        return
    if spec.kind == "bit_flip":
        write_fn(flip_bit(data, spec.bit))
        return
    if spec.kind == "torn_write":
        n = max(1, int(len(data) * spec.frac)) if len(data) else 0
        write_fn(bytes(data)[:n])
        raise OSError(errno.EIO, f"injected torn write: {domain} {what}")
    write_fn(data)  # pragma: no cover - no other data-transforming kinds
