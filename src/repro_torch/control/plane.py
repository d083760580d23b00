"""ControlPlane: N concurrent jobs sharing one PFS through a single
arbitrated checkpoint runtime.

Counterpart of ``repro/control/plane.py``. The device every tenant's
manager runs on (its pre-codec pass and its restored leaves) is the
plane's, not a tenant's: ``ControlPlane(root, device=...)`` passes it to
every manager it builds and never writes it to ``registry.json``, so a
registry written by either package is recovered by the other.

One ``CheckpointManager`` owns one training run; nothing in the core
runtime arbitrates *between* runs — yet production clusters (and the
paper's motivating workloads) run many jobs whose checkpoint traffic
collides on the same parallel filesystem.  The control plane is that
missing arbitration layer:

* **Registry** — ``register_job`` creates a tenant namespace
  (``<root>/jobs/<name>``) and persists its record (priority, weight,
  GC policy, geometry, pins, config) in ``<root>/control/registry.json``
  next to the PFS manifests, atomically; a fresh ``ControlPlane`` over
  the same root recovers every job after a crash or restart
  (``attach_job``).
* **Bandwidth quotas** — one global ``flush_bw_cap`` is split across
  tenants by a :class:`~repro_torch.core.storage.FairShareLimiter`
  (weighted fair share, idle shares redistributed), each tenant's
  manager charging its own leaf exactly where a single-job manager
  charges its private :class:`~repro_torch.core.storage.TokenBucket`.
* **Admission** — every manager shares one
  :class:`~repro_torch.core.admission.AdmissionController`, turning
  ``max_pending_flushes`` into a cluster-wide pending-flush budget
  with priority preemption (a queued low-priority flush parks as a
  journaled ``flush_partial`` and drains later).
* **Shared breaker** — all tenants feed one
  :class:`~repro_torch.core.storage.StorageHealth`: the PFS that went away
  went away for everyone, so tenant A's giveups open the circuit
  tenant B's flushes must respect, while B's L1 saves stay untouched.
* **Serving** — fleets subscribe to a tenant's flush-done events
  *through the plane* (``subscribe``), not a private manager handle.

The plane is a single-process arbiter by design, mirroring the rest of
this harness: tenants are threads sharing one storage tree, which is
exactly the contention surface the aggregation strategies target.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import re
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.admission import AdmissionController
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.engine import CheckpointConfig, CheckpointManager
from repro_torch.core.storage import FairShareLimiter, StorageHealth

log = logging.getLogger(__name__)

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


@dataclass
class JobRecord:
    """One tenant's persisted registry entry."""

    name: str
    priority: float = 1.0
    weight: float = 1.0
    keep_n: Optional[int] = None
    n_nodes: int = 1
    procs_per_node: int = 1
    pinned: List[int] = field(default_factory=list)
    config: Dict[str, Any] = field(default_factory=dict)
    created_at: float = 0.0

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "JobRecord":
        return cls(**{k: d[k] for k in d if k in cls.__dataclass_fields__})


class ControlPlane:
    """The multi-tenant checkpoint arbiter over one PFS root.

    ``device`` is where every tenant's manager runs ("cuda" needs a GPU:
    ``register_job`` raises without one; pass "cpu" explicitly to run on
    the host).  ``flush_bw_cap`` is the *global* PFS write budget in bytes/s
    (0 = unthrottled: tenants still share admission and the breaker,
    but not a bandwidth quota).  ``max_pending_flushes`` is the
    cluster-wide pending-flush budget all tenants draw from.
    """

    def __init__(
        self,
        root: str,
        *,
        device: str = "cuda",
        flush_bw_cap: float = 0.0,
        max_pending_flushes: int = 2,
        health_min_ops: int = 8,
        health_error_threshold: float = 0.5,
        health_cooldown: float = 2.0,
    ):
        self.root = Path(root)
        self.device = device
        self.control_dir = self.root / "control"
        self.jobs_dir = self.root / "jobs"
        self.control_dir.mkdir(parents=True, exist_ok=True)
        self.jobs_dir.mkdir(parents=True, exist_ok=True)
        self.flush_bw_cap = float(flush_bw_cap)
        self.limiter: Optional[FairShareLimiter] = (
            FairShareLimiter(self.flush_bw_cap)
            if self.flush_bw_cap > 0
            else None
        )
        self.admission = AdmissionController(max_pending_flushes)
        self.storage_health = StorageHealth(
            min_ops=health_min_ops,
            error_threshold=health_error_threshold,
            cooldown=health_cooldown,
        )
        self._lock = threading.RLock()
        self._records: Dict[str, JobRecord] = {}
        self._managers: Dict[str, CheckpointManager] = {}
        self._load_registry()

    # ------------------------------------------------------------- registry

    @property
    def registry_path(self) -> Path:
        return self.control_dir / "registry.json"

    def _load_registry(self) -> None:
        p = self.registry_path
        if not p.exists():
            return
        doc = json.loads(p.read_text())
        for name, rec in doc.get("jobs", {}).items():
            self._records[name] = JobRecord.from_json(rec)

    def _persist_registry(self) -> None:
        """Atomic write: the registry is the crash-recovery source of
        truth for every tenant's policy, so a torn write must never be
        observable."""
        doc = {
            "version": 1,
            "flush_bw_cap": self.flush_bw_cap,
            "max_pending_flushes": self.admission.total,
            "jobs": {n: r.to_json() for n, r in self._records.items()},
        }
        tmp = self.registry_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(doc, indent=1, sort_keys=True))
        tmp.replace(self.registry_path)

    # ------------------------------------------------------------ job verbs

    def register_job(
        self,
        name: str,
        cluster: ClusterSpec,
        *,
        priority: float = 1.0,
        weight: Optional[float] = None,
        keep_n: Optional[int] = None,
        faults: Optional[Any] = None,
        **config_kw: Any,
    ) -> CheckpointManager:
        """Create a tenant and return its arbitrated manager.

        ``config_kw`` is forwarded to :class:`CheckpointConfig` (and
        persisted, so it must be JSON-serializable; the device is the
        plane's and may not appear there); ``weight``
        defaults to ``priority`` so the bandwidth quota follows the
        preemption order unless the operator splits them.  ``faults``
        (a seeded :class:`~repro_torch.core.faults.FaultPlan`) is a harness
        surface and is NOT persisted.
        """
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid job name {name!r}")
        if "device" in config_kw:
            raise ValueError(
                "the device is the plane's: pass ControlPlane(device=...)"
            )
        with self._lock:
            if name in self._records:
                raise ValueError(
                    f"job {name!r} already registered; use attach_job()"
                )
            rec = JobRecord(
                name=name,
                priority=float(priority),
                weight=float(weight if weight is not None else priority),
                keep_n=keep_n,
                n_nodes=cluster.n_nodes,
                procs_per_node=cluster.procs_per_node,
                config=dict(config_kw),
                created_at=time.time(),
            )
            mgr = self._build_manager(rec, cluster, faults=faults)
            self._records[name] = rec
            self._managers[name] = mgr
            self._persist_registry()
        log.info(
            "control plane: registered job %r (priority=%.2f weight=%.2f)",
            name, rec.priority, rec.weight,
        )
        return mgr

    def attach_job(
        self, name: str, *, cluster: Optional[ClusterSpec] = None
    ) -> CheckpointManager:
        """Rebuild a registered tenant's manager (crash-restart path).

        Geometry and config come from the persisted record;
        ``cluster`` overrides the recorded geometry (custom
        node/PFS specs are not persisted — pass them here)."""
        with self._lock:
            if name in self._managers:
                return self._managers[name]
            rec = self._records.get(name)
            if rec is None:
                raise KeyError(f"job {name!r} not in the registry")
            c = cluster if cluster is not None else ClusterSpec(
                n_nodes=rec.n_nodes, procs_per_node=rec.procs_per_node
            )
            mgr = self._build_manager(rec, c)
            self._managers[name] = mgr
            return mgr

    def _build_manager(
        self,
        rec: JobRecord,
        cluster: ClusterSpec,
        *,
        faults: Optional[Any] = None,
    ) -> CheckpointManager:
        cfg = CheckpointConfig(
            root=str(self.jobs_dir / rec.name),
            cluster=cluster,
            keep_n=rec.keep_n,
            device=self.device,
            **rec.config,
        )
        leaf = None
        if self.limiter is not None:
            try:
                leaf = self.limiter.register(rec.name, rec.weight)
            except ValueError:
                # re-attach after a detach that never unregistered
                self.limiter.unregister(rec.name)
                leaf = self.limiter.register(rec.name, rec.weight)
        try:
            mgr = CheckpointManager(
                cfg,
                faults=faults,
                limiter=leaf,
                admission=self.admission,
                storage_health=self.storage_health,
                tenant=rec.name,
                priority=rec.priority,
            )
        except BaseException:
            if leaf is not None:
                self.limiter.unregister(rec.name)
            raise
        for s in rec.pinned:
            mgr.pin_step(s)
        return mgr

    def manager(self, name: str) -> CheckpointManager:
        with self._lock:
            if name not in self._managers:
                return self.attach_job(name)
            return self._managers[name]

    def jobs(self) -> List[str]:
        with self._lock:
            return sorted(self._records)

    def record(self, name: str) -> JobRecord:
        with self._lock:
            return self._records[name]

    # ----------------------------------------------------- per-tenant verbs

    def list_steps(self, name: str, level: str = "pfs") -> List[int]:
        """A tenant's restorable steps — and ONLY that tenant's: each
        job namespaces its manifests under its own subtree, so no
        cross-tenant step can ever appear here."""
        return self.manager(name).steps(level)

    def pin(self, name: str, step: int) -> None:
        """Pin ``step`` against GC/supersession/eviction/preemption;
        persisted, so pins survive a control-plane restart."""
        with self._lock:
            self.manager(name).pin_step(step)
            rec = self._records[name]
            if step not in rec.pinned:
                rec.pinned.append(step)
                rec.pinned.sort()
            self._persist_registry()

    def unpin(self, name: str, step: int) -> None:
        with self._lock:
            self.manager(name).unpin_step(step)
            rec = self._records[name]
            if step in rec.pinned:
                rec.pinned.remove(step)
            self._persist_registry()

    def set_gc_policy(self, name: str, keep_n: Optional[int]) -> None:
        """Per-tenant retention: replace the tenant's ``keep_n`` (None
        disables GC for that tenant).  Applies from the next flush."""
        with self._lock:
            mgr = self.manager(name)
            mgr.cfg = dataclasses.replace(mgr.cfg, keep_n=keep_n)
            self._records[name].keep_n = keep_n
            self._persist_registry()

    def restore_to_geometry(
        self,
        name: str,
        target: Any,
        cluster: ClusterSpec,
        *,
        step: Optional[int] = None,
        sharding_fn: Optional[Callable[[str, Any], Any]] = None,
    ) -> Any:
        """Elastic restore of a tenant's step onto a DIFFERENT geometry
        (the aggregated formats are geometry-independent on the read
        side).  Runs through a transient read-only manager over the
        tenant's subtree so the live manager's flush runtime is never
        disturbed."""
        with self._lock:
            live = self.manager(name)
            cfg = dataclasses.replace(
                live.cfg,
                cluster=cluster,
                async_flush=False,
                auto_resume=False,
            )
        rm = CheckpointManager(cfg, storage_health=self.storage_health)
        try:
            return rm.restore(target, step=step, sharding_fn=sharding_fn)
        finally:
            rm.close()

    def subscribe(self, name: str, fn: Callable[[int], None]) -> None:
        """Flush-done events for one tenant, through the plane — the
        handle serving fleets are expected to use."""
        self.manager(name).subscribe(fn)

    def unsubscribe(self, name: str, fn: Callable[[int], None]) -> None:
        self.manager(name).unsubscribe(fn)

    # ------------------------------------------------------ fleet lifecycle

    def drain(self) -> List[str]:
        """One probe/drain pass over every attached tenant, highest
        priority first — after an outage heals, the most important
        job's parked flushes reach the PFS before anyone else's.
        Returns tenant names in the order they were drained."""
        with self._lock:
            order = sorted(
                self._managers,
                key=lambda n: (-self._records[n].priority, n),
            )
        for n in order:
            self._managers[n].health_check()
        return order

    def health(self) -> Dict[str, Any]:
        """Shared-breaker state plus per-tenant manager health."""
        out: Dict[str, Any] = {
            "pfs_circuit": self.health_state(),
            "admission": {
                "total": self.admission.total,
                "held": self.admission.held(),
                "preemptions": self.admission.preemptions,
            },
            "tenants": {},
        }
        with self._lock:
            items = list(self._managers.items())
        for n, m in items:
            h = m.health()
            out["tenants"][n] = {
                "mode": h.mode,
                "parked_steps": list(h.parked_steps),
                "flush_errors": len(m.flush_errors),
            }
        return out

    def health_state(self) -> str:
        return self.storage_health.state("pfs")

    def close(self, *, timeout: float = 60.0) -> None:
        """Close every attached manager (draining their queues) and
        release their quota leaves.  The registry stays on disk — a
        new plane over the same root recovers every job."""
        with self._lock:
            managers = list(self._managers.items())
            self._managers.clear()
        errs: List[BaseException] = []
        for n, m in managers:
            try:
                m.close(timeout=timeout)
            except BaseException as e:
                errs.append(e)
            if self.limiter is not None:
                self.limiter.unregister(n)
        if errs:
            raise errs[0]
