"""ServeFleet: N replicas cold-started from ONE aggregated checkpoint,
kept current by a snapshot hot-swap follower.

Counterpart of ``repro/serve/fleet.py``. This is the fleet-restore
workload the paper's aggregation strategies exist for: every replica
pulls its weights out of the same aggregated step through byte-balanced
read plans computed from the *serving* geometry (``assign_readers``
over the step's :class:`FileLayout`, independent of how many ranks
wrote it), streams layers in priority order so time-to-first-token
beats a full restore, and shares one node-local
:class:`~repro_torch.serve.stream.ChunkCache` so co-located replicas
decode each chunk once per node.

The follower watches the PFS for the newest ``flush_done`` step; it
never adopts a ``flush_partial``, ``superseded``, or ``quarantined``
manifest, which is exactly the trust rule
:meth:`~repro_torch.core.engine.CheckpointManager.steps` encodes.  While
the manager reports itself ``degraded`` (PFS circuit open, new steps
parked on L1) the follower defers adoption entirely: nothing newer
than what it already serves can have reached ``flush_done``, and the
post-heal drain will wake it normally.  It rolls every server
atomically via :meth:`Server.swap_params`.  In-flight generates finish
on the version they captured; nothing is dropped or torn.  When the
fleet shares a process with training it also subscribes to the
manager's flush-done hook, so swaps trail flushes by a wakeup instead
of a poll interval.

Uploads: :func:`~repro_torch.serve.stream.stream_restore` copies each
group onto the device with a blocking copy on the loading thread's
current stream (the default stream, which the generates share), so the
new params are resident before any server is swapped onto them.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.plan import assign_readers
from repro_torch.serve.engine import ServeConfig, Server
from repro_torch.serve.stream import ChunkCache, StreamedRestore, stream_restore

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class FleetConfig:
    n_servers: int = 2
    serve: ServeConfig = ServeConfig()
    priority_blocks: int = 1          # TTFT prefix: embed + this many blocks
    cache_bytes: int = 256 << 20      # node-local decoded-chunk cache
    poll_interval: float = 0.05       # follower PFS poll cadence (seconds)


@dataclass
class FleetColdStart:
    """Telemetry of one concurrent fleet cold start."""

    step: int
    total_s: float                    # slowest replica fully resident
    ttft_s: List[float]               # per-replica priority-prefix time
    total_bytes: int                  # per-replica params bytes
    cache: Optional[Dict[str, int]]   # shared ChunkCache stats snapshot


class ServeFleet:
    def __init__(
        self,
        model: Any,
        manager: Any,
        params_template: Any,
        *,
        prefix: str = "['params']",
        cfg: FleetConfig = FleetConfig(),
        sharding_fn: Optional[Callable[[str, Any], Any]] = None,
    ):
        self.model = model
        self.manager = manager
        self.template = params_template
        self.prefix = prefix
        self.cfg = cfg
        self.sharding_fn = sharding_fn
        self.servers: List[Server] = []
        self.current_step: Optional[int] = None
        self.swap_history: List[Tuple[int, float]] = []
        # one decoded-chunk cache per node: adopt the manager's if some
        # other co-located fleet already installed one, else install ours
        existing = getattr(manager, "chunk_cache", None)
        self.cache: ChunkCache = (
            existing if existing is not None else ChunkCache(cfg.cache_bytes)
        )
        manager.chunk_cache = self.cache
        self._swap_lock = threading.Lock()
        self._follower: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._subscribed: Optional[Callable[[int], None]] = None
        # Control-plane attachment (multi-tenant runs): set by
        # via_control_plane(); the follower then subscribes through the
        # plane's per-tenant event surface instead of the raw manager.
        self._plane: Optional[Any] = None
        self._job: Optional[str] = None

    @classmethod
    def via_control_plane(
        cls,
        model: Any,
        plane: Any,
        job: str,
        params_template: Any,
        *,
        prefix: str = "['params']",
        cfg: FleetConfig = FleetConfig(),
        sharding_fn: Optional[Callable[[str, Any], Any]] = None,
    ) -> "ServeFleet":
        """Build a fleet that serves one *tenant* of a
        :class:`~repro_torch.control.ControlPlane`.

        The manager handle is resolved through the plane's registry
        (``plane.manager(job)``) and the hot-swap follower subscribes
        via ``plane.subscribe(job, ...)``: the fleet never owns a
        private manager, so the tenant's quotas, shared breaker state
        and admission budget all apply to the serving path's reads and
        the training path's flushes alike."""
        fleet = cls(
            model,
            plane.manager(job),
            params_template,
            prefix=prefix,
            cfg=cfg,
            sharding_fn=sharding_fn,
        )
        fleet._plane = plane
        fleet._job = job
        return fleet

    # ------------------------------------------------------------ cold start

    def _stream(self, step: int) -> StreamedRestore:
        return stream_restore(
            self.manager,
            self.template,
            self.prefix,
            step=step,
            priority_blocks=self.cfg.priority_blocks,
            sharding_fn=self.sharding_fn,
        )

    def cold_start(self, step: Optional[int] = None) -> FleetColdStart:
        """Boot ``cfg.n_servers`` replicas concurrently from one step.

        The step is pinned once (newest restorable, or ``step``);
        every replica streams THAT step, so a flush landing mid-boot
        cannot split the fleet across versions.  Each replica's stream
        issues its own aggregated read plans (byte-balanced over the
        serving geometry) and shares the node-local chunk cache, so
        with a chunk-framed codec replicas after the first decode
        almost nothing."""
        n = self.cfg.n_servers
        pinned, _ = self.manager.leaf_catalog(step=step, prefix=self.prefix)
        results: List[Optional[StreamedRestore]] = [None] * n
        errors: List[BaseException] = []
        t0 = time.perf_counter()

        def boot(i: int) -> None:
            try:
                results[i] = self._stream(pinned)
            except BaseException as e:  # surfaced to the caller below
                errors.append(e)

        threads = [
            threading.Thread(target=boot, args=(i,), name=f"fleet-boot-{i}")
            for i in range(n)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        total = time.perf_counter() - t0
        self.servers = [
            Server(self.model, sr.params, self.cfg.serve) for sr in results
        ]
        self.current_step = pinned
        return FleetColdStart(
            step=pinned,
            total_s=total,
            ttft_s=[sr.ttft_s for sr in results],
            total_bytes=results[0].total_bytes if results else 0,
            cache=self.cache.stats(),
        )

    def reader_balance(self, step: Optional[int] = None) -> Dict[str, Any]:
        """How this fleet's reads spread over the serving geometry.

        Inverts the step's stored layout into the per-reader byte load
        ``assign_readers`` produces for the *serving* cluster: the
        balance every cold-start read plan actually uses, regardless of
        the (possibly larger, possibly gone) training geometry that
        wrote the step."""
        s = step if step is not None else self.current_step
        if s is None:
            s, _ = self.manager.leaf_catalog(prefix=self.prefix)
        man = self.manager._manifest_pfs(s)
        sizes = np.asarray([r.stored_size for r in man.ranks], np.int64)
        n_readers = self.manager.cluster.n_nodes
        readers = assign_readers(sizes, n_readers)
        per = np.zeros(n_readers, np.int64)
        np.add.at(per, readers, sizes)
        return {
            "step": s,
            "n_readers": n_readers,
            "readers": readers,
            "bytes_per_reader": per,
            "max_bytes": int(per.max()) if len(per) else 0,
            "min_bytes": int(per.min()) if len(per) else 0,
        }

    # -------------------------------------------------------------- hot swap

    def swap_to(self, step: Optional[int] = None) -> int:
        """Roll every server onto ``step`` (default: newest flush_done).

        The new params are streamed ONCE and then swapped into each
        server atomically (replicas share the loaded tree: same-node
        fleet semantics).  Returns the step now being served; a no-op
        (already serving the newest) returns the current step without
        bumping any server's version."""
        with self._swap_lock:
            pinned, _ = self.manager.leaf_catalog(step=step, prefix=self.prefix)
            if (
                step is None
                and self.current_step is not None
                and pinned <= self.current_step
            ):
                return self.current_step
            t0 = time.perf_counter()
            sr = self._stream(pinned)
            for srv in self.servers:
                srv.swap_params(sr.params)
            self.current_step = pinned
            self.swap_history.append((pinned, time.perf_counter() - t0))
            return pinned

    def start_follower(self) -> None:
        """Watch for newer ``flush_done`` steps and hot-swap onto them.

        Polls ``manager.steps("pfs")`` (which lists ONLY flush_done
        manifests, so partial/superseded/quarantined steps are
        structurally invisible to the follower) every
        ``cfg.poll_interval`` seconds, and additionally wakes on the
        manager's flush-done notification when training shares the
        process.  Swap failures of the storage or the catalog (an
        ``OSError``, e.g. the step got quarantined between listing and
        read, a ``KeyError`` for leaves the step lacks, a ``ValueError``
        for a torn manifest) are logged and retried next round, never
        fatal to serving.  Any other error (a device error in the upload)
        is logged and ends the follower: it is not retried, and the
        servers keep serving the version they have."""
        if self._follower is not None:
            return
        self._stop.clear()

        def on_flush_done(step: int) -> None:
            self._wake.set()

        self._subscribed = on_flush_done
        if self._plane is not None:
            self._plane.subscribe(self._job, on_flush_done)
        elif hasattr(self.manager, "subscribe"):
            self.manager.subscribe(on_flush_done)

        deferred = False  # degraded-mode notice logged once per outage

        def loop() -> None:
            nonlocal deferred
            while not self._stop.is_set():
                self._wake.wait(self.cfg.poll_interval)
                self._wake.clear()
                if self._stop.is_set():
                    return
                try:
                    health_fn = getattr(self.manager, "health", None)
                    if callable(health_fn):
                        mh = health_fn()
                        if getattr(mh, "mode", "normal") == "degraded":
                            # PFS circuit open: every step listed now
                            # predates the outage, and anything newer is
                            # parked on L1; there is nothing new the
                            # follower can trust until the post-heal
                            # drain publishes flush_done manifests.
                            if not deferred:
                                deferred = True
                                log.warning(
                                    "fleet follower: manager degraded "
                                    "(PFS circuit open); deferring "
                                    "adoption until the drain completes"
                                )
                            continue
                        if deferred:
                            deferred = False
                            log.info(
                                "fleet follower: manager healthy again; "
                                "resuming adoption"
                            )
                    done = self.manager.steps("pfs")
                    if not done:
                        continue
                    newest = done[-1]
                    if (
                        self.current_step is not None
                        and newest <= self.current_step
                    ):
                        continue
                    if self.manager.step_status(newest) != "flush_done":
                        continue  # raced a supersession/quarantine
                    self.swap_to(newest)
                    log.info("fleet follower adopted step %d", newest)
                except (OSError, KeyError, ValueError):
                    log.exception("fleet follower swap attempt failed")
                except Exception:
                    log.exception("fleet follower stopped: a swap failed "
                                  "outside the storage path")
                    return

        self._follower = threading.Thread(
            target=loop, name="fleet-follower", daemon=True
        )
        self._follower.start()

    def stop(self, *, timeout: float = 30.0) -> None:
        """Stop the follower (idempotent; servers keep serving).

        Raises ``RuntimeError`` if the follower thread is still alive
        after ``timeout`` seconds: a live thread holding a mid-swap
        stream must not be silently discarded, because it still shares
        the manager's read path and chunk cache.  The follower handle
        is kept so a later ``stop()`` can re-join it; the flush-done
        subscription is released either way so a wedged follower at
        least stops receiving wakeups."""
        self._stop.set()
        self._wake.set()
        follower = self._follower
        if follower is not None:
            follower.join(timeout=timeout)
        try:
            if follower is not None and follower.is_alive():
                log.error(
                    "fleet follower %r did not stop within %.1fs; "
                    "a swap is still in flight", follower.name, timeout,
                )
                raise RuntimeError(
                    f"fleet follower did not stop within {timeout:.1f}s"
                )
            self._follower = None
        finally:
            if self._subscribed is not None:
                if self._plane is not None:
                    self._plane.unsubscribe(self._job, self._subscribed)
                elif hasattr(self.manager, "unsubscribe"):
                    self.manager.unsubscribe(self._subscribed)
                self._subscribed = None

    def close(self, *, timeout: float = 30.0) -> None:
        """Stop the follower and release the fleet (idempotent).  The
        shutdown deadline is propagated to :meth:`stop`; the servers
        are released only once the follower is actually down.  The
        shared chunk cache stays on the manager: another fleet on this
        node keeps its contents warm."""
        self.stop(timeout=timeout)
        self.servers = []
