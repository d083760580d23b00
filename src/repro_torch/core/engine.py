"""CheckpointManager: multi-level asynchronous checkpointing with
pluggable aggregation (the paper's system, for PyTorch training).

Levels (VELOC semantics):

* **L0** — in-memory twin of the last encoded checkpoint (instant
  restart after a soft fault, survives nothing);
* **L1** — node-local files, written *blockingly* in the local phase
  (fast: node-local storage), optionally replicated to a partner node.
  The local phase is **fused and parallel**: per-rank encode + CRC + L1
  write run as one task each on the manager's local worker pool (its
  own pool — never queued behind async flush traffic), with fsyncs
  batched per node directory — the blocking window is parallel
  node-local bandwidth, not a per-rank Python loop
  (``parallel_local=False`` keeps the seed sequential path);
* **L2** — external PFS, written *asynchronously* by the active backend
  through one of the aggregation strategies (``file_per_process`` |
  ``posix`` | ``mpiio`` | ``stripe_aligned`` | ``gio_sync``).

``save()`` returns after the local phase; the flush proceeds on a
background worker (the "active backend") and training overlaps it.
``restore()`` prefers the deepest *complete* level and falls back
(L2 -> L1 -> L0 -> older steps) on missing/corrupt data — node failures
mid-flush therefore cost at most one checkpoint interval.

The background flush path is an **adaptive flush runtime** (see
docs/OPERATIONS.md for the full lifecycle state machine):

* **supersession** (``supersede_stale=True``): when step N+k is
  enqueued while step N is still queued or mid-flush, N's flush is
  skipped (queued) or cancelled at a safe request boundary
  (mid-flight, via a :class:`~repro_torch.core.storage.CancelToken` threaded
  through ``RealExecutor.execute``) — the PFS only ever converges
  toward the *newest* state, VELOC-style.  Protected steps are never
  superseded: full snapshots under ``zstd+delta`` (the ``delta_every``
  cadence anchors every delta chain needs), every step inside the
  *live* delta window (deltas chain through their predecessors, so a
  pending window step is transitively a base of the newest one —
  window steps only become stale when the next full snapshot opens a
  new window), and steps inside the ``keep_n`` newest window.
  Superseded steps stay restorable from L1
  (and from delta bases) through the normal fallback ladder, and are
  reported via :attr:`CheckpointManager.superseded_steps` — never as
  flush errors.
* **interference-aware throttling**: a global token bucket
  (``flush_bw_cap`` explicitly, or derived from the cluster's
  ``app_net_load`` as ``(1 - load) * nic_bw * n_nodes``) caps executor
  write bandwidth so the drain leaves the application its NIC share —
  the same policy :mod:`repro_torch.core.sim` prices, so the simulated and
  real trade-off curves agree.
* **crash-resumable flushes** (``resumable_flushes=True``): each flush
  first persists its manifest at ``status="flush_partial"`` (carrying
  the full columnar placement) and journals every completed extent
  (:class:`~repro_torch.core.storage.FlushJournal`); a flush interrupted by
  ``close()``, a fault hook or process death is finished by
  :meth:`CheckpointManager.resume_flushes` from the last completed
  extent instead of rewriting the whole checkpoint.  ``restore()``
  never trusts a ``flush_partial``/``superseded`` manifest — those
  steps fall back to L1 until resumed.
* **degraded-mode availability** (``health_enabled``, on by default
  with the retry layer): a per-domain
  :class:`~repro_torch.core.storage.StorageHealth` circuit breaker watches
  every retry attempt.  When the PFS circuit opens, flushes **park**
  at ``flush_partial`` (write set + journal persisted) instead of
  burning retry budgets — ``save()`` keeps succeeding on L0/L1, an
  ``l1_capacity_bytes`` budget applies backpressure by evicting the
  oldest non-pinned step, and the scheduler probes the PFS
  (:meth:`~repro_torch.core.storage.RealExecutor.probe_pfs`) until the
  circuit closes, then auto-drains the parked steps through
  ``resume_flushes()``.  :meth:`CheckpointManager.health` surfaces
  the mode / circuits / parked set; ``hedged_reads`` adds
  deadline-aware read hedging (PFS extent re-issued from L1/partner
  past the latency-quantile deadline) plus health-weighted reader
  assignment.  See docs/OPERATIONS.md "Degraded mode".

Elasticity: L2 checkpoints are mesh-agnostic (logical byte stream +
manifest); a checkpoint saved under one cluster geometry restores under
any other, and onto any device placement via ``sharding_fn``.

The PFS level is read through aggregated :class:`~repro_torch.core.plan.
ReadPlan`\\ s (manifest placement inverted into a ``FileLayout``, reads
balanced over the *restoring* cluster's nodes), and partial restore —
:meth:`CheckpointManager.restore_leaves` /
:meth:`CheckpointManager.restore_subtree` — pulls single leaves or
subtrees (e.g. just the params, for serving) out of an aggregated
checkpoint without reading the rest.
"""
from __future__ import annotations

import logging
import os
import queue
import random
import shutil
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field as dfield
from pathlib import Path
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.plan import (
    FlushPlan,
    assign_readers,
    build_read_plan,
    merge_intervals,
)
from repro_torch.core.serialize import (
    CHUNK_BASE,
    CHUNK_DELTA,
    DEFAULT_CHUNK_SIZE,
    Buffer,
    EncodedState,
    LeafEntry,
    Manifest,
    decode_blob_reference,
    decode_chunk_into,
    decode_state,
    decode_stream,
    default_codec_impl,
    deserialize_tree,
    encode_state,
    leaf_from_bytes,
    _run_grouped,
)
from repro_torch.core.admission import AdmissionController
from repro_torch.core.faults import FaultPlan
from repro_torch.core.storage import (
    CancelToken,
    CircuitOpenError,
    FlushCancelled,
    FlushJournal,
    FlushResult,
    HedgePolicy,
    LocalStore,
    ReadResult,
    RealExecutor,
    RetryPolicy,
    StorageHealth,
    TokenBucket,
    placement_from_plan,
)
from repro_torch.core.strategies import make_plan
from repro_torch.core.integrity import crc32
from repro_torch.utils.treelib import flatten_with_names, tree_map, unflatten

log = logging.getLogger("repro_torch.ckpt")


@dataclass
class CheckpointConfig:
    root: str
    cluster: ClusterSpec
    strategy: str = "stripe_aligned"
    strategy_kwargs: Dict[str, Any] = dfield(default_factory=dict)
    io_threads: int = 2
    codec: str = "none"                # none | zstd | zstd+delta
    # Chunk framing of compressed rank blobs: chunks of this size are
    # compressed/decompressed in parallel, delta-skipped when unchanged,
    # and fetched individually by partial restore.  0 = the seed
    # whole-blob framing (one compressor call per rank blob; also what
    # legacy checkpoints on disk use).
    chunk_size: int = DEFAULT_CHUNK_SIZE
    precodec: str = "none"             # none | int8 (device-side, lossy)
    # Device-resident pre-codec (requires codec zstd+delta and a
    # chunk_size that is a multiple of 4096): the state is serialized,
    # quantized (one grouped launch) and diffed against the previous
    # step *on device* by the fused CUDA pass, and only dirty chunks
    # are copied D2H.  ``stage(step, state)`` starts the pass
    # asynchronously so it overlaps the next train step; ``save()``
    # consumes the staged buffers (or stages synchronously when the
    # caller never staged).  False = the host reference path
    # (quantize_tree + serialize_tree + np.array_equal dirty scan),
    # kept as the executable spec the staged path is byte-identical to.
    device_precodec: bool = False
    # Align host-path rank splits to the global chunk_size grid (the
    # split encode_state_staged always uses).  Off, ranks balance by
    # bytes and interior ranks get tail chunks; on, host and device
    # encodings of the same state are chunk-for-chunk comparable.
    chunk_aligned_split: bool = False
    delta_every: int = 4               # full ckpt cadence under zstd+delta
    partner_replication: bool = False  # L1 peer replica (node-failure cover)
    keep_n: Optional[int] = None       # GC: retain this many newest steps
    async_flush: bool = True
    verify_on_restore: bool = True
    # Backpressure: at most this many flushes may be queued/in-flight;
    # save() blocks in the local phase once the PFS falls this far behind
    # (VELOC semantics: never let the async channel grow unboundedly).
    max_pending_flushes: int = 2
    # Local-phase execution.  parallel_local runs per-rank encode + CRC
    # + L1 write (+ partner replica) through the manager's own local
    # worker pool (kept separate from the executor's flush pool so the
    # blocking window never queues behind async PFS writes), with
    # fsyncs batched per node directory; zero_copy uses the
    # preallocated-buffer serializer whose codec-none blobs are
    # memoryview slices of the stream.  Turning either off selects the
    # seed reference path (sequential item loop, per-file fsync) that
    # the equivalence tests and benchmarks/save_phase.py compare against.
    parallel_local: bool = True
    zero_copy: bool = True
    local_workers: int = 0             # 0 = auto: min(16, max(8, 2*cpus))
    # ---- adaptive flush runtime (docs/OPERATIONS.md) ----
    # Supersession: skip/cancel stale queued or mid-flight flushes when
    # a newer step arrives.  Protected (never superseded): full
    # snapshots under zstd+delta (delta-chain anchors) and steps inside
    # the keep_n newest window.  Off by default: every save still
    # reaches the PFS unless you opt into newest-state-wins semantics.
    supersede_stale: bool = False
    # Throttle policy for executor writes (token bucket, bytes/s
    # globally).  > 0: explicit cap.  0: derived from the cluster's
    # app_net_load as (1 - load) * nic_bw * n_nodes when load > 0 (the
    # Tseng interference trade-off, priced identically by core/sim.py
    # via simulate_flush(flush_bw_cap=...)); no throttle when load = 0.
    flush_bw_cap: float = 0.0
    # Crash-resumable flushes: persist the manifest at "flush_partial"
    # (with its full placement) before writing and journal each
    # completed extent, so interrupted flushes finish via
    # resume_flushes() instead of restarting from byte zero.
    resumable_flushes: bool = True
    # ---- transient-retry I/O (self-healing runtime) ----
    # Every raw blob/extent read and write is retried on transient
    # errno failures (classify_error) with bounded exponential backoff
    # + jitter under a per-op deadline; retry_attempts <= 1 disables
    # the retry layer entirely (seed behaviour: first error wins).
    retry_attempts: int = 5
    retry_base_delay: float = 0.02     # seconds, doubles per attempt
    retry_max_delay: float = 0.5       # backoff ceiling per sleep
    retry_deadline: float = 30.0       # per-op wall-clock budget
    # ---- degraded-mode availability runtime (docs/OPERATIONS.md) ----
    # Storage health registry + circuit breaker per domain ("pfs",
    # "l1:n{j}", "partner:n{j}").  Fed per retry attempt; when the PFS
    # circuit opens, flushes *park* at flush_partial (journals intact)
    # instead of burning retry budgets, and the scheduler probes +
    # auto-drains via resume_flushes() once the circuit closes.
    # Requires the retry layer (retry_attempts > 1); health_enabled is
    # ignored without it.
    health_enabled: bool = True
    health_min_ops: int = 8            # window attempts before rate trips
    health_error_threshold: float = 0.5
    health_cooldown: float = 2.0       # open -> half-open probe delay (s)
    health_tick: float = 0.25          # idle scheduler probe/drain cadence
    # Re-queue flush_partial steps found under root at construction
    # (crash recovery without an explicit resume_flushes() call).  The
    # degraded-mode auto-drain reuses the same path.
    auto_resume: bool = False
    # L1 byte budget across all nodes (0 = unbounded).  When a save
    # would overflow it, the oldest evictable step's L1 blobs are
    # dropped first (never delta anchors, live-window bases, keep_n
    # steps, or queued/mid-flight flushes; parked steps are superseded,
    # not silently lost); save() raises L1CapacityError only when
    # nothing is evictable.
    l1_capacity_bytes: int = 0
    # Deadline-aware read hedging: a PFS extent pread outstanding past
    # the hedge_quantile of observed latencies (floored at
    # hedge_min_delay seconds) is re-issued from the L1/partner copy;
    # first success wins, the loser's bytes are discarded.  Also turns
    # on health-weighted reader assignment (straggler demotion).
    hedged_reads: bool = False
    hedge_quantile: float = 0.95
    hedge_min_delay: float = 0.02
    # Device of the pre-codec pass and of restored leaves (when restore
    # gets no sharding_fn).  "cuda" needs a GPU; pass "cpu" explicitly to
    # run without one.
    device: str = "cuda"


@dataclass
class SaveStats:
    """Per-save telemetry.  On the fused fast path (``zero_copy`` +
    ``parallel_local``) the per-rank L1 writes happen *inside* the
    encode tasks, so ``encode_time`` covers serialize+encode+CRC+drain
    and ``local_time`` is the durability tail (batched directory fsyncs
    + local manifest).  On the reference path they keep the seed split:
    encode vs sequential L1 writes.  ``encode_time + local_time`` is the
    blocking window either way."""

    step: int
    local_time: float
    raw_bytes: int
    stored_bytes: int
    encode_time: float
    flush: Optional[FlushResult] = None
    # True when the adaptive runtime superseded this step's flush (a
    # newer step replaced it before/while it drained); flush stays None.
    superseded: bool = False
    # Device pre-codec telemetry: total device-side staging span (worker
    # thread) and how much of it save() actually blocked on.  A staged
    # step overlapped with training has stage_wait_s ~ 0;
    # stage_s - stage_wait_s is the work hidden behind the train step.
    stage_s: float = 0.0
    stage_wait_s: float = 0.0


class UnsupportedPrecodecError(IOError):
    """Partial restore was planned against a precodec-transformed
    manifest: the stored leaves are the transformed tree (``q``/``s``
    blocks under ``int8``), not the caller's names.  Raised at *plan
    time* — before any blob or extent read is issued — and never
    swallowed by the candidate fallback, so a serving caller cannot
    silently receive an older step's leaves instead.  Restore such
    checkpoints with :meth:`CheckpointManager.restore` (which
    dequantizes), or save the serving tier with ``precodec="none"``."""


class L1CapacityError(RuntimeError):
    """``save()`` refused: the L1 byte budget is full and every resident
    step is pinned (delta anchor, live delta window, ``keep_n``, or
    queued/mid-flight).  Raised *before* any byte of the new step is
    written — the caller can drop the save, raise the budget, or wait
    for a flush to retire a pinned step."""


@dataclass
class ManagerHealth:
    """Operator/follower view of the manager's availability state.

    ``mode`` is ``"normal"`` (PFS circuit closed, nothing parked),
    ``"degraded"`` (PFS circuit open or probing: new flushes park at
    ``flush_partial`` with journals intact, saves keep landing on
    L0/L1), or ``"draining"`` (circuit closed again, parked flushes
    re-queuing through ``resume_flushes()``).  The serving fleet's
    follower treats ``degraded`` as "do not adopt new steps" — only a
    ``flush_done`` manifest published after the drain is trustworthy.
    """

    mode: str
    queue_depth: int            # jobs queued/mid-flight in the scheduler
    parked_steps: List[int]     # flush_partial steps awaiting the drain
    l1_bytes: int               # tracked L1 occupancy (replicas included)
    l1_capacity: int            # configured budget (0 = unbounded)
    circuits: Dict[str, str]    # domain -> closed | open | half_open
    degraded_since: Optional[float] = None  # monotonic ts of first park
    drained_steps: int = 0      # parked flushes completed by auto-drain
    evicted_steps: List[int] = dfield(default_factory=list)


@dataclass
class _FlushJob:
    """One enqueued flush: the encoded step, its plan, and the runtime
    control surface (cancellation token + supersession marking)."""

    enc: EncodedState
    plan: FlushPlan
    token: CancelToken
    protected: bool          # delta-base anchor / keep_n-pinned
    superseded: bool = False  # set (under the manager lock) by newer saves
    started: bool = False    # scheduler picked it up: no longer preemptible
    preempted: bool = False  # yielded its admission slot (parked, resumable)


# Scheduler-queue sentinel: run resume_flushes() on the flush worker
# (auto_resume re-queues crash-leftover flush_partial steps this way so
# the constructor never blocks on PFS I/O).
_AUTO_RESUME = object()


class CheckpointManager:
    def __init__(
        self,
        config: CheckpointConfig,
        *,
        fault_hook: Optional[Callable] = None,
        faults: Optional["FaultPlan"] = None,
        limiter: Optional[Any] = None,
        admission: Optional[AdmissionController] = None,
        storage_health: Optional[StorageHealth] = None,
        tenant: Optional[str] = None,
        priority: float = 1.0,
    ):
        self.cfg = config
        self.device = torch.device(config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"CheckpointConfig.device={config.device!r} but no CUDA "
                "device is available; pass device='cpu' to run on the host"
            )
        self.cluster = config.cluster
        self.root = Path(config.root)
        # Multi-tenant identity (control-plane managed runs): the
        # tenant name labels admission snapshots/logs, the priority
        # orders preemption and drain against co-located managers.
        self.name = tenant if tenant is not None else str(self.root)
        self.priority = float(priority)
        # transient-retry layer shared by L1 blob I/O and PFS extent I/O
        self.retry: Optional[RetryPolicy] = (
            RetryPolicy(
                attempts=config.retry_attempts,
                base_delay=config.retry_base_delay,
                max_delay=config.retry_max_delay,
                deadline=config.retry_deadline,
            )
            if config.retry_attempts > 1
            else None
        )
        # Storage health registry: fed per retry attempt, drives the
        # PFS circuit breaker and the degraded-mode scheduler below.
        self.storage_health: Optional[StorageHealth] = None
        if config.health_enabled and self.retry is not None:
            # An injected registry (control plane) is SHARED: tenants on
            # one PFS see one breaker — tenant A's giveups open the
            # circuit tenant B's flushes must also respect.
            self.storage_health = (
                storage_health
                if storage_health is not None
                else StorageHealth(
                    min_ops=config.health_min_ops,
                    error_threshold=config.health_error_threshold,
                    cooldown=config.health_cooldown,
                )
            )
            self.retry.health = self.storage_health
        self.faults = faults  # deterministic chaos schedule (core/faults.py)
        self.local = LocalStore(
            self.root / "local", self.cluster.n_nodes,
            faults=faults, retry=self.retry,
        )
        if faults is not None:
            faults.bind(self.local)  # node_crash specs drop L1 dirs
        self.pfs_dir = self.root / "pfs"
        self.pfs_dir.mkdir(parents=True, exist_ok=True)
        (self.root / "local" / "manifests").mkdir(parents=True, exist_ok=True)
        self.executor = RealExecutor(
            self.pfs_dir,
            self.local,
            io_threads=config.io_threads,
            fault_hook=fault_hook,
            faults=faults,
            retry=self.retry,
        )
        self._l0: Optional[EncodedState] = None
        self._last_full: Optional[EncodedState] = None
        self._saves_since_full = 0
        # Device pre-codec runtime (lazy — only when device_precodec):
        # the staging worker + device-held base words, and the handle of
        # the step currently staged ahead of its save().
        self._device_precodec = None
        self._staged = None
        self.stats: List[SaveStats] = []
        # Flush results are delivered by step through this index (under
        # _lock) — the flush worker never scans the list save() appends to.
        self._stats_by_step: Dict[int, SaveStats] = {}
        # Parsed-manifest cache keyed by (ino, mtime_ns, size) per path:
        # steps() runs per save (via _gc) and per restore candidate scan,
        # and must not re-parse every manifest JSON each time.
        self._man_cache: Dict[str, Tuple[Tuple[int, int, int], Manifest]] = {}
        self._MAN_CACHE_CAP = 128  # bounds RAM when keep_n is None
        self._q: "queue.Queue[Optional[_FlushJob]]" = queue.Queue()
        # Flush admission: the seed's per-manager BoundedSemaphore let
        # two managers on one node hold 2x the intended pending-flush
        # budget; the controller is shared across managers when the
        # control plane injects one (max_pending_flushes then reads as
        # a cluster-wide budget), private otherwise (same semantics as
        # the old semaphore, preemption never fires with one tenant).
        self._admission: AdmissionController = (
            admission
            if admission is not None
            else AdmissionController(max(1, config.max_pending_flushes))
        )
        self._worker: Optional[threading.Thread] = None
        self._local_exec: Optional[ThreadPoolExecutor] = None
        self._flush_errors: List[Tuple[int, str]] = []
        self._lock = threading.Lock()
        # Adaptive flush runtime state: jobs queued or mid-flight (by
        # step), supersession/interruption records, saved-step history
        # (keep_n pinning), and the global write-rate token bucket.
        self._pending: Dict[int, _FlushJob] = {}
        # Bounded telemetry: a multi-week supersession run records one
        # entry per save — deques cap the memory, newest entries win.
        self._superseded: Deque[Tuple[int, str]] = deque(maxlen=4096)
        self._interrupted: Deque[int] = deque(maxlen=4096)
        self._resuming: set = set()  # steps mid-resume, shielded from _gc
        self._saved_steps: List[int] = []  # trimmed in save(); keep_n pins
        # Operator pins (control-plane `pin`): steps GC, supersession,
        # preemption and L1 eviction must all leave alone.
        self._pins: set = set()
        # Steps parked by admission preemption (not by a PFS outage):
        # their drain additionally waits for budget headroom.
        self._preempt_parked: set = set()
        if limiter is not None:
            # Injected fair-share leaf (TenantLimiter): the control
            # plane's global cap replaces the per-manager policy.
            self._limiter: Optional[TokenBucket] = limiter
        else:
            cap = self._flush_bw_policy()
            self._limiter = TokenBucket(cap) if cap > 0 else None
        # Stats of the most recent aggregated PFS read (restore telemetry).
        self.last_read_result: Optional[ReadResult] = None
        # New-step notification: callbacks fired (with the step number)
        # after a manifest flips to flush_done — the serving fleet's
        # hot-swap follower subscribes here when it shares the process.
        self._subscribers: List[Callable[[int], None]] = []
        # Optional node-local decoded-chunk cache (duck-typed:
        # get(key)/put(key, bytes) — see repro_torch.serve.stream.ChunkCache).
        # Keyed (step, chunk row); the delta-base recursion reuses the
        # same keying for the base step, so co-located replicas dedup
        # CHUNK_BASE/delta-base decodes for free.
        self.chunk_cache = None
        # Degraded-mode availability runtime state (docs/OPERATIONS.md
        # "Degraded mode"): parked flush_partial steps awaiting the
        # post-outage drain, L1 occupancy accounting for backpressure,
        # and the seeded probe-payload generator for half-open checks.
        self._parked: Dict[int, None] = {}  # insertion-ordered step set
        self._degraded_since: Optional[float] = None
        self._draining = False
        self._drained_total = 0
        self._evicted: Deque[int] = deque(maxlen=4096)
        self._l1_bytes: Dict[int, int] = {}
        self._l1_anchors: set = set()  # full snapshots under zstd+delta
        self._last_l1_cost = 0  # newest step's L1 bytes (reserve estimate)
        self._probe_rng = random.Random(0x5EED)
        if config.l1_capacity_bytes > 0:
            self._scan_l1_occupancy()
        if config.async_flush:
            self._worker = threading.Thread(
                target=self._scheduler_loop, name="active-backend", daemon=True
            )
            self._worker.start()
        if config.auto_resume:
            if self._worker is not None:
                self._q.put(_AUTO_RESUME)  # re-queue partials on the worker
            else:
                self.resume_flushes()

    # ------------------------------------------------------------------ save

    def save(self, step: int, state: Any) -> SaveStats:
        cfg = self.cfg
        t0 = time.perf_counter()
        if cfg.precodec not in ("none", "int8"):
            raise ValueError(f"unknown precodec {cfg.precodec!r}")
        base = None
        if cfg.device_precodec:
            self._check_device_cfg()
        else:
            if cfg.precodec == "int8":
                from repro_torch.core.precodec import quantize_tree

                state = quantize_tree(state)
            base = self._delta_base()
        c = self.cluster
        pool = self._local_pool() if cfg.parallel_local else None
        replicate = cfg.partner_replication and c.n_nodes > 1
        # L1 backpressure: make room for this step *before* its first
        # blob lands (the fused path writes L1 inside encode).  The
        # newest step's cost is the estimate; the post-write true-up
        # below reconciles against the real size.
        self._enforce_l1_budget(step, self._last_l1_cost, strict=True)

        def drain_rank(rank: int, blob: Any) -> None:
            # non-atomic, unsynced writes: the local manifest written
            # after the batch is the commit point, sync_dir the
            # durability point
            node = c.node_of_rank(rank)
            self.local.write_blob(
                node, step, rank, blob, sync=False, atomic=False
            )
            if replicate:
                partner = (node + 1) % c.n_nodes
                self.local.write_blob(
                    partner, step, rank, blob, partner=True,
                    sync=False, atomic=False,
                )

        fused = cfg.zero_copy and pool is not None
        stage_s = stage_wait_s = 0.0
        if cfg.device_precodec:
            enc, stage_s, stage_wait_s = self._encode_device(
                step, state, pool, drain_rank if fused else None
            )
        elif cfg.zero_copy:
            # fused parallel local phase: each pooled rank task encodes,
            # CRCs and writes its L1 blob (+ partner replica) in one go —
            # CRC of one rank overlaps the file write of another
            enc = encode_state(
                step, state, self.cluster, codec=cfg.codec, base=base,
                chunk_aligned=cfg.chunk_aligned_split,
                pool=pool, rank_sink=drain_rank if fused else None,
                chunk_size=cfg.chunk_size,
            )
        else:
            from repro_torch.core.serialize_ref import encode_state_reference

            enc = encode_state_reference(
                step, state, self.cluster, codec=cfg.codec, base=base
            )
        enc.manifest.precodec = cfg.precodec
        t_enc = time.perf_counter() - t0

        # ---- local phase (blocking) ----
        t1 = time.perf_counter()
        if pool is None:
            # seed reference path: sequential writes, fsync per file
            for rank, blob in enumerate(enc.blobs):
                node = c.node_of_rank(rank)
                self.local.write_blob(node, step, rank, blob)
                if cfg.partner_replication and c.n_nodes > 1:
                    partner = (node + 1) % c.n_nodes
                    self.local.write_blob(partner, step, rank, blob, partner=True)
        else:
            if not fused:  # reference encode + parallel drain
                list(pool.map(lambda j: drain_rank(*j), enumerate(enc.blobs)))
            # batched durability: one fsync per node directory (the
            # blobs span every rank, hence every node — replicas too)
            list(pool.map(
                lambda n: self.local.sync_dir(n, step), range(c.n_nodes)
            ))
        enc.manifest.status = "local_done"
        self._write_manifest_local(enc.manifest)
        t_local = time.perf_counter() - t1

        st = SaveStats(
            step=step,
            local_time=t_local,
            raw_bytes=enc.manifest.total_raw_bytes,
            stored_bytes=sum(r.stored_size for r in enc.manifest.ranks),
            encode_time=t_enc,
            stage_s=stage_s,
            stage_wait_s=stage_wait_s,
        )
        l1_cost = st.stored_bytes * (2 if replicate else 1)
        with self._lock:
            self._l0 = enc
            if enc.manifest.base_step is None:
                self._last_full = enc
                self._saves_since_full = 0
                if cfg.codec == "zstd+delta":
                    self._l1_anchors.add(step)
            else:
                self._saves_since_full += 1
            self._l1_bytes[step] = l1_cost
            self._last_l1_cost = l1_cost
            self.stats.append(st)
            self._stats_by_step[step] = st
            self._saved_steps.append(step)
            # keep_n pinning only ever reads the tail; don't let the
            # history grow with the run
            bound = 4 * max(cfg.keep_n or 0, 256)
            if len(self._saved_steps) > bound:
                del self._saved_steps[: len(self._saved_steps) - bound // 2]

        # ---- flush phase (async) ----
        sizes = [r.stored_size for r in enc.manifest.ranks]
        plan = make_plan(cfg.strategy, c, sizes, **cfg.strategy_kwargs)
        job = _FlushJob(
            enc, plan, CancelToken(), protected=self._is_protected(enc.manifest)
        )
        if cfg.async_flush:
            if cfg.supersede_stale:
                # mark stale pending flushes *before* taking a slot:
                # skipped jobs release their slots, so a fast save
                # cadence drains the queue instead of stalling on it
                self._supersede_stale(step)
            # backpressure: bounded flush pipeline.  Under a shared
            # controller this blocks on the CLUSTER budget; offering
            # _yield_queued_flush makes this manager's queued (never
            # mid-flight) jobs preemptible by higher-priority tenants.
            self._admission.acquire(
                self, priority=self.priority,
                yield_fn=self._yield_queued_flush,
            )
            with self._lock:
                self._pending[step] = job
            self._q.put(job)
            self._add_demand(plan.total_bytes)
        else:
            try:
                st.flush = self._do_flush(job)
            except (CircuitOpenError, OSError) as e:
                # degraded mode, sync flavor: save() still succeeds —
                # the step parks at flush_partial, health_check() drains
                if self._pfs_degraded() and cfg.resumable_flushes:
                    self._park_job(job, e)
                else:
                    raise
        # post-write true-up: the real cost is now known; evict (never
        # raise — the bytes are already durable on L1) if it overshot
        self._enforce_l1_budget(step, 0, strict=False)
        return st

    # ------------------------------------------------- device pre-codec path

    def _delta_base(self) -> Optional[EncodedState]:
        """The delta base for the next save, or ``None`` (anchor).

        Re-anchors when ``cfg.precodec`` changed since the base was
        encoded: XORing streams of different transforms would store a
        "delta" that decodes into garbage under the new manifest's
        precodec label, so the stale in-memory ``_l0``/``_last_full``
        bases are invalidated and the next save is a full snapshot.
        """
        cfg = self.cfg
        if cfg.codec != "zstd+delta" or self._last_full is None:
            return None
        if self._last_full.manifest.precodec != cfg.precodec or (
            self._l0 is not None and self._l0.manifest.precodec != cfg.precodec
        ):
            with self._lock:
                self._l0 = None
                self._last_full = None
                self._saves_since_full = 0
            if self._device_precodec is not None:
                self._device_precodec.invalidate_base()
            return None
        if self._saves_since_full < cfg.delta_every - 1:
            return self._l0 or self._last_full
        return None

    def _check_device_cfg(self) -> None:
        cfg = self.cfg
        if cfg.codec != "zstd+delta":
            raise ValueError("device_precodec requires codec 'zstd+delta'")
        from repro_torch.kernels.fused.ops import CHUNK_ALIGN

        if cfg.chunk_size <= 0 or cfg.chunk_size % CHUNK_ALIGN:
            raise ValueError(
                f"device_precodec requires chunk_size to be a positive "
                f"multiple of {CHUNK_ALIGN}, got {cfg.chunk_size}"
            )

    def _device_codec(self):
        if self._device_precodec is None:
            from repro_torch.core.precodec import DevicePrecodec

            self._device_precodec = DevicePrecodec(
                chunk_size=self.cfg.chunk_size, precodec=self.cfg.precodec,
                device=self.device,
            )
        return self._device_precodec

    def stage(self, step: int, state: Any) -> bool:
        """Start the device pre-codec pass for ``step`` ahead of its
        ``save()``.

        Before it returns, the grouped quantize and the stream assembly
        (a device copy of every leaf) are enqueued on the caller's
        current CUDA stream; the fused delta/dirty/checksum pass and the
        dirty-chunk D2H copy then run on the staging worker's side
        stream while the caller's next train step executes.  An
        in-place update of the state issued afterwards on the same
        stream is ordered behind that copy, so it does not reach the
        staged bytes.  ``save(step, state)`` then consumes the staged
        buffers (the staged bytes are the bytes saved) instead of
        copying the full state to the host.  No-op returning ``False``
        when ``device_precodec`` is off.
        """
        if not self.cfg.device_precodec:
            return False
        self._check_device_cfg()
        base = self._delta_base()
        staged = self._device_codec().stage(
            step, state, base_step=None if base is None else base.step
        )
        with self._lock:
            self._staged = staged
        return True

    def _encode_device(self, step: int, state: Any, pool, rank_sink):
        """Consume (or synchronously produce) the staged device buffers
        and encode them — the device-path body of ``save()``'s encode
        phase.  Returns ``(enc, stage_s, stage_wait_s)``."""
        from repro_torch.core.serialize import encode_state_staged

        with self._lock:
            staged, self._staged = self._staged, None
        if staged is None or staged.step != step:
            base = self._delta_base()
            staged = self._device_codec().stage(
                step, state, base_step=None if base is None else base.step
            )
        base_stream = None
        if staged.base_step is not None:
            with self._lock:
                for cand in (self._l0, self._last_full):
                    if cand is not None and cand.step == staged.base_step:
                        base_stream = cand.stream
                        break
        bufs = self._device_codec().consume(staged, base_stream)
        enc = encode_state_staged(
            step, self.cluster,
            stream=bufs.stream,
            leaves=bufs.leaves,
            chunk_size=self.cfg.chunk_size,
            base_step=bufs.base_step,
            dirty=bufs.mask,
            deltas=bufs.deltas,
            digests=bufs.digests,
            pool=pool,
            rank_sink=rank_sink,
        )
        return enc, bufs.stage_s, bufs.wait_s

    # ----------------------------------------------------------------- flush

    def _local_pool(self) -> ThreadPoolExecutor:
        """One shared pool for the whole local phase — serialize leaf
        copies, fused encode+CRC+L1 tasks, batched directory fsyncs —
        and for restore-side decode.

        Deliberately **not** the executor's flush pool: ``save()`` is
        the blocking window, and its tasks must never queue in FIFO
        order behind a backlog of async PFS writes from earlier steps.
        Sizing is codec-aware: with codec ``none`` the fused rank tasks
        spend their time in GIL-free file writes, so the pool is sized
        for I/O latency; with compression on they alternate short
        GIL-holding bookkeeping with GIL-free compressor calls, and
        oversubscribing the physical cores just convoys the GIL — so
        the pool tracks core count instead."""
        if self._local_exec is None:
            cpus = os.cpu_count() or 4
            if self.cfg.codec == "none":
                auto = min(16, max(8, 2 * cpus))
            else:
                auto = min(16, max(4, cpus + 2))
            workers = self.cfg.local_workers or auto
            self._local_exec = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="ckpt-local"
            )
        return self._local_exec

    def _flush_bw_policy(self) -> float:
        """Effective executor write cap in bytes/s (0 = unthrottled).

        Explicit ``flush_bw_cap`` wins; otherwise a positive
        ``app_net_load`` on the cluster's nodes derives the cap the
        simulator prices for the same spec: the flush may use at most
        the NIC share the application is not keeping, summed over
        nodes.  Consistency between this policy and
        ``simulate_flush(flush_bw_cap=...)`` is what lets the sim's
        throttle curve predict the real executor's.
        """
        cfg = self.cfg
        if cfg.flush_bw_cap > 0:
            return float(cfg.flush_bw_cap)
        load = self.cluster.node.app_net_load
        if load > 0:
            # floor the share at 1e-3 (the simulator's derate floor):
            # load -> 1.0 must throttle to near-zero, not flip the cap
            # to 0.0 == "unthrottled" at exactly the boundary
            return (
                self.cluster.n_nodes * self.cluster.node.nic_bw
                * max(1e-3, 1.0 - load)
            )
        return 0.0

    def _is_protected(self, man: Manifest) -> bool:
        """Steps supersession must never skip: full snapshots under
        ``zstd+delta`` — every delta chain resolves through them, so
        dropping one would strand the whole ``delta_every`` window on
        L1 durability alone."""
        return self.cfg.codec == "zstd+delta" and man.base_step is None

    # ------------------------------------------- multi-tenant control surface

    def _add_demand(self, n: int) -> None:
        """Offered-load signal for a fair-share limiter (duck-typed:
        plain TokenBuckets have no demand and ignore rebalancing)."""
        f = getattr(self._limiter, "add_demand", None)
        if f is not None:
            f(n)

    def _sub_demand(self, n: int) -> None:
        f = getattr(self._limiter, "sub_demand", None)
        if f is not None:
            f(n)

    def pin_step(self, step: int) -> None:
        """Pin ``step`` against GC, supersession, L1 eviction and
        admission preemption (the control plane's ``pin`` verb)."""
        with self._lock:
            self._pins.add(int(step))

    def unpin_step(self, step: int) -> None:
        with self._lock:
            self._pins.discard(int(step))

    def pinned_steps(self) -> List[int]:
        with self._lock:
            return sorted(self._pins)

    def _yield_queued_flush(self) -> bool:
        """Admission-preemption callback: park this manager's oldest
        queued-but-not-started flush as a journaled ``flush_partial``
        and give its slot back to the controller.

        Only *queued* jobs yield — a mid-flight flush already paid for
        its bytes and cancelling it would waste more PFS bandwidth than
        it frees.  The parked step keeps its placement + journal (the
        resumable-flush machinery), so it drains through
        :meth:`resume_flushes` once the budget has headroom again;
        without ``resumable_flushes`` there is nothing to park *with*,
        so this manager is simply not preemptible.  Returns True when a
        slot was released.
        """
        if not self.cfg.resumable_flushes:
            return False
        with self._lock:
            victim: Optional[_FlushJob] = None
            for s in sorted(self._pending):
                job = self._pending[s]
                if (
                    job.started or job.preempted or job.superseded
                    or job.protected or s in self._pins
                ):
                    continue
                victim = job
                break
            if victim is None:
                return False
            victim.preempted = True
            self._preempt_parked.add(victim.enc.step)
        self._park_job(
            victim,
            RuntimeError("admission slot preempted by a higher-priority job"),
        )
        self._admission.release(self)
        log.info(
            "flush for step %d preempted: slot yielded to a "
            "higher-priority tenant; journaled state drains when the "
            "budget has headroom", victim.enc.step,
        )
        return True

    def _supersede_stale(self, new_step: int) -> None:
        """Mark every stale pending flush superseded and fire its token.

        Stale = enqueued for an older step than ``new_step``, not
        protected (:meth:`_is_protected`), not pinned by ``keep_n``
        (a step inside the keep_n-newest saved window is one the user
        asked to retain on the PFS — skipping its flush would leave a
        hole GC semantics promise not to have), and — under
        ``zstd+delta`` — not inside the **live delta window**: deltas
        chain through their predecessors (``base = L0``, the previous
        step), so every pending step at or above the current full
        anchor is transitively a base of ``new_step`` and skipping its
        flush would leave newer flush_done deltas unrestorable from the
        PFS alone.  Delta-window steps only become superseded-able when
        the next full snapshot opens a new window.

        *Parked* steps (degraded mode) follow the same rule: a newer
        save supersedes an older parked flush under the identical
        protections, so an outage with a live save cadence drains only
        the newest state afterwards instead of replaying the backlog.
        """
        keep = self.cfg.keep_n
        parked_stale: List[int] = []
        with self._lock:
            pinned = set(self._saved_steps[-keep:]) if keep is not None else set()
            window_floor = None
            if self.cfg.codec == "zstd+delta" and self._last_full is not None:
                window_floor = self._last_full.step
            for s, job in self._pending.items():
                if s >= new_step or job.superseded or job.protected:
                    continue
                if s in pinned or s in self._pins or job.preempted:
                    continue
                if window_floor is not None and s >= window_floor:
                    continue  # live delta window: s is a base of new_step
                job.superseded = True
                job.token.cancel()
            for s in list(self._parked):
                if (
                    s >= new_step or s in pinned or s in self._l1_anchors
                    or s in self._pins
                ):
                    continue
                if window_floor is not None and s >= window_floor:
                    continue
                self._parked.pop(s, None)
                self._preempt_parked.discard(s)
                parked_stale.append(s)
        for s in parked_stale:
            try:
                man = self._gc_manifest_any(s)
                man.status = "superseded"
                self._write_manifest_pfs(man)
            except Exception:
                log.exception("failed to supersede parked step %d", s)
            self._note_superseded(s, "parked")

    def _journal_path(self, step: int) -> Path:
        return self.pfs_dir / f"step_{step:08d}" / "flush_journal.bin"

    def _scheduler_loop(self) -> None:
        """The adaptive flush scheduler (replaces the seed FIFO
        ``_flush_loop``): skips superseded queued jobs, runs the rest
        through the cancellable/throttled/journaled executor, and
        classifies every outcome — delivered, superseded (queued or
        mid-flush), interrupted-but-resumable, parked (PFS circuit
        open: journaled flush_partial awaiting the post-outage drain),
        or failed.  Between jobs the loop wakes every
        ``cfg.health_tick`` seconds to probe an open PFS circuit and to
        auto-drain parked steps once it closes."""
        tick = max(0.05, float(self.cfg.health_tick))
        while True:
            try:
                job = self._q.get(timeout=tick)
            except queue.Empty:
                self._health_tick()
                continue
            if job is None:
                self._q.task_done()
                return
            if job is _AUTO_RESUME:
                try:
                    self.resume_flushes()
                except Exception:
                    log.exception("auto_resume drain failed")
                finally:
                    self._q.task_done()
                continue
            step = job.enc.step
            try:
                with self._lock:
                    skip = job.superseded
                    preempted = job.preempted
                    if not skip and not preempted:
                        # past this point the job is mid-flight: the
                        # admission yield path must never park it
                        job.started = True
                if preempted:
                    # already parked + slot released by the yield path;
                    # nothing to run — the drain owns it now
                    pass
                elif skip:
                    self._note_superseded(step, "queued")
                else:
                    if self._pfs_degraded():
                        # a busy queue must not starve recovery: give the
                        # circuit its probe/drain opportunity before
                        # deciding this job's fate
                        self._health_tick()
                    if self._pfs_degraded():
                        # fail fast — park with the placement persisted
                        # instead of burning a retry budget per job
                        # against a PFS the breaker already knows is out
                        self._park_job(job, CircuitOpenError("pfs"))
                    else:
                        res = self._do_flush(job)
                        # deliver by step, under the lock save() appends
                        # under — never scan the list a save() is growing
                        with self._lock:
                            st = self._stats_by_step.get(step)
                            if st is not None:
                                st.flush = res
            except CircuitOpenError as e:
                self._park_job(job, e)
            except FlushCancelled:
                if job.superseded:
                    self._note_superseded(step, "mid_flush")
                else:
                    # close()-deadline interruption.  Not an error —
                    # but only resumable when journaling was on.
                    with self._lock:
                        self._interrupted.append(step)
                    if self.cfg.resumable_flushes:
                        log.warning(
                            "flush for step %d interrupted; resumable "
                            "via resume_flushes()", step,
                        )
                    else:
                        log.warning(
                            "flush for step %d interrupted with "
                            "resumable_flushes=False: the step exists on "
                            "L1 only — re-save or re-flush it before "
                            "relying on the PFS", step,
                        )
            except OSError as e:
                if self._pfs_degraded():
                    # the op that tripped the breaker: same parking as a
                    # short-circuited job — its journaled state drains
                    self._park_job(job, e)
                else:
                    log.exception("flush for step %d failed", step)
                    with self._lock:
                        self._flush_errors.append((step, repr(e)))
            except Exception as e:  # crash of the active backend
                log.exception("flush for step %d failed", step)
                with self._lock:
                    self._flush_errors.append((step, repr(e)))
            finally:
                with self._lock:
                    self._pending.pop(step, None)
                    was_preempted = job.preempted
                self._sub_demand(job.plan.total_bytes)
                if not was_preempted:
                    # a preempted job's slot was already returned by
                    # _yield_queued_flush on the preemptor's thread
                    self._admission.release(self)
                self._q.task_done()

    def _note_superseded(self, step: int, phase: str) -> None:
        with self._lock:
            self._superseded.append((step, phase))
            st = self._stats_by_step.get(step)
            if st is not None:
                st.superseded = True
        log.info("flush for step %d superseded (%s)", step, phase)

    # ------------------------------------------- degraded-mode availability

    def _pfs_degraded(self) -> bool:
        """True while the PFS circuit is open or probing (half-open)."""
        sh = self.storage_health
        return sh is not None and sh.state("pfs") != "closed"

    def _park_job(self, job: _FlushJob, err: BaseException) -> None:
        """Park a flush the PFS outage prevented: persist the write set
        (manifest at ``flush_partial`` with full placement) so the
        post-outage drain finishes it via :meth:`resume_flushes` —
        journaled progress, if any, is kept.  Without
        ``resumable_flushes`` there is nothing to park *with*, so the
        step records a flush error exactly like the pre-health runtime.
        """
        step = job.enc.step
        if not self.cfg.resumable_flushes:
            log.error(
                "flush for step %d failed with the PFS circuit open and "
                "resumable_flushes=False: the step exists on L1 only", step,
            )
            with self._lock:
                self._flush_errors.append((step, repr(err)))
            return
        man = job.enc.manifest
        if man.status != "flush_partial" or man.placement is None:
            # short-circuited before _do_flush persisted the write set
            man.strategy = job.plan.strategy
            man.files = dict(job.plan.files)
            man.placement = placement_from_plan(job.plan)
            man.status = "flush_partial"
            self._write_manifest_pfs(man)
        with self._lock:
            self._parked[step] = None
            if self._degraded_since is None:
                self._degraded_since = time.monotonic()
        log.warning(
            "flush for step %d parked (%s); journaled state drains "
            "automatically when the PFS circuit closes", step, err,
        )

    def _health_tick(self) -> None:
        """One probe/drain opportunity: probe an open PFS circuit once
        its cooldown elapses; once it closes, drain parked flushes.
        Driven by the scheduler between jobs; sync managers and tests
        drive it through :meth:`health_check`."""
        sh = self.storage_health
        if sh is None:
            return
        state = sh.state("pfs")
        if state == "closed":
            with self._lock:
                parked = bool(self._parked)
                only_preempted = (
                    parked and set(self._parked) <= self._preempt_parked
                )
                if not parked:
                    self._degraded_since = None
            # Preemption-parked steps additionally wait for budget
            # headroom: draining them the instant they parked would
            # hand the yielded bandwidth straight back to the victim.
            if parked and not (
                only_preempted and self._admission.available() <= 0
            ):
                self._drain_parked()
            return
        if state == "half_open":
            self._probe_pfs_once()

    def _probe_pfs_once(self) -> None:
        """One half-open probe op (seeded payload) through
        :meth:`RealExecutor.probe_pfs`; the outcome feeds the breaker."""
        sh = self.storage_health
        try:
            sh.check("pfs")  # open -> half_open; admits this op as a probe
        except CircuitOpenError:
            return
        payload = self._probe_rng.getrandbits(64).to_bytes(8, "little") * 2
        try:
            lat = self.executor.probe_pfs(payload)
        except OSError:
            sh.record("pfs", False)
            return
        sh.record("pfs", True, lat)

    def _drain_parked(self) -> None:
        """Finish every parked flush now that the circuit closed.

        Reuses :meth:`resume_flushes` (placement + journal on disk is
        exactly the resume input).  Steps the resume finished — or
        definitively failed, or that stopped being ``flush_partial``
        (superseded/GC'd) — leave the parked set; steps deferred by a
        circuit that re-opened mid-drain stay parked for the next tick.
        """
        with self._lock:
            if self._draining or not self._parked:
                return
            self._draining = True
            n = len(self._parked)
        log.info("PFS circuit closed: draining %d parked flush(es)", n)
        try:
            with self._lock:
                pre_err = {s for s, _ in self._flush_errors}
            out = self.resume_flushes()
            with self._lock:
                new_err = {s for s, _ in self._flush_errors} - pre_err
                for s in list(self._parked):
                    if s in out or s in new_err:
                        self._parked.pop(s, None)
                for s, res in out.items():
                    st = self._stats_by_step.get(s)
                    if st is not None:
                        st.flush = res
                self._drained_total += len(out)
            for s in sorted(self._parked):
                if self.step_status(s, "pfs") != "flush_partial":
                    with self._lock:
                        self._parked.pop(s, None)
            with self._lock:
                self._preempt_parked &= set(self._parked)
                if not self._parked:
                    self._degraded_since = None
        finally:
            with self._lock:
                self._draining = False

    def health(self) -> ManagerHealth:
        """Current availability snapshot (see :class:`ManagerHealth`)."""
        sh = self.storage_health
        circuits: Dict[str, str] = {}
        pfs_state = "closed"
        if sh is not None:
            circuits = {name: sh.state(name) for name in sh.snapshot()}
            pfs_state = sh.state("pfs")
        with self._lock:
            parked = sorted(self._parked)
            l1 = sum(self._l1_bytes.values())
            since = self._degraded_since
            drained = self._drained_total
            evicted = list(self._evicted)
            draining = self._draining
        if pfs_state != "closed":
            mode = "degraded"
        elif parked or draining:
            mode = "draining"
        else:
            mode = "normal"
        return ManagerHealth(
            mode=mode,
            queue_depth=self._q.qsize(),
            parked_steps=parked,
            l1_bytes=l1,
            l1_capacity=self.cfg.l1_capacity_bytes,
            circuits=circuits,
            degraded_since=since,
            drained_steps=drained,
            evicted_steps=evicted,
        )

    def health_check(self) -> ManagerHealth:
        """Drive one probe/drain opportunity, then return the snapshot.

        The async scheduler ticks on its own; sync managers (and
        deterministic tests) call this to advance the open → half-open
        → closed → drained recovery explicitly."""
        self._health_tick()
        return self.health()

    # ------------------------------------------------ L1 capacity accounting

    def _scan_l1_occupancy(self) -> None:
        """Rebuild L1 byte accounting from the local manifests on disk
        (manager constructed over an existing root with a budget set)."""
        mult = 2 if (
            self.cfg.partner_replication and self.cluster.n_nodes > 1
        ) else 1
        for p in sorted(
            (self.root / "local" / "manifests").glob("step_*.json")
        ):
            try:
                man = self._cached_manifest(p)
            except Exception:
                continue
            if man.status == "quarantined":
                continue
            cost = sum(r.stored_size for r in man.ranks) * mult
            self._l1_bytes[man.step] = cost
            self._last_l1_cost = cost
            if man.base_step is None and self.cfg.codec == "zstd+delta":
                self._l1_anchors.add(man.step)

    def _enforce_l1_budget(self, new_step: int, need: int, *, strict: bool) -> None:
        """Evict oldest evictable steps until ``need`` more L1 bytes fit.

        ``strict=True`` (the pre-write reservation in :meth:`save`)
        raises :class:`L1CapacityError` when the budget is full and
        nothing is evictable; ``strict=False`` (the post-write
        true-up, where the step's real cost is first known) only logs —
        the bytes are already on disk and the next save reconciles.
        """
        cap = self.cfg.l1_capacity_bytes
        if cap <= 0:
            return
        while True:
            with self._lock:
                occ = sum(self._l1_bytes.values())
                if occ + need <= cap:
                    return
                victim = self._pick_l1_victim_locked(new_step)
            if victim is None:
                if strict:
                    raise L1CapacityError(
                        f"save({new_step}): L1 budget of {cap} bytes is "
                        f"full ({occ} resident + ~{need} incoming) and "
                        "every resident step is pinned (delta anchor, "
                        "live delta window, keep_n, or in-flight flush)"
                    )
                log.warning(
                    "L1 occupancy %d exceeds the %d-byte budget and no "
                    "step is evictable", occ, cap,
                )
                return
            self._evict_l1(victim)

    def _pick_l1_victim_locked(self, new_step: int) -> Optional[int]:
        """Oldest L1-resident step safe to drop (caller holds _lock).

        Never: the incoming step, delta anchors, live-delta-window
        bases, ``keep_n``-pinned steps, or steps queued/mid-flight/
        mid-resume.  Parked steps *are* candidates — last in save
        order — and are superseded (not silently lost) by the evictor.
        """
        keep = self.cfg.keep_n
        pinned = set(self._saved_steps[-keep:]) if keep is not None else set()
        window_floor = None
        if self.cfg.codec == "zstd+delta" and self._last_full is not None:
            window_floor = self._last_full.step
        for s in sorted(self._l1_bytes):
            if s == new_step or s in pinned or s in self._l1_anchors:
                continue
            if s in self._pins:
                continue
            if s in self._pending or s in self._resuming:
                continue
            if window_floor is not None and s >= window_floor:
                continue
            return s
        return None

    def _evict_l1(self, step: int) -> None:
        """Drop one step's L1 blobs (+ replicas + local manifest) for
        the byte budget.  A parked step loses its only path to the PFS
        with its L1, so it is superseded first — visible in
        ``superseded_steps``, skipped by the drain — never silently
        unfinishable."""
        with self._lock:
            parked = step in self._parked
        if parked:
            try:
                man = self._gc_manifest_any(step)
                man.status = "superseded"
                self._write_manifest_pfs(man)
            except Exception:
                log.exception(
                    "failed to mark evicted parked step %d superseded", step
                )
            with self._lock:
                self._parked.pop(step, None)
            self._note_superseded(step, "parked")
        self.local.gc_step(step)
        mp = self.root / "local" / "manifests" / f"step_{step:08d}.json"
        if mp.exists():
            mp.unlink()
        with self._lock:
            self._l1_bytes.pop(step, None)
            self._l1_anchors.discard(step)
            self._evicted.append(step)
            self._man_cache.pop(str(mp), None)
        log.info("L1 budget: evicted step %d%s", step,
                 " (parked; superseded)" if parked else "")

    def _do_flush(self, job: _FlushJob) -> FlushResult:
        enc, plan = job.enc, job.plan
        man = enc.manifest
        man.strategy = plan.strategy
        man.files = dict(plan.files)
        man.placement = placement_from_plan(plan)
        journal: Optional[FlushJournal] = None
        if self.cfg.resumable_flushes:
            # commit the write set *before* the first byte: a
            # flush_partial manifest (full columnar placement + file
            # sizes) plus the extent journal is everything
            # resume_flushes() needs after any interruption.  fresh=True:
            # a journal left by a previous incarnation of this step
            # describes *different bytes* and must never skip writes here.
            man.status = "flush_partial"
            self._write_manifest_pfs(man)
            journal = FlushJournal(self._journal_path(enc.step), fresh=True)
        try:
            res = self.executor.execute(
                plan, enc.step,
                cancel=job.token, limiter=self._limiter, journal=journal,
            )
        except FlushCancelled:
            if job.superseded and self.cfg.resumable_flushes:
                # a superseded partial is dead, not resumable: newer
                # state already replaced it — mark it so resume skips it
                man.status = "superseded"
                self._write_manifest_pfs(man)
            raise
        man.status = "flush_done"
        self._write_manifest_pfs(man)
        self._notify_flush_done(enc.step)
        if journal is not None:
            journal.unlink()
        if self.cfg.keep_n is not None:
            try:
                self._gc()
            except Exception:
                log.exception("gc failed")
        return res

    def resume_flushes(self) -> Dict[int, FlushResult]:
        """Finish every interrupted (``flush_partial``) flush on the PFS.

        Scans the step manifests, rebuilds each partial flush's write
        set from its persisted columnar placement, skips the extents
        its journal proves already written, and rewrites only the rest
        (``FlushResult.bytes_skipped`` reports the saved volume).  On
        success the manifest flips to ``flush_done`` and the journal is
        deleted.  Requires the step's L1 blobs to still exist on the
        home node or (with ``partner_replication``) on its partner;
        a step whose copies are all gone is unfinishable, is recorded
        in ``flush_errors``, and restore falls back as usual — other
        steps still resume.  Superseded partials are left alone.
        Returns ``{step: FlushResult}`` for the steps that finished.
        """
        out: Dict[int, FlushResult] = {}
        for p in sorted(self.pfs_dir.glob("step_*/manifest.json")):
            try:
                man = self._cached_manifest(p)
            except Exception:
                continue
            if man.status != "flush_partial":
                continue
            with self._lock:
                # one acquisition: never race a live flush, and shield
                # the step from a concurrently running _gc sweep
                if man.step in self._pending or man.step in self._resuming:
                    continue
                self._resuming.add(man.step)
            try:
                journal = FlushJournal(self._journal_path(man.step))
                res = self.executor.execute_resume(
                    man, man.step, limiter=self._limiter, journal=journal
                )
                man.status = "flush_done"
                self._write_manifest_pfs(man)
                self._notify_flush_done(man.step)
                journal.unlink()
            except CircuitOpenError:
                # the PFS circuit (re)opened mid-resume: not a dead
                # step — it stays flush_partial/journaled/parked and a
                # later drain retries it once the circuit closes
                log.warning(
                    "resume of step %d deferred: PFS circuit open", man.step
                )
                continue
            except Exception as e:  # one dead step must not block the rest
                log.exception("resume of step %d failed", man.step)
                with self._lock:
                    self._flush_errors.append((man.step, repr(e)))
                continue
            finally:
                with self._lock:
                    self._resuming.discard(man.step)
            out[man.step] = res
            log.info(
                "resumed flush for step %d: %d bytes rewritten, %d skipped",
                man.step, res.bytes_written, res.bytes_skipped,
            )
        return out

    def wait(self) -> None:
        """Drain all pending flushes (returns when the PFS is settled)."""
        if self.cfg.async_flush:
            self._q.join()

    def close(self, *, timeout: float = 60.0) -> None:
        """Shut down, draining pending flushes — never dropping them
        silently.

        The worker gets ``timeout`` seconds to drain.  If it is still
        busy after that, every pending flush's token is cancelled: the
        in-flight flush stops at its next request boundary with its
        progress journaled (manifest at ``flush_partial``), queued ones
        fail fast the same way, and the steps left unflushed are
        enumerated in an error log — all of them recoverable via
        :meth:`resume_flushes` on a manager over the same root.  (The
        seed bug: ``join(timeout=60)`` could return with the worker
        alive, ``_worker`` was set to ``None`` anyway, and the queued
        flushes vanished without a trace.)  Raises ``RuntimeError`` if
        the worker ignores cancellation too (e.g. a hook blocked in
        foreign code) rather than pretend the shutdown was clean.
        """
        if self._worker is not None:
            self._q.put(None)
            self._worker.join(timeout=timeout)
            if self._worker.is_alive():
                with self._lock:
                    lost = sorted(self._pending)
                    for job in self._pending.values():
                        job.token.cancel()
                log.error(
                    "close(): flush worker still busy after %.1fs; "
                    "cancelling %d pending flush(es) for steps %s (%s)",
                    timeout, len(lost), lost,
                    "progress journaled; finish with resume_flushes()"
                    if self.cfg.resumable_flushes
                    else "resumable_flushes=False: these steps exist on "
                    "L1 only — re-save or flush them before relying on "
                    "the PFS",
                )
                self._worker.join(timeout=max(5.0, timeout))
                if self._worker.is_alive():
                    raise RuntimeError(
                        "close(): flush worker did not stop; steps "
                        f"{lost} not flushed (journaled state on disk)"
                    )
            self._worker = None
        if self._local_exec is not None:
            self._local_exec.shutdown(wait=True)
            self._local_exec = None
        if self._device_precodec is not None:
            self._device_precodec.close()
            self._device_precodec = None
        self.executor.close()

    @property
    def flush_errors(self) -> List[Tuple[int, str]]:
        with self._lock:
            return list(self._flush_errors)

    @property
    def superseded_steps(self) -> List[int]:
        """Steps whose flush the runtime superseded (queued or
        mid-flush).  Restorable from L1 via the normal ladder."""
        with self._lock:
            return sorted({s for s, _ in self._superseded})

    @property
    def interrupted_steps(self) -> List[int]:
        """Steps whose flush was interrupted (e.g. by a ``close()``
        deadline).  With ``resumable_flushes=True`` their progress is
        journaled — finish via :meth:`resume_flushes`; with it off they
        exist on L1 only and must be re-saved or re-flushed."""
        with self._lock:
            return sorted(set(self._interrupted))

    # --------------------------------------------------------------- restore

    def _cached_manifest(self, p: Path) -> Manifest:
        """Parse a manifest JSON through a stat-keyed cache.

        ``steps()`` runs on every save (via ``_gc``) and on every restore
        candidate scan; re-parsing an unchanged 32k-rank manifest each
        time would dominate those paths.  Manifests are replaced
        atomically (``os.replace``), which allocates a fresh inode, so
        (ino, mtime_ns, size) identifies the content even on
        coarse-mtime filesystems; anything else falls through to a
        fresh parse.  The cache is insertion-order bounded (paper-scale
        manifests hold MBs of placement columns, and with the default
        ``keep_n=None`` the step count is unbounded); ``_gc`` also
        evicts deleted steps eagerly."""
        stat = p.stat()
        sig = (stat.st_ino, stat.st_mtime_ns, stat.st_size)
        key = str(p)
        with self._lock:
            hit = self._man_cache.get(key)
            if hit is not None and hit[0] == sig:
                return hit[1]
        man = Manifest.from_json(p.read_text())
        with self._lock:
            self._man_cache.pop(key, None)   # reinsert at the newest slot
            self._man_cache[key] = (sig, man)
            while len(self._man_cache) > self._MAN_CACHE_CAP:
                self._man_cache.pop(next(iter(self._man_cache)))
        return man

    def steps(self, level: str = "pfs") -> List[int]:
        if level == "pfs":
            out = []
            for p in sorted(self.pfs_dir.glob("step_*/manifest.json")):
                try:
                    man = self._cached_manifest(p)
                    if man.status == "flush_done":
                        out.append(man.step)
                except Exception:
                    continue
            return out
        if level == "local":
            out = []
            for p in sorted((self.root / "local" / "manifests").glob("step_*.json")):
                try:
                    man = self._cached_manifest(p)
                    if man.status == "quarantined":
                        continue  # no good copy anywhere: never listed
                    out.append(man.step)
                except Exception:
                    continue
            return out
        raise ValueError(level)

    def latest_step(self) -> Optional[int]:
        pfs = self.steps("pfs")
        local = self.steps("local")
        allsteps = sorted(set(pfs) | set(local))
        return allsteps[-1] if allsteps else None

    def step_status(self, step: int, level: str = "pfs") -> Optional[str]:
        """Manifest lifecycle status of ``step`` at ``level`` (``"pfs"``
        or ``"local"``), or ``None`` if no manifest exists there.

        Unlike :meth:`steps` this reports *every* state — including
        ``flush_partial``/``superseded``/``quarantined`` — so operators
        and the serving follower can see why a step is not servable.
        """
        if level == "pfs":
            p = self.pfs_dir / f"step_{step:08d}" / "manifest.json"
        elif level == "local":
            p = self.root / "local" / "manifests" / f"step_{step:08d}.json"
        else:
            raise ValueError(level)
        try:
            return self._cached_manifest(p).status
        except (OSError, ValueError):
            return None

    # ------------------------------------------------- new-step notification

    def subscribe(self, fn: Callable[[int], None]) -> None:
        """Register ``fn(step)`` to fire after each flush reaches
        ``flush_done`` (sync saves, async flushes, and resumed partials
        alike).  Callbacks run on the flushing thread and must be
        cheap/non-blocking — the serving follower just records the step
        and wakes its own thread.  Exceptions are logged, never allowed
        to fail the flush."""
        with self._lock:
            self._subscribers.append(fn)

    def unsubscribe(self, fn: Callable[[int], None]) -> None:
        with self._lock:
            try:
                self._subscribers.remove(fn)
            except ValueError:
                pass

    def _notify_flush_done(self, step: int) -> None:
        with self._lock:
            subs = list(self._subscribers)
        for fn in subs:
            try:
                fn(step)
            except Exception:
                log.exception("flush_done subscriber failed for step %d", step)

    def leaf_catalog(
        self, step: Optional[int] = None, prefix: str = ""
    ) -> Tuple[int, List["LeafEntry"]]:
        """Enumerate the stored leaves of a step without reading any data.

        Returns ``(step, entries)`` where each entry carries the leaf's
        manifest name, dtype, shape, and raw byte range — everything a
        streamed restore needs to plan layer groups before issuing a
        single read.  ``prefix`` filters to a subtree (e.g.
        ``"['params']"``); ``step=None`` picks the newest restorable
        step, falling back PFS → L1 like :meth:`restore_leaves`.
        Raises ``FileNotFoundError`` when no step has leaves under the
        prefix."""
        candidates = (
            [step]
            if step is not None
            else sorted(
                set(self.steps("pfs")) | set(self.steps("local")), reverse=True
            )
        )
        errors: List[str] = []
        for s in candidates:
            for getter, level in (
                (self._manifest_pfs, "pfs"),
                (self._manifest_local, "local"),
            ):
                try:
                    man = getter(s)
                except Exception as e:
                    errors.append(f"step {s} via {level}: {e!r}")
                    continue
                entries = [l for l in man.leaves if l.name.startswith(prefix)]
                if entries:
                    return s, entries
                errors.append(f"step {s}: no leaves under prefix {prefix!r}")
                break  # both levels carry the same leaf table
        raise FileNotFoundError(
            "no step with leaves under prefix "
            f"{prefix!r}; attempts: " + "; ".join(errors[:8])
        )

    def restore(
        self,
        target: Any,
        step: Optional[int] = None,
        *,
        sharding_fn: Optional[Callable[[str, Any], Any]] = None,
    ) -> Tuple[int, Any]:
        """Restore the newest (or given) step into ``target``'s structure.

        Tries, in order: L0 twin, L2 (PFS), L1 (local, incl. partner
        replicas), then older steps.  ``sharding_fn(name, host_tensor)``
        may map each leaf onto devices (elastic re-shard); without it
        every leaf is placed on ``CheckpointConfig.device``.
        """
        candidates: List[int]
        if step is not None:
            candidates = [step]
        else:
            candidates = sorted(
                set(self.steps("pfs")) | set(self.steps("local")), reverse=True
            )
        errors: List[str] = []
        for s in candidates:
            with self._lock:
                l0 = self._l0
            if l0 is not None and l0.step == s:
                tgt = self._decode_target(l0.manifest, target)
                tree = deserialize_tree(l0.stream, l0.manifest.leaves, tgt)
                tree = self._maybe_dequant(l0.manifest, tree, target)
                return s, self._place(tree, sharding_fn)
            for loader in (self._restore_from_pfs, self._restore_from_local):
                try:
                    tree = loader(s, target)
                    return s, self._place(tree, sharding_fn)
                except Exception as e:
                    errors.append(f"step {s} via {loader.__name__}: {e!r}")
        raise FileNotFoundError(
            "no restorable checkpoint found; attempts: " + "; ".join(errors[:8])
        )

    def _place(self, tree: Any, sharding_fn) -> Any:
        if sharding_fn is None:
            return tree_map(lambda t: t.to(self.device), tree)
        named, treedef = flatten_with_names(tree)
        placed = [sharding_fn(name, leaf) for name, leaf in named]
        return unflatten(treedef, placed)

    # -- level loaders ----

    def _manifest_pfs(self, step: int) -> Manifest:
        p = self.pfs_dir / f"step_{step:08d}" / "manifest.json"
        man = self._cached_manifest(p)
        if man.status == "quarantined":
            raise IOError(
                f"step {step}: quarantined (scrub-and-repair found no "
                "intact copy) — excluded from restore and delta-base use"
            )
        if man.status != "flush_done":
            raise IOError(f"step {step}: flush incomplete")
        return man

    def _manifest_local(self, step: int) -> Manifest:
        p = self.root / "local" / "manifests" / f"step_{step:08d}.json"
        man = self._cached_manifest(p)
        if man.status == "quarantined":
            raise IOError(
                f"step {step}: quarantined (scrub-and-repair found no "
                "intact copy) — excluded from restore and delta-base use"
            )
        return man

    @staticmethod
    def _decode_target(man: Manifest, target: Any) -> Any:
        if man.precodec == "int8":
            from repro_torch.core.precodec import quant_target_like

            return quant_target_like(target)
        return target

    def _maybe_dequant(self, man: Manifest, tree: Any, target: Any) -> Any:
        if man.precodec == "int8":
            from repro_torch.core.precodec import dequantize_tree

            return dequantize_tree(tree, target, pool=self._decode_pool())
        return tree

    def _decode_pool(self) -> Optional[ThreadPoolExecutor]:
        """Pool for restore-side work (chunk decompress, CRC, dequant):
        the manager's own local pool — restores never queue behind async
        flush traffic either.  ``parallel_local=False`` keeps the seed's
        sequential decode."""
        return self._local_pool() if self.cfg.parallel_local else None

    def _hedge_policy(
        self, man: Manifest, step: int
    ) -> Optional[HedgePolicy]:
        """Alternate-source read policy for one PFS plan (or ``None``
        when ``hedged_reads`` is off / the manifest has no placement).

        ``alt_read(file_id, file_offset, size)`` inverts the manifest's
        placement back to (rank, blob offset) and serves the extent
        from the surviving L1/partner copy via :meth:`_local_slice` —
        the L1 → partner → PFS preference order the restore ladder
        already encodes.  It returns ``None`` (hedge declines) when no
        local copy survives: hedging may only ever help the tail.
        """
        if not self.cfg.hedged_reads or man.placement is None:
            return None
        pl = man.placement
        order = np.argsort(np.asarray(pl.file_offset), kind="stable")
        fids = np.asarray(pl.file_id)[order]
        f_off = np.asarray(pl.file_offset)[order]
        s_off = np.asarray(pl.src_offset)[order]
        f_sz = np.asarray(pl.size)[order]
        f_rk = np.asarray(pl.rank)[order]
        by_file: Dict[int, Tuple[np.ndarray, ...]] = {}
        for f in np.unique(fids).tolist():
            m = fids == f
            by_file[int(f)] = (f_off[m], s_off[m], f_sz[m], f_rk[m])

        def alt_read(fid: int, foff: int, size: int) -> Optional[bytes]:
            ent = by_file.get(int(fid))
            if ent is None:
                return None
            offs, srcs, szs, rks = ent
            parts: List[bytes] = []
            cur, remaining = int(foff), int(size)
            try:
                while remaining > 0:
                    i = int(np.searchsorted(offs, cur, side="right")) - 1
                    if i < 0 or cur >= int(offs[i]) + int(szs[i]):
                        return None  # hole: not covered by this placement
                    take = min(remaining, int(offs[i]) + int(szs[i]) - cur)
                    parts.append(self._local_slice(
                        man, step, int(rks[i]),
                        int(srcs[i]) + cur - int(offs[i]), take,
                    ))
                    cur += take
                    remaining -= take
            except OSError:
                return None  # no surviving L1/partner copy: decline
            return b"".join(parts)

        return HedgePolicy(
            alt_read=alt_read,
            quantile=self.cfg.hedge_quantile,
            min_delay_s=self.cfg.hedge_min_delay,
        )

    def _reader_weights(self) -> Optional[np.ndarray]:
        """Health-derived per-reader byte weights for
        :func:`~repro_torch.core.plan.assign_readers` — straggler demotion.

        A reader whose observed median pread latency exceeds twice the
        cross-reader median gets its byte share scaled down by the
        slowdown ratio (floored at 1/8 so no reader is starved and its
        recovery stays observable).  ``None`` — the exact unweighted
        assignment — until at least two readers have latency history.
        """
        sh = self.storage_health
        if sh is None or not self.cfg.hedged_reads:
            return None
        n = self.cluster.n_nodes
        if n < 2:
            return None
        meds = [sh.latency_quantile(f"reader:n{k}", 0.5) for k in range(n)]
        known = sorted(m for m in meds if m > 0)
        if len(known) < 2:
            return None
        # lower middle on even counts: with two readers the straggler
        # must compare against the healthy one, not against itself
        global_med = known[(len(known) - 1) // 2]
        if global_med <= 0:
            return None
        w = np.ones(n, np.float64)
        for k, m in enumerate(meds):
            if m > 2.0 * global_med:
                w[k] = max(0.125, global_med / m)
        if np.allclose(w, 1.0):
            return None
        return w

    def _read_blobs_pfs(
        self, man: Manifest, step: int, ranks: Optional[List[int]] = None,
        *, record: bool = True, verify: bool = False,
    ) -> Dict[int, bytearray]:
        """Fetch stored rank blobs through ONE aggregated :class:`ReadPlan`.

        The read-side twin of the flush: the manifest's placement is
        inverted into a :class:`FileLayout`, each requested producer blob
        becomes a byte-range request, and the *current* cluster geometry
        (``self.cluster`` — not the one that saved the checkpoint)
        supplies the reader assignment, so an N-rank save restores onto M
        consumer nodes with balanced ranged preads instead of N
        sequential whole-blob fetches.

        ``verify=True`` hangs the manifest CRC check on the executor's
        ``on_request`` hook, so each blob is verified *on the worker
        pool as it arrives* — integrity work overlaps the remaining
        preads instead of running as a serial pass in ``decode_state``
        afterwards.  All mismatches are collected and raised together
        after the plan drains.
        """
        layout = man.file_layout()
        offsets = man.stored_offsets()
        sizes = np.asarray([r.stored_size for r in man.ranks], np.int64)
        readers = assign_readers(
            sizes, self.cluster.n_nodes, weights=self._reader_weights()
        )
        sel = (
            np.arange(man.world_size, dtype=np.int64)
            if ranks is None
            else np.asarray(sorted(ranks), np.int64)
        )
        rp = build_read_plan(layout, offsets[sel], sizes[sel], readers[sel])
        on_request = None
        bad: List[int] = []
        if verify:
            expected = [man.ranks[int(r)].crc for r in sel.tolist()]

            def on_request(i: int, buf: bytearray) -> None:
                if crc32(buf) != expected[i]:
                    bad.append(int(sel[i]))  # list.append is atomic

        bufs, res = self.executor.execute_read_plan(
            rp, step, on_request=on_request, hedge=self._hedge_policy(man, step)
        )
        if record:  # the scrub passes False so restore telemetry survives
            self.last_read_result = res
        if bad:
            raise IOError(
                f"rank {sorted(bad)[0]}: checksum mismatch on arrival "
                f"({len(bad)} blob(s) failed)"
            )
        return {int(r): b for r, b in zip(sel.tolist(), bufs)}

    def _check_delta_base(self, man: Manifest) -> None:
        """Reject a delta whose base was encoded under a different
        ``precodec``: the XOR would "decode" into bytes that are neither
        transform's stream.  Checked against whichever level's base
        manifest is readable; an unreadable base fails later in
        ``_load_stream`` anyway."""
        if man.base_step is None:
            return
        for getter in (self._manifest_local, self._manifest_pfs):
            try:
                bman = getter(man.base_step)
            except Exception:
                continue
            if bman.precodec != man.precodec:
                raise IOError(
                    f"step {man.step}: delta base {man.base_step} was "
                    f"encoded with precodec {bman.precodec!r}, not "
                    f"{man.precodec!r} — chain is invalid"
                )
            return

    def _restore_from_pfs(self, step: int, target: Any) -> Any:
        man = self._manifest_pfs(step)
        self._check_delta_base(man)
        verify = self.cfg.verify_on_restore
        by_rank = self._read_blobs_pfs(man, step, verify=verify)
        blobs = [by_rank[r] for r in range(man.world_size)]
        base_stream = (
            self._load_stream(man.base_step) if man.base_step is not None else None
        )
        tree = decode_state(
            man, blobs, self._decode_target(man, target), base_stream=base_stream,
            verify=False,  # arrival hook above already CRC-checked each blob
            pool=self._decode_pool(),
        )
        return self._maybe_dequant(man, tree, target)

    def _restore_from_local(self, step: int, target: Any) -> Any:
        man = self._manifest_local(step)
        self._check_delta_base(man)
        blobs = self._local_blobs(man, step)
        base_stream = (
            self._load_stream(man.base_step) if man.base_step is not None else None
        )
        tree = decode_state(
            man, blobs, self._decode_target(man, target), base_stream=base_stream,
            verify=self.cfg.verify_on_restore, pool=self._decode_pool(),
        )
        return self._maybe_dequant(man, tree, target)

    def _local_location(
        self, man: Manifest, step: int, rank: int
    ) -> Tuple[int, bool]:
        """(node, is_partner) of the surviving L1 copy of ``rank``'s blob.

        The single definition of the partner-replication invariant: the
        home node first, else the replica on node+1.  Both full and
        partial local restore resolve through here.
        """
        node = rank // man.procs_per_node
        if self.local.has_blob(node, step, rank):
            return node, False
        partner = (node + 1) % max(1, man.world_size // man.procs_per_node)
        if self.local.has_blob(partner, step, rank, partner=True):
            return partner, True
        raise IOError(f"rank {rank}: no local or partner copy for step {step}")

    def _local_blob(self, man: Manifest, step: int, rank: int) -> bytes:
        node, partner = self._local_location(man, step, rank)
        return self.local.read_blob(node, step, rank, partner=partner)

    def _local_blobs(self, man: Manifest, step: int) -> List[bytes]:
        return [self._local_blob(man, step, r) for r in range(man.world_size)]

    def _local_slice(
        self, man: Manifest, step: int, rank: int, offset: int, size: int
    ) -> bytes:
        node, partner = self._local_location(man, step, rank)
        return self.local.read_slice(
            node, step, rank, offset, size, partner=partner
        )

    def _load_stream(self, step: int) -> Buffer:
        """Raw logical stream of ``step`` (resolving delta chains).

        Decodes through :func:`~repro_torch.core.serialize.decode_stream`
        (preallocated buffer, chunk-parallel on the local pool), with
        PFS arrival-CRC verification; a damaged level falls through to
        the next one instead of aborting the chain.
        """
        with self._lock:
            if self._l0 is not None and self._l0.step == step:
                return self._l0.stream
            if self._last_full is not None and self._last_full.step == step:
                return self._last_full.stream
        verify = self.cfg.verify_on_restore
        errors: List[str] = []
        for getter, pfs in (
            (self._manifest_pfs, True),
            (self._manifest_local, False),
        ):
            try:
                man = getter(step)
                self._check_delta_base(man)
                if pfs:
                    by_rank = self._read_blobs_pfs(man, step, verify=verify)
                    blobs: List[Any] = [by_rank[r] for r in range(man.world_size)]
                else:
                    blobs = self._local_blobs(man, step)
                base = (
                    self._load_stream(man.base_step)
                    if man.base_step is not None
                    else None
                )
                return decode_stream(
                    man, blobs, base_stream=base,
                    verify=verify and not pfs,  # pfs: verified on arrival
                    pool=self._decode_pool(),
                )
            except Exception as e:
                errors.append(f"{'pfs' if pfs else 'local'}: {e!r}")
        raise IOError(
            f"cannot load base stream for step {step}; " + "; ".join(errors)
        )

    # -------------------------------------------------------- partial restore

    def restore_leaves(
        self, names: List[str], step: Optional[int] = None
    ) -> Tuple[int, Dict[str, torch.Tensor]]:
        """Restore only the named leaves (manifest leaf names) as host
        tensors, without touching the rest of the checkpoint.

        With ``codec="none"`` this reads *exactly* the leaves' byte
        ranges from the aggregated files (a partial :class:`ReadPlan`) —
        the serving-fleet workload: pull just the params out of a
        multi-GB train-state checkpoint.  With a chunk-framed
        compression codec, only the *chunks* covering those ranges are
        read and decompressed (base-referencing delta chunks recurse
        into the base step for just their own ranges); legacy
        whole-blob checkpoints fall back to reading the covering
        producer blobs (still one aggregated plan each way).

        Integrity: whole-blob paths verify the per-blob CRC and
        chunk-framed paths the per-chunk CRCs, so compressed partial
        restores are fully verified; only codec-``none`` sub-blob
        ranged reads have no checksum of their own — run
        :meth:`validate` scrubs for cold-checkpoint assurance there.

        Falls back PFS -> L1 like :meth:`restore`.  Checkpoints saved
        with a ``precodec`` raise :class:`UnsupportedPrecodecError` at
        plan time — before any blob or extent read is issued, and
        *without* falling through to an older step (the stored leaves
        are the transformed tree; restore them with :meth:`restore`).
        """
        candidates = (
            [step]
            if step is not None
            else sorted(set(self.steps("pfs")) | set(self.steps("local")), reverse=True)
        )
        errors: List[str] = []
        for s in candidates:
            for getter, pfs in (
                (self._manifest_pfs, True),
                (self._manifest_local, False),
            ):
                try:
                    man = getter(s)
                    return s, self._leaves_from(man, s, names, pfs=pfs)
                except UnsupportedPrecodecError:
                    # never falls through to an older step: silently
                    # serving stale leaves is worse than failing loudly
                    raise
                except Exception as e:
                    errors.append(
                        f"step {s} via {'pfs' if pfs else 'local'}: {e!r}"
                    )
        raise FileNotFoundError(
            "no checkpoint with the requested leaves; attempts: "
            + "; ".join(errors[:8])
        )

    def restore_subtree(
        self,
        target: Any,
        prefix: str,
        step: Optional[int] = None,
        *,
        sharding_fn: Optional[Callable[[str, Any], Any]] = None,
    ) -> Tuple[int, Any]:
        """Restore the subtree saved under ``prefix`` into ``target``.

        ``prefix`` is the leaf-name prefix in the saved tree: a snapshot
        saved as ``{"params": P, "opt": O}`` yields leaf names like
        ``"['params']['w']"``, so ``restore_subtree(params_template,
        "['params']")`` rebuilds P alone — the elastic-serving entry
        point (:meth:`repro_torch.serve.engine.Server.from_checkpoint`).
        """
        named, treedef = flatten_with_names(target)
        names = [prefix + n for n, _ in named]
        step_out, vals = self.restore_leaves(names, step=step)
        tree = unflatten(treedef, [vals[n] for n in names])
        return step_out, self._place(tree, sharding_fn)

    def _leaves_from(
        self, man: Manifest, step: int, names: List[str], *, pfs: bool
    ) -> Dict[str, torch.Tensor]:
        # plan-time rejection: nothing has been read beyond the manifest
        if man.precodec != "none":
            raise UnsupportedPrecodecError(
                f"step {step}: partial restore unsupported with precodec "
                f"{man.precodec!r} — restore() handles the inverse transform"
            )
        entries = {l.name: l for l in man.leaves}
        ranges = man.leaf_ranges(names)
        segs = self._raw_segments(
            man, step, [(a, a + s) for _, a, s in ranges], pfs=pfs
        )
        out: Dict[str, torch.Tensor] = {}
        for (n, _, size), seg in zip(ranges, segs):
            e = entries[n]
            if len(seg) != size:
                raise IOError(f"leaf {n}: read {len(seg)} of {size} bytes")
            out[n] = leaf_from_bytes(seg, e.dtype, e.shape)
        return out

    def _raw_segments(
        self,
        man: Manifest,
        step: int,
        intervals: List[Tuple[int, int]],
        *,
        pfs: bool,
    ) -> List[Buffer]:
        """Bytes of arbitrary raw-space intervals of one checkpoint,
        reading as little stored data as the manifest's framing allows.

        * codec ``none`` — stored == raw byte for byte: exactly the
          requested ranges (one aggregated plan on PFS, ranged L1
          slices locally).
        * chunk-framed compression — only the *chunks* covering the
          intervals: their stored extents merge into minimal requests
          (:func:`~repro_torch.core.plan.merge_intervals`) for one aggregated
          plan (PFS) or ranged L1 slices (local); each fetched chunk is
          CRC-verified individually — sub-blob reads are no longer an
          integrity blind spot — and base-referencing/delta chunks pull
          just their own byte ranges out of the base step, recursively,
          instead of materializing the whole base stream.
        * legacy whole-blob compression — the covering rank blobs (the
          pre-chunking behaviour).
        """
        if man.codec == "none":
            return self._raw_segments_codec_none(man, step, intervals, pfs=pfs)
        if man.chunks is not None:
            return self._raw_segments_chunked(man, step, intervals, pfs=pfs)
        return self._raw_segments_whole_blob(man, step, intervals, pfs=pfs)

    def _raw_segments_codec_none(
        self, man, step, intervals, *, pfs: bool
    ) -> List[Buffer]:
        if pfs:
            offs = [a for a, _ in intervals]
            szs = [b - a for a, b in intervals]
            readers = assign_readers(
                szs, self.cluster.n_nodes, weights=self._reader_weights()
            )
            rp = build_read_plan(man.file_layout(), offs, szs, readers)
            bufs, res = self.executor.execute_read_plan(
                rp, step, hedge=self._hedge_policy(man, step)
            )
            self.last_read_result = res
            return bufs
        out: List[Buffer] = []
        for a, b in intervals:
            parts = []
            for rk in man.ranks_covering(a, b):
                e = man.ranks[rk]
                lo, hi = max(a, e.offset), min(b, e.offset + e.raw_size)
                parts.append(
                    self._local_slice(man, step, rk, lo - e.offset, hi - lo)
                )
            out.append(b"".join(parts))
        return out

    def _raw_segments_chunked(
        self, man, step, intervals, *, pfs: bool
    ) -> List[Buffer]:
        table = man.chunks
        # 1. chunk rows covering the intervals (global row indices)
        need: List[np.ndarray] = []
        for a, b in intervals:
            for rk in man.ranks_covering(a, b):
                e = man.ranks[rk]
                need.append(
                    table.covering(rk, max(a, e.offset) - e.offset,
                                   min(b, e.offset + e.raw_size) - e.offset)
                )
        all_rows = (
            np.unique(np.concatenate(need)) if need else np.empty(0, np.int64)
        )

        # 1b. decoded-chunk cache (node-local, shared across co-located
        #     servers): rows already decoded for this step — by an
        #     earlier replica's restore, or as another step's delta
        #     base — skip the stored read AND the decode entirely.
        cache = self.chunk_cache
        cached: Dict[int, np.ndarray] = {}
        if cache is not None and len(all_rows):
            for row in all_rows.tolist():
                hit = cache.get((step, int(row)))
                if hit is not None:
                    cached[int(row)] = hit
        rows = (
            all_rows[~np.isin(all_rows, np.fromiter(cached, np.int64))]
            if cached
            else all_rows
        )
        rank_of = np.searchsorted(table.rank_starts, rows, side="right") - 1

        # 2. fetch the stored payloads of every non-base-ref chunk
        payloads: Dict[int, Buffer] = {}
        stored = rows[table.stored_len[rows] > 0]
        if pfs and len(stored):
            offsets = man.stored_offsets()
            g_off = (
                offsets[np.searchsorted(table.rank_starts, stored, side="right") - 1]
                + table.stored_off[stored]
            )
            g_len = table.stored_len[stored]
            req_start, req_size = merge_intervals(g_off, g_len)
            readers = assign_readers(
                req_size, self.cluster.n_nodes, weights=self._reader_weights()
            )
            rp = build_read_plan(man.file_layout(), req_start, req_size, readers)
            bufs, res = self.executor.execute_read_plan(
                rp, step, hedge=self._hedge_policy(man, step)
            )
            self.last_read_result = res
            views = [memoryview(b) for b in bufs]
            req_of = np.searchsorted(req_start, g_off, side="right") - 1
            for row, q, off, ln in zip(
                stored.tolist(), req_of.tolist(),
                (g_off - req_start[req_of]).tolist(), g_len.tolist(),
            ):
                payloads[row] = views[q][off : off + ln]
        else:
            for row, rk in zip(stored.tolist(),
                               (np.searchsorted(table.rank_starts, stored,
                                                side="right") - 1).tolist()):
                payloads[row] = self._local_slice(
                    man, step, rk,
                    int(table.stored_off[row]), int(table.stored_len[row]),
                )

        # 3. base byte ranges for base-referencing / delta chunks —
        #    recursively partial against the base step (never the whole
        #    base stream)
        base_rows = rows[
            (table.flags[rows] & (CHUNK_BASE | CHUNK_DELTA)) != 0
        ]
        base_segs: Dict[int, Buffer] = {}
        if len(base_rows):
            if man.base_step is None:
                raise IOError("base-referencing chunks without a base step")
            br_rank = np.searchsorted(table.rank_starts, base_rows, side="right") - 1
            b_ivs = [
                (man.ranks[int(rk)].offset + int(table.raw_off[row]),
                 man.ranks[int(rk)].offset + int(table.raw_off[row])
                 + int(table.raw_len[row]))
                for row, rk in zip(base_rows.tolist(), br_rank.tolist())
            ]
            # the recursive base fetch runs its own read plans; restore
            # *this* step's stats afterwards so last_read_result keeps
            # describing the plan the caller asked about
            outer_rr = self.last_read_result
            try:
                for row, seg in zip(
                    base_rows.tolist(),
                    self._base_raw_segments(man.base_step, b_ivs),
                ):
                    base_segs[row] = seg
            finally:
                self.last_read_result = outer_rr

        # 4. decode each needed chunk (pooled: disjoint outputs, the
        #    decompressor releases the GIL) with per-chunk CRC verify
        verify = self.cfg.verify_on_restore
        impl = man.codec_impl or default_codec_impl()
        decoded: Dict[int, np.ndarray] = {
            int(row): np.empty(int(table.raw_len[row]), np.uint8)
            for row in rows.tolist()
        }

        def decode_row(row: int) -> None:
            rl = int(table.raw_len[row])
            decode_chunk_into(
                decoded[row],
                payloads.get(row, b""),
                int(table.flags[row]),
                int(table.crc[row]),
                rl,
                base_segs.get(row),
                impl,
                verify=verify,
                digest=(
                    int(table.digest[row])
                    if (verify and table.digest is not None)
                    else None
                ),
                what=f"rank {int(rank_of[np.searchsorted(rows, row)])} chunk",
            )

        _run_grouped(self._decode_pool(), decode_row, rows.tolist())

        if cache is not None:
            for row, arr in decoded.items():
                cache.put((step, row), arr)
        decoded.update(cached)

        # 5. assemble each interval from the decoded chunks
        out: List[Buffer] = []
        for a, b in intervals:
            seg = np.empty(b - a, np.uint8)
            for rk in man.ranks_covering(a, b):
                e = man.ranks[rk]
                lo, hi = max(a, e.offset), min(b, e.offset + e.raw_size)
                for row in table.covering(rk, lo - e.offset, hi - e.offset).tolist():
                    g = e.offset + int(table.raw_off[row])  # chunk's global start
                    cs = max(lo, g)
                    ce = min(hi, g + int(table.raw_len[row]))
                    seg[cs - a : ce - a] = decoded[row][cs - g : ce - g]
            out.append(seg)
        return out

    def _raw_segments_whole_blob(
        self, man, step, intervals, *, pfs: bool
    ) -> List[Buffer]:
        """Legacy (pre-chunking) compressed manifests: whole covering
        blobs, one aggregated plan."""
        need = sorted(
            {rk for a, b in intervals for rk in man.ranks_covering(a, b)}
        )
        verify = self.cfg.verify_on_restore
        if pfs:
            blobs = self._read_blobs_pfs(man, step, ranks=need, verify=verify)
        else:
            blobs = {rk: self._local_blob(man, step, rk) for rk in need}
        base = (
            self._load_stream(man.base_step)
            if man.base_step is not None
            else None
        )
        seg: Dict[int, bytes] = {}
        for rk in need:
            e = man.ranks[rk]
            if verify and not pfs and crc32(blobs[rk]) != e.crc:
                raise IOError(f"rank {rk}: checksum mismatch")
            seg_base = (
                base[e.offset : e.offset + e.raw_size]
                if base is not None
                else None
            )
            seg[rk] = decode_blob_reference(
                blobs[rk], man.codec, e.raw_size, seg_base,
                has_base=man.base_step is not None,
                impl=man.codec_impl or None,
            )
        out: List[Buffer] = []
        for a, b in intervals:
            parts = []
            for rk in man.ranks_covering(a, b):
                e = man.ranks[rk]
                lo, hi = max(a, e.offset), min(b, e.offset + e.raw_size)
                parts.append(seg[rk][lo - e.offset : hi - e.offset])
            out.append(b"".join(parts))
        return out

    def _base_raw_segments(
        self, base_step: int, intervals: List[Tuple[int, int]]
    ) -> List[Buffer]:
        """Raw byte ranges of a delta base, cheapest source first: the
        in-memory L0/last-full twin, else a recursive partial read of
        the base checkpoint (PFS then L1), else the full stream."""
        with self._lock:
            for cand in (self._l0, self._last_full):
                if cand is not None and cand.step == base_step:
                    stream = cand.stream
                    return [stream[a:b] for a, b in intervals]
        errors: List[str] = []
        for getter, pfs in (
            (self._manifest_pfs, True),
            (self._manifest_local, False),
        ):
            try:
                bman = getter(base_step)
                return self._raw_segments(bman, base_step, intervals, pfs=pfs)
            except Exception as e:
                errors.append(repr(e))
        stream = self._load_stream(base_step)  # last resort (raises if gone)
        return [stream[a:b] for a, b in intervals]

    # ----------------------------------------------------------------- scrub

    def validate(self, step: int, *, repair: bool = False) -> Dict[str, Any]:
        """Integrity scrub of one checkpoint: re-read every rank blob on
        every available level and verify its manifest CRC.

        Returns ``{"pfs": {rank: ok}, "local": {rank: ok}, "partner":
        {rank: ok}}`` (levels missing entirely are reported as ``{}``;
        ``partner`` only appears when partner replication is configured).
        Production fleets run this against cold checkpoints before
        relying on them for elastic restarts.

        ``repair=True`` turns the scrub into scrub-and-repair
        (:func:`repro_torch.core.repair.repair_step`): damaged PFS extents are
        rewritten from surviving L1/partner copies through the columnar
        placement, lost L1/partner blobs are re-replicated from the PFS
        (anti-entropy), and a step with *no* intact copy of some rank is
        quarantined — the report gains ``"repair"`` (a
        :class:`~repro_torch.core.repair.RepairReport`) and ``"post"`` (the
        re-scrub after repair).
        """
        report = self._scrub(step)
        if repair:
            from repro_torch.core.repair import repair_step

            report["repair"] = repair_step(self, step, scrub=report)
            report["post"] = self._scrub(step)
        return report

    def _scrub(self, step: int) -> Dict[str, Any]:
        report: Dict[str, Any] = {"pfs": {}, "local": {}}
        try:
            man = self._manifest_pfs(step)
            try:
                layout = man.file_layout()
            except Exception:
                layout = None
            # Aggregated read plans in byte-bounded batches: one plan per
            # ~256 MiB of blobs keeps the ranged-pread win without
            # materializing a paper-scale checkpoint in memory at once.
            batch_limit = 256 << 20
            batch: List[int] = []
            batch_bytes = 0
            for r in range(man.world_size):
                batch.append(r)
                batch_bytes += man.ranks[r].stored_size
                if batch_bytes >= batch_limit or r == man.world_size - 1:
                    self._scrub_batch(man, step, batch, layout, report["pfs"])
                    batch, batch_bytes = [], 0
        except Exception:
            pass
        try:
            man = self._manifest_local(step)
            ppn = man.procs_per_node
            n_nodes = max(1, man.world_size // ppn)
            replicated = self.cfg.partner_replication and n_nodes > 1
            if replicated:
                report["partner"] = {}
            for r in range(man.world_size):
                try:
                    blob = self.local.read_blob(r // ppn, step, r)
                    report["local"][r] = crc32(blob) == man.ranks[r].crc
                except Exception:
                    report["local"][r] = False
                if replicated:
                    partner = (r // ppn + 1) % n_nodes
                    try:
                        blob = self.local.read_blob(
                            partner, step, r, partner=True
                        )
                        report["partner"][r] = crc32(blob) == man.ranks[r].crc
                    except Exception:
                        report["partner"][r] = False
        except Exception:
            pass
        return report

    def _scrub_batch(
        self,
        man: Manifest,
        step: int,
        batch: List[int],
        layout,
        out: Dict[int, bool],
    ) -> None:
        """CRC-check one batch of ranks; a damaged file fails the batch's
        aggregated read, so degrade to per-rank reads (sharing the
        already-inverted layout) and keep intact ranks reporting healthy."""
        try:
            if layout is None:
                raise IOError("placement does not invert")
            blobs = self._read_blobs_pfs(man, step, ranks=batch, record=False)
            for r in batch:
                out[r] = crc32(blobs[r]) == man.ranks[r].crc
        except Exception:
            for r in batch:
                try:
                    blob = self.executor.read_rank_blob(man, step, r, layout)
                    out[r] = crc32(blob) == man.ranks[r].crc
                except Exception:
                    out[r] = False

    # ------------------------------------------------------------------- gc

    def _gc(self) -> None:
        keep = self.cfg.keep_n
        pfs_steps = self.steps("pfs")
        # No early-out at len(pfs_steps) <= keep: under supersession
        # most steps never reach flush_done, and their L1/partial-PFS
        # leavings still need reaping below the newest kept checkpoint.
        if keep is None or not pfs_steps:
            return
        with self._lock:
            pins = set(self._pins)
        # Operator pins widen retention beyond the keep_n window: a
        # pinned step (and, via the chain walk below, its delta bases)
        # survives GC until unpinned, whatever its age.
        kept = set(pfs_steps[-keep:]) | pins
        # Retain delta bases of kept steps.  The chain must traverse
        # *any* surviving manifest, not just flush_done ones: under
        # supersession a base step's PFS manifest may be superseded (or
        # absent) while its L1 level is exactly what keeps the kept
        # checkpoint restorable — breaking the walk there would let the
        # sweep below delete live bases, full-snapshot anchors included.
        needed = set(kept)
        for s in kept:
            cur = s
            while True:
                man = None
                for getter in (self._gc_manifest_any, self._manifest_local):
                    try:
                        man = getter(cur)
                        break
                    except Exception:
                        continue
                if man is None or man.base_step is None:
                    break
                needed.add(man.base_step)
                cur = man.base_step
        # Sweep set: every step known to either level — including steps
        # that never reached flush_done (superseded, or stale partials
        # the operator chose not to resume).  Under a fast supersession
        # cadence those are the *majority* of steps, and their L1 blobs
        # and partial PFS dirs must not accumulate past the retention
        # window.  Steps newer than the newest kept checkpoint, and
        # steps still queued/mid-flight, are left alone (they may still
        # be flushing or awaiting resume).
        with self._lock:
            # parked steps are shielded like mid-resume ones: their
            # journaled flush_partial state is what the post-outage
            # drain finishes — only supersession/eviction may drop it
            pending = set(self._pending) | set(self._resuming) | set(self._parked)
        max_kept = max(kept)
        known = set(pfs_steps)
        for d in self.pfs_dir.glob("step_*"):
            try:
                known.add(int(d.name[5:]))
            except ValueError:
                continue
        for p in (self.root / "local" / "manifests").glob("step_*.json"):
            try:
                known.add(int(p.stem[5:]))
            except ValueError:
                continue
        for s in sorted(known):
            if s in needed or s in pending or s > max_kept:
                continue
            sdir = self.pfs_dir / f"step_{s:08d}"
            if sdir.exists():
                shutil.rmtree(sdir)
            self.local.gc_step(s)
            mp = self.root / "local" / "manifests" / f"step_{s:08d}.json"
            if mp.exists():
                mp.unlink()
            # evict the deleted step's parsed manifests — at paper scale
            # each caches MBs of placement columns, and a long run with
            # GC must not accumulate one dead entry per checkpoint taken
            with self._lock:
                self._man_cache.pop(str(sdir / "manifest.json"), None)
                self._man_cache.pop(str(mp), None)
                self._l1_bytes.pop(s, None)
                self._l1_anchors.discard(s)

    # ------------------------------------------------------------- manifests

    def _gc_manifest_any(self, step: int) -> Manifest:
        """PFS manifest of ``step`` in *any* status — GC chain walking
        only needs ``base_step``, unlike the restore path's
        :meth:`_manifest_pfs` which rightly rejects non-final states."""
        return self._cached_manifest(
            self.pfs_dir / f"step_{step:08d}" / "manifest.json"
        )

    def _write_manifest_local(self, man: Manifest) -> None:
        p = self.root / "local" / "manifests" / f"step_{man.step:08d}.json"
        tmp = p.with_suffix(".tmp")
        tmp.write_text(man.to_json())
        tmp.replace(p)

    def _write_manifest_pfs(self, man: Manifest) -> None:
        p = self.pfs_dir / f"step_{man.step:08d}" / "manifest.json"
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(man.to_json())
        tmp.replace(p)
