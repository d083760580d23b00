"""Flush *and* read plans: the executable descriptions of one
asynchronous flush (write side) and one restore/reshard (read side).

Write side
==========

An aggregation *strategy* is a pure function
``(ClusterSpec, rank_sizes) -> FlushPlan``.  The plan lists every byte
movement needed to move N rank-local checkpoints into M remote files:

* ``SendItem`` — a gather hop: bytes of some rank's checkpoint shipped
  from the active backend holding them to a leader backend (network).
* ``WriteItem`` — a PFS write issued by one backend: (file, offset, size)
  sourced from some rank's checkpoint blob at ``src_offset``.

At paper scale (thousands of nodes x 32 ranks/node) a plan holds 10^5+
movements, so the canonical representation is *columnar*:
:class:`PlanArrays` stores parallel int64 NumPy columns per write/send
plus a file-name table, and every hot path (strategy builders,
:func:`validate_plan`, the simulator front-end) is an array program over
those columns.  The frozen ``WriteItem``/``SendItem`` dataclasses remain
the item-level view — ``plan.writes``/``plan.sends`` materialize them
lazily for the real executor and small-scale consumers, and
``PlanArrays.from_items`` converts back, losslessly.

Column semantics (all parallel int64 arrays; one row per movement):

:class:`WriteColumns`
    * ``backend``     — node id of the active backend issuing the write
    * ``file_id``     — index into ``PlanArrays.file_names``
    * ``file_offset`` — destination byte offset inside that file (>= 0)
    * ``size``        — bytes moved (> 0)
    * ``src_rank``    — whose stored checkpoint blob the bytes come from
    * ``src_offset``  — offset inside that rank's stored blob (>= 0)
    * ``round``       — barrier round (MPI-IO multi-phase); 0 = free-running

:class:`SendColumns`
    * ``src_backend`` — the source rank's home node (must hold the blob)
    * ``dst_backend`` — the leader/aggregator node receiving the bytes
    * ``src_rank`` / ``src_offset`` / ``size`` / ``round`` — as above

Invariants, enforced by :func:`validate_plan` (columnar) and its
executable spec :func:`validate_plan_reference` (item-loop):

1. *source coverage* — per rank, write ``src`` slices tile
   ``[0, stored_size)`` exactly (no gap, no overlap, no double write);
2. *destination disjointness* — per file, ``[file_offset, +size)``
   intervals never overlap and stay within the declared file size;
3. *send coverage* — every write issued by a backend other than the
   source rank's home node is fed by sends covering exactly those bytes,
   and every send originates at the source rank's home node;
4. *stripe disjointness* (when ``plan.stripe_disjoint``) — no PFS stripe
   has two distinct writers.

Read side
=========

The restore path inverts the write side.  :class:`FileLayout` is the
extent table of where every *stored-space* byte landed (stored space =
the concatenation of all rank blobs in rank order); it is derived either
from a ``FlushPlan`` (:meth:`FileLayout.from_flush_plan`) or from a
saved manifest's placement (``Manifest.file_layout()``).  A *consumer* —
a restore onto an arbitrary new geometry, or a partial (per-leaf)
restore for serving — states byte-range *requests* against stored space,
and :func:`build_read_plan` maps them onto file extents as an array
program (``np.searchsorted`` over the layout's ``start`` column — no
per-item Python loops), so planning a 100k-rank restore is milliseconds.

Chunk-framed checkpoints (see :mod:`repro_torch.core.serialize`) need nothing
special here: a chunk's stored payload is an ordinary stored-space
interval (``rank stored offset + chunk stored_off``), so partial restore
under compression asks for exactly the chunks covering the requested
leaves — merged into minimal requests by :func:`merge_intervals` — and
the same planner/validator/executor machinery serves whole-blob and
chunk-granular reads alike.

:class:`ReadColumns` (parallel int64; one row per ranged ``pread``):
    * ``reader``      — consumer-side node issuing the read (work unit
      owner for the thread pool; the read twin of ``backend``)
    * ``file_id``     — index into ``ReadPlan.file_names``
    * ``file_offset`` — source byte offset inside that file (>= 0)
    * ``size``        — bytes read (> 0)
    * ``dst_req``     — index of the request this piece satisfies
    * ``dst_offset``  — destination offset inside that request's buffer

Invariants, enforced by :func:`validate_read_plan`:

1. *request coverage* — per request, ``dst`` slices tile
   ``[0, req_size)`` exactly (restore never invents or drops a byte);
2. *in-bounds reads* — every ``[file_offset, +size)`` stays inside the
   declared file size;
3. *layout consistency* (when the layout is supplied) — each read's file
   extent is exactly where the layout says the request's stored bytes
   live.

Executors (real files / discrete-event simulator) consume plans without
knowing which strategy produced them — this is the co-design seam the
paper argues for: strategy decides *who writes what where*, the executor
and its contention model price/perform it.  The read side keeps the same
seam: layout inversion decides *who reads what from where*, and
``RealExecutor.execute_read_plan`` performs it.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.prefix_sum import LeaderAssignment, ScanMeta


@dataclass(frozen=True)
class WriteItem:
    backend: int        # node id of the active backend issuing the write
    file: str           # logical remote file name
    file_offset: int
    size: int
    src_rank: int       # whose checkpoint blob this slice comes from
    src_offset: int     # offset inside that rank's blob
    round: int = 0      # barrier round (MPI-IO multi-phase); 0 = unsynchronized

    def __post_init__(self):
        if self.size <= 0:
            raise ValueError("WriteItem.size must be positive")
        if self.file_offset < 0 or self.src_offset < 0:
            raise ValueError("offsets must be non-negative")


@dataclass(frozen=True)
class SendItem:
    src_backend: int
    dst_backend: int
    src_rank: int
    src_offset: int
    size: int
    round: int = 0

    def __post_init__(self):
        if self.size <= 0:
            raise ValueError("SendItem.size must be positive")


# ---------------------------------------------------------------------------
# Columnar (structure-of-arrays) plan core
# ---------------------------------------------------------------------------


def _i64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int64)


_W_COLS = ("backend", "file_id", "file_offset", "size", "src_rank", "src_offset", "round")
_S_COLS = ("src_backend", "dst_backend", "src_rank", "src_offset", "size", "round")


@dataclass
class WriteColumns:
    """Parallel int64 columns, one row per :class:`WriteItem`."""

    backend: np.ndarray
    file_id: np.ndarray
    file_offset: np.ndarray
    size: np.ndarray
    src_rank: np.ndarray
    src_offset: np.ndarray
    round: np.ndarray

    def __post_init__(self):
        for name in _W_COLS:
            setattr(self, name, _i64(getattr(self, name)))
        if len({getattr(self, c).shape for c in _W_COLS}) != 1:
            raise ValueError("WriteColumns columns must have identical length")

    def __len__(self) -> int:
        return len(self.backend)

    @staticmethod
    def empty() -> "WriteColumns":
        z = np.empty(0, np.int64)
        return WriteColumns(z, z, z, z, z, z, z)

    def take(self, idx: np.ndarray) -> "WriteColumns":
        return WriteColumns(*(getattr(self, c)[idx] for c in _W_COLS))

    def with_round(self, rnd: int) -> "WriteColumns":
        cols = {c: getattr(self, c) for c in _W_COLS}
        cols["round"] = np.full(len(self), int(rnd), np.int64)
        return WriteColumns(**cols)

    @staticmethod
    def concat(parts: Sequence["WriteColumns"]) -> "WriteColumns":
        parts = [p for p in parts if len(p)]
        if not parts:
            return WriteColumns.empty()
        return WriteColumns(
            *(np.concatenate([getattr(p, c) for p in parts]) for c in _W_COLS)
        )


@dataclass
class SendColumns:
    """Parallel int64 columns, one row per :class:`SendItem`."""

    src_backend: np.ndarray
    dst_backend: np.ndarray
    src_rank: np.ndarray
    src_offset: np.ndarray
    size: np.ndarray
    round: np.ndarray

    def __post_init__(self):
        for name in _S_COLS:
            setattr(self, name, _i64(getattr(self, name)))
        if len({getattr(self, c).shape for c in _S_COLS}) != 1:
            raise ValueError("SendColumns columns must have identical length")

    def __len__(self) -> int:
        return len(self.src_backend)

    @staticmethod
    def empty() -> "SendColumns":
        z = np.empty(0, np.int64)
        return SendColumns(z, z, z, z, z, z)

    def take(self, idx: np.ndarray) -> "SendColumns":
        return SendColumns(*(getattr(self, c)[idx] for c in _S_COLS))

    def with_round(self, rnd: int) -> "SendColumns":
        cols = {c: getattr(self, c) for c in _S_COLS}
        cols["round"] = np.full(len(self), int(rnd), np.int64)
        return SendColumns(**cols)

    @staticmethod
    def concat(parts: Sequence["SendColumns"]) -> "SendColumns":
        parts = [p for p in parts if len(p)]
        if not parts:
            return SendColumns.empty()
        return SendColumns(
            *(np.concatenate([getattr(p, c) for p in parts]) for c in _S_COLS)
        )


def coalesce_write_columns(w: WriteColumns) -> WriteColumns:
    """Merge contiguous runs with identical (round, backend, file, rank).

    The columnar twin of the planner's item-level coalescing: one
    ``np.lexsort`` plus a boundary-difference pass.  Two sorted rows merge
    when both the destination and source offsets are contiguous.
    """
    if len(w) <= 1:
        return w
    order = np.lexsort((w.file_offset, w.src_rank, w.file_id, w.backend, w.round))
    b = w.take(order)
    same = (
        (b.round[1:] == b.round[:-1])
        & (b.backend[1:] == b.backend[:-1])
        & (b.file_id[1:] == b.file_id[:-1])
        & (b.src_rank[1:] == b.src_rank[:-1])
        & (b.file_offset[1:] == b.file_offset[:-1] + b.size[:-1])
        & (b.src_offset[1:] == b.src_offset[:-1] + b.size[:-1])
    )
    starts = np.flatnonzero(np.concatenate(([True], ~same)))
    return WriteColumns(
        backend=b.backend[starts],
        file_id=b.file_id[starts],
        file_offset=b.file_offset[starts],
        size=np.add.reduceat(b.size, starts),
        src_rank=b.src_rank[starts],
        src_offset=b.src_offset[starts],
        round=b.round[starts],
    )


def coalesce_send_columns(s: SendColumns) -> SendColumns:
    if len(s) <= 1:
        return s
    order = np.lexsort((s.src_offset, s.src_rank, s.dst_backend, s.src_backend, s.round))
    b = s.take(order)
    same = (
        (b.round[1:] == b.round[:-1])
        & (b.src_backend[1:] == b.src_backend[:-1])
        & (b.dst_backend[1:] == b.dst_backend[:-1])
        & (b.src_rank[1:] == b.src_rank[:-1])
        & (b.src_offset[1:] == b.src_offset[:-1] + b.size[:-1])
    )
    starts = np.flatnonzero(np.concatenate(([True], ~same)))
    return SendColumns(
        src_backend=b.src_backend[starts],
        dst_backend=b.dst_backend[starts],
        src_rank=b.src_rank[starts],
        src_offset=b.src_offset[starts],
        size=np.add.reduceat(b.size, starts),
        round=b.round[starts],
    )


@dataclass
class PlanArrays:
    """Columnar plan: write/send columns + the file-name table.

    ``file_names[file_id]`` resolves a write's ``file_id`` column to its
    logical file name; conversion to/from ``WriteItem``/``SendItem``
    lists is lossless (:meth:`from_items` / :meth:`to_write_items`).
    """

    file_names: List[str]
    writes: WriteColumns
    sends: SendColumns

    @property
    def n_writes(self) -> int:
        return len(self.writes)

    @property
    def n_sends(self) -> int:
        return len(self.sends)

    @staticmethod
    def from_items(
        writes: Sequence[WriteItem],
        sends: Sequence[SendItem] = (),
        file_names: Optional[Sequence[str]] = None,
    ) -> "PlanArrays":
        names: List[str] = list(file_names) if file_names is not None else []
        fid: Dict[str, int] = {nm: i for i, nm in enumerate(names)}
        w_file = np.empty(len(writes), np.int64)
        for i, w in enumerate(writes):
            j = fid.get(w.file)
            if j is None:
                j = fid[w.file] = len(names)
                names.append(w.file)
            w_file[i] = j
        wc = WriteColumns(
            backend=[w.backend for w in writes],
            file_id=w_file,
            file_offset=[w.file_offset for w in writes],
            size=[w.size for w in writes],
            src_rank=[w.src_rank for w in writes],
            src_offset=[w.src_offset for w in writes],
            round=[w.round for w in writes],
        )
        sc = SendColumns(
            src_backend=[s.src_backend for s in sends],
            dst_backend=[s.dst_backend for s in sends],
            src_rank=[s.src_rank for s in sends],
            src_offset=[s.src_offset for s in sends],
            size=[s.size for s in sends],
            round=[s.round for s in sends],
        )
        return PlanArrays(file_names=names, writes=wc, sends=sc)

    def to_write_items(self) -> List[WriteItem]:
        w = self.writes
        names = self.file_names
        return [
            WriteItem(backend=b, file=names[f], file_offset=fo, size=sz,
                      src_rank=sr, src_offset=so, round=rd)
            for b, f, fo, sz, sr, so, rd in zip(
                w.backend.tolist(), w.file_id.tolist(), w.file_offset.tolist(),
                w.size.tolist(), w.src_rank.tolist(), w.src_offset.tolist(),
                w.round.tolist(),
            )
        ]

    def to_send_items(self) -> List[SendItem]:
        s = self.sends
        return [
            SendItem(src_backend=sb, dst_backend=db, src_rank=sr,
                     src_offset=so, size=sz, round=rd)
            for sb, db, sr, so, sz, rd in zip(
                s.src_backend.tolist(), s.dst_backend.tolist(),
                s.src_rank.tolist(), s.src_offset.tolist(),
                s.size.tolist(), s.round.tolist(),
            )
        ]


class FlushPlan:
    """One flush, in columnar and/or item form.

    Strategy builders construct plans columnar (``arrays=...``);
    ``plan.writes`` / ``plan.sends`` materialize the item lists lazily on
    first access, so the real executor and small-scale consumers keep
    their interface while the hot paths never touch Python objects.
    Mutating the materialized lists is not supported — build a new plan.
    """

    def __init__(
        self,
        strategy: str,
        cluster: ClusterSpec,
        rank_sizes: List[int],
        files: Dict[str, int],
        writes: Optional[List[WriteItem]] = None,
        sends: Optional[List[SendItem]] = None,
        scan_meta: Optional[ScanMeta] = None,
        n_rounds: int = 1,
        barrier_per_round: bool = False,
        leaders: Optional[LeaderAssignment] = None,
        synchronous: bool = False,
        stripe_disjoint: bool = False,
        meta: Optional[Dict[str, object]] = None,
        arrays: Optional[PlanArrays] = None,
    ) -> None:
        if writes is None and arrays is None:
            raise ValueError("FlushPlan requires writes items or arrays")
        self.strategy = strategy
        self.cluster = cluster
        self.rank_sizes = rank_sizes
        self.files = files
        self.scan_meta = scan_meta
        self.n_rounds = n_rounds
        self.barrier_per_round = barrier_per_round
        self.leaders = leaders
        self.synchronous = synchronous
        self.stripe_disjoint = stripe_disjoint
        self.meta: Dict[str, object] = {} if meta is None else meta
        self.arrays = arrays
        self._writes = writes
        self._sends = sends if sends is not None else ([] if arrays is None else None)

    # -- item views (lazy) -----------------------------------------------
    @property
    def writes(self) -> List[WriteItem]:
        if self._writes is None:
            self._writes = self.arrays.to_write_items()
        return self._writes

    @property
    def sends(self) -> List[SendItem]:
        if self._sends is None:
            self._sends = self.arrays.to_send_items()
        return self._sends

    def ensure_arrays(self) -> PlanArrays:
        """Columnar view, built from the item lists if necessary."""
        if self.arrays is None:
            self.arrays = PlanArrays.from_items(
                self._writes or [], self._sends or [], file_names=list(self.files)
            )
        return self.arrays

    # -- derived ---------------------------------------------------------
    @property
    def total_bytes(self) -> int:
        return sum(self.rank_sizes)

    @property
    def n_files(self) -> int:
        return len(self.files)

    def writes_by_backend(self) -> Dict[int, List[WriteItem]]:
        out: Dict[int, List[WriteItem]] = defaultdict(list)
        for w in self.writes:
            out[w.backend].append(w)
        return dict(out)

    def sends_by_edge(self) -> Dict[Tuple[int, int], int]:
        out: Dict[Tuple[int, int], int] = defaultdict(int)
        for s in self.sends:
            out[(s.src_backend, s.dst_backend)] += s.size
        return dict(out)

    def network_bytes(self) -> int:
        if self.arrays is not None:
            return int(self.arrays.sends.size.sum())
        return sum(s.size for s in self.sends)

    def metadata_ops(self) -> int:
        """File create (once per file) + open (once per (backend, file))."""
        if self.arrays is not None:
            w = self.arrays.writes
            n_files = max(1, len(self.arrays.file_names))
            opens = np.unique(w.backend * n_files + w.file_id)
            return len(self.files) + len(opens)
        opens = {(w.backend, w.file) for w in self.writes}
        return len(self.files) + len(opens)


class PlanError(AssertionError):
    pass


# ---------------------------------------------------------------------------
# Columnar validation
# ---------------------------------------------------------------------------


def _union_segments(
    group: np.ndarray, start: np.ndarray, end: np.ndarray, span: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Merged (touching) interval union per group, on encoded coordinates.

    Inputs must be sorted by (group, start); positions must be < span and
    ``group.max() * span`` must fit in int64 (the caller guards this).
    Returns encoded (seg_start, seg_end) arrays, globally sorted.
    """
    za = group * span + start
    zb = group * span + end
    run_end = np.maximum.accumulate(zb)
    new_seg = np.empty(len(za), bool)
    new_seg[0] = True
    new_seg[1:] = za[1:] > run_end[:-1]
    seg_starts = np.flatnonzero(new_seg)
    return za[seg_starts], np.maximum.reduceat(zb, seg_starts)


def validate_plan(plan: FlushPlan) -> None:
    """Structural invariants every strategy must satisfy (columnar).

    Same acceptance set as :func:`validate_plan_reference` (the original
    item-loop validator, kept as the executable spec), but expressed as
    sorted-array / difference assertions so that 10^5+-row plans validate
    in milliseconds.
    """
    cluster = plan.cluster
    n_ranks = cluster.world_size
    if len(plan.rank_sizes) != n_ranks:
        raise PlanError("rank_sizes length mismatch")
    if plan._writes is not None or plan._sends is not None:
        # An item view exists and may have been mutated: treat the items
        # as the source of truth rather than a possibly-stale cached
        # PlanArrays (columnar-built plans that never materialized items
        # keep the zero-copy fast path).  The properties materialize the
        # not-yet-touched view from the cached arrays, which are still
        # in sync for it.
        pa = PlanArrays.from_items(
            plan.writes, plan.sends, file_names=list(plan.files)
        )
        plan.arrays = pa
    else:
        pa = plan.ensure_arrays()
    w, s = pa.writes, pa.sends
    nw = len(w)
    rank_sizes = _i64(plan.rank_sizes)
    n_files = len(pa.file_names)

    # 0. Column sanity (the item dataclasses enforce this in __post_init__;
    #    columnar builders bypass them, so assert here).
    if nw:
        if int(w.size.min()) <= 0:
            raise PlanError("write size must be positive")
        if int(w.file_offset.min()) < 0 or int(w.src_offset.min()) < 0:
            raise PlanError("write offsets must be non-negative")
        lo, hi = int(w.src_rank.min()), int(w.src_rank.max())
        if lo < 0 or hi >= n_ranks:
            raise PlanError(f"write references bad rank {lo if lo < 0 else hi}")
        if int(w.file_id.min()) < 0 or int(w.file_id.max()) >= n_files:
            raise PlanError("write references file id outside the file table")
    for f in np.unique(w.file_id).tolist():
        if pa.file_names[f] not in plan.files:
            raise PlanError(f"write targets undeclared file {pa.file_names[f]}")

    # 1. Source coverage: for each rank, the union of write src slices is
    #    exactly [0, size) with no overlap.  Sorted by (rank, src_offset),
    #    slices must chain: group starts at 0, each next offset equals the
    #    previous end, and total covered bytes equal the rank size.
    covered = np.zeros(n_ranks, np.int64)
    if nw:
        np.add.at(covered, w.src_rank, w.size)
        order = np.lexsort((w.src_offset, w.src_rank))
        r = w.src_rank[order]
        a = w.src_offset[order]
        b = a + w.size[order]
        first = np.empty(nw, bool)
        first[0] = True
        first[1:] = r[1:] != r[:-1]
        nonzero_start = a[first] != 0
        if nonzero_start.any():
            bad = int(r[first][np.flatnonzero(nonzero_start)[0]])
            raise PlanError(f"rank {bad}: src gap/overlap at 0")
        chain = ~first[1:]
        bad_chain = chain & (a[1:] != b[:-1])
        if bad_chain.any():
            i = int(np.flatnonzero(bad_chain)[0])
            raise PlanError(
                f"rank {int(r[i + 1])}: src gap/overlap at {int(b[i])} "
                f"(next slice {int(a[i + 1])})"
            )
    empties = (rank_sizes == 0) & (covered > 0)
    if empties.any():
        raise PlanError(f"rank {int(np.flatnonzero(empties)[0])} is empty but has writes")
    short = covered != rank_sizes
    if short.any():
        bad = int(np.flatnonzero(short)[0])
        raise PlanError(
            f"rank {bad}: covered {int(covered[bad])} of {int(rank_sizes[bad])} bytes"
        )

    # 2. Destination disjointness within each file: sorted by
    #    (file, file_offset), neighbours must not overlap and every write
    #    must end within the declared file size.
    if nw:
        order2 = np.lexsort((w.file_offset, w.file_id))
        f2 = w.file_id[order2]
        fo = w.file_offset[order2]
        fe = fo + w.size[order2]
        same_file = f2[1:] == f2[:-1]
        if (same_file & (fo[1:] < fe[:-1])).any():
            i = int(np.flatnonzero(same_file & (fo[1:] < fe[:-1]))[0])
            raise PlanError(f"file {pa.file_names[int(f2[i])]}: overlapping writes")
        fsizes = _i64([plan.files.get(nm, 0) for nm in pa.file_names])
        over = fe > fsizes[f2]
        if over.any():
            i = int(np.flatnonzero(over)[0])
            raise PlanError(f"file {pa.file_names[int(f2[i])]}: write past declared size")

    # 3. Every write executed by a backend that doesn't hold the source
    #    rank must be fed by sends covering exactly those bytes.
    home_w = cluster.nodes_of_ranks(w.src_rank)
    if len(s):
        if int(s.size.min()) <= 0:
            raise PlanError("send size must be positive")
        if int(s.src_offset.min()) < 0:
            raise PlanError("send offsets must be non-negative")
        if int(s.src_rank.min()) < 0 or int(s.src_rank.max()) >= n_ranks:
            raise PlanError("send references bad rank")
        if (s.src_backend != cluster.nodes_of_ranks(s.src_rank)).any():
            raise PlanError("send must originate at the rank's home backend")
    need = home_w != w.backend
    if need.any():
        _check_send_coverage(plan, pa, need, n_ranks)

    # 4. Stripe disjointness when claimed: with per-file disjointness
    #    already established, a stripe has two writers iff some pair of
    #    offset-adjacent writes in the same file straddles/shares a stripe
    #    with different backends.
    if plan.stripe_disjoint and nw:
        stripe = cluster.pfs.stripe_size
        b2 = w.backend[order2]
        sz2 = w.size[order2]
        last_stripe = (fo + sz2 - 1) // stripe
        first_stripe = fo // stripe
        conflict = same_file & (b2[1:] != b2[:-1]) & (first_stripe[1:] == last_stripe[:-1])
        if conflict.any():
            i = int(np.flatnonzero(conflict)[0])
            raise PlanError(
                f"stripe ({pa.file_names[int(f2[i])]},{int(last_stripe[i])}) "
                f"written by backends {int(b2[i])} and {int(b2[i + 1])} "
                f"despite stripe_disjoint"
            )


def _check_send_coverage(
    plan: FlushPlan, pa: PlanArrays, need: np.ndarray, n_ranks: int
) -> None:
    w, s = pa.writes, pa.sends
    nk = w.backend[need] * n_ranks + w.src_rank[need]
    na = w.src_offset[need]
    nb = na + w.size[need]
    if not len(s):
        key = int(nk[0])
        raise PlanError(
            f"backend {key // n_ranks} writes rank {key % n_ranks} bytes "
            f"[{int(na[0])},{int(nb[0])}) without a covering send"
        )
    gk = s.dst_backend * n_ranks + s.src_rank
    ga = s.src_offset
    gb = ga + s.size
    # Compact (backend, rank) keys to group ids so the encoded coordinate
    # group * span + position fits in int64.
    uk, inv = np.unique(np.concatenate((gk, nk)), return_inverse=True)
    g_got, g_need = inv[: len(gk)], inv[len(gk):]
    span = int(max(int(gb.max()), int(nb.max()))) + 1
    if len(uk) * span >= (1 << 62):  # pragma: no cover - astronomically large
        _send_coverage_reference(plan)
        return
    order = np.lexsort((ga, g_got))
    seg_a, seg_b = _union_segments(g_got[order], ga[order], gb[order], span)
    zq_a = g_need * span + na
    zq_b = g_need * span + nb
    pos = np.searchsorted(seg_a, zq_a, side="right") - 1
    cpos = np.maximum(pos, 0)
    ok = (pos >= 0) & (seg_a[cpos] // span == g_need) & (zq_b <= seg_b[cpos])
    if not ok.all():
        i = int(np.flatnonzero(~ok)[0])
        key = int(uk[g_need[i]])
        raise PlanError(
            f"backend {key // n_ranks} writes rank {key % n_ranks} bytes "
            f"[{int(na[i])},{int(nb[i])}) without a covering send"
        )


def _send_coverage_reference(plan: FlushPlan) -> None:
    """Item-loop send-coverage check (fallback + executable spec)."""
    cluster = plan.cluster
    needed: Dict[Tuple[int, int], List[Tuple[int, int]]] = defaultdict(list)
    for w in plan.writes:
        home = cluster.node_of_rank(w.src_rank)
        if home != w.backend:
            needed[(w.backend, w.src_rank)].append(
                (w.src_offset, w.src_offset + w.size)
            )
    got: Dict[Tuple[int, int], List[Tuple[int, int]]] = defaultdict(list)
    for s in plan.sends:
        home = cluster.node_of_rank(s.src_rank)
        if s.src_backend != home:
            raise PlanError("send must originate at the rank's home backend")
        got[(s.dst_backend, s.src_rank)].append(
            (s.src_offset, s.src_offset + s.size)
        )

    def _union(ivs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        for a, b in sorted(ivs):
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    for key, ivs in needed.items():
        have = _union(got.get(key, []))
        for a, b in _union(ivs):
            if not any(ha <= a and b <= hb for ha, hb in have):
                raise PlanError(
                    f"backend {key[0]} writes rank {key[1]} bytes "
                    f"[{a},{b}) without a covering send"
                )


def validate_plan_reference(plan: FlushPlan) -> None:
    """The original item-loop validator — the spec the columnar
    :func:`validate_plan` is tested against (see tests/test_plan_arrays.py)."""
    cluster = plan.cluster
    n_ranks = cluster.world_size
    if len(plan.rank_sizes) != n_ranks:
        raise PlanError("rank_sizes length mismatch")

    # 1. Source coverage: for each rank, the union of write src slices is
    #    exactly [0, size) with no overlap.
    per_rank: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for w in plan.writes:
        if not (0 <= w.src_rank < n_ranks):
            raise PlanError(f"write references bad rank {w.src_rank}")
        per_rank[w.src_rank].append((w.src_offset, w.src_offset + w.size))
    for rank in range(n_ranks):
        size = plan.rank_sizes[rank]
        ivs = sorted(per_rank.get(rank, []))
        if size == 0:
            if ivs:
                raise PlanError(f"rank {rank} is empty but has writes")
            continue
        pos = 0
        for a, b in ivs:
            if a != pos:
                raise PlanError(
                    f"rank {rank}: src gap/overlap at {pos} (next slice {a})"
                )
            pos = b
        if pos != size:
            raise PlanError(f"rank {rank}: covered {pos} of {size} bytes")

    # 2. Destination disjointness within each file.
    per_file: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    for w in plan.writes:
        if w.file not in plan.files:
            raise PlanError(f"write targets undeclared file {w.file}")
        per_file[w.file].append((w.file_offset, w.file_offset + w.size))
    for fname, ivs in per_file.items():
        ivs.sort()
        for (a0, b0), (a1, b1) in zip(ivs, ivs[1:]):
            if a1 < b0:
                raise PlanError(f"file {fname}: overlapping writes")
        if ivs and ivs[-1][1] > plan.files[fname]:
            raise PlanError(f"file {fname}: write past declared size")

    # 3. Send coverage for non-local writes.
    _send_coverage_reference(plan)

    # 4. Stripe disjointness when claimed.
    if plan.stripe_disjoint:
        stripe = cluster.pfs.stripe_size
        owner: Dict[Tuple[str, int], int] = {}
        for w in plan.writes:
            s0 = w.file_offset // stripe
            s1 = (w.file_offset + w.size - 1) // stripe
            for st in range(s0, s1 + 1):
                prev = owner.setdefault((w.file, st), w.backend)
                if prev != w.backend:
                    raise PlanError(
                        f"stripe ({w.file},{st}) written by backends "
                        f"{prev} and {w.backend} despite stripe_disjoint"
                    )


# ---------------------------------------------------------------------------
# Read side: FileLayout (the inverse of a flush) + columnar ReadPlan
# ---------------------------------------------------------------------------


def stored_space_offsets(stored_sizes: Sequence[int]) -> np.ndarray:
    """Exclusive prefix sum of per-rank stored sizes: rank -> global
    stored-space offset of that rank's blob (len = n_ranks + 1; the last
    entry is the total stored bytes)."""
    sizes = _i64(stored_sizes)
    out = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(sizes, out=out[1:])
    return out


@dataclass
class FileLayout:
    """Extent table: where every stored-space byte lives on the PFS.

    The inverse view of a flush — each row maps a contiguous stored-space
    interval onto a contiguous file extent.  Columns (parallel int64,
    sorted by ``start`` after construction):

    * ``start``       — global stored-space offset of the extent
    * ``size``        — extent length (> 0)
    * ``file_id``     — index into ``file_names``
    * ``file_offset`` — byte offset inside that file

    Invariant: the extents tile ``[0, total)`` exactly — sorted by
    ``start``, each extent begins where the previous ends.  This is the
    read-side restatement of the flush validator's *source coverage*
    rule, and ``__post_init__`` enforces it, so any FlushPlan that
    passed :func:`validate_plan` inverts to a valid layout.
    """

    file_names: List[str]
    files: Dict[str, int]
    start: np.ndarray
    size: np.ndarray
    file_id: np.ndarray
    file_offset: np.ndarray
    total: int

    def __post_init__(self):
        self.start = _i64(self.start)
        self.size = _i64(self.size)
        self.file_id = _i64(self.file_id)
        self.file_offset = _i64(self.file_offset)
        self.total = int(self.total)
        n = len(self.start)
        if len({n, len(self.size), len(self.file_id), len(self.file_offset)}) != 1:
            raise PlanError("FileLayout columns must have identical length")
        if n == 0:
            if self.total != 0:
                raise PlanError("empty layout must cover 0 bytes")
            return
        order = np.argsort(self.start, kind="stable")
        for c in ("start", "size", "file_id", "file_offset"):
            setattr(self, c, getattr(self, c)[order])
        if int(self.size.min()) <= 0:
            raise PlanError("layout extent sizes must be positive")
        if int(self.start[0]) != 0:
            raise PlanError("layout does not start at stored offset 0")
        ends = self.start + self.size
        if (self.start[1:] != ends[:-1]).any():
            i = int(np.flatnonzero(self.start[1:] != ends[:-1])[0])
            raise PlanError(
                f"layout gap/overlap at stored offset {int(ends[i])} "
                f"(next extent {int(self.start[i + 1])})"
            )
        if int(ends[-1]) != self.total:
            raise PlanError(
                f"layout covers {int(ends[-1])} of {self.total} stored bytes"
            )

    def __len__(self) -> int:
        return len(self.start)

    @staticmethod
    def from_flush_plan(plan: FlushPlan) -> "FileLayout":
        """Invert a flush: writes become extents keyed by stored offset.

        Works for every strategy — the write columns already carry
        ``(src_rank, src_offset)``; adding the rank's stored-space base
        offset turns them into global stored coordinates.
        """
        pa = plan.ensure_arrays()
        w = pa.writes
        offsets = stored_space_offsets(plan.rank_sizes)
        return FileLayout(
            file_names=list(pa.file_names),
            files=dict(plan.files),
            start=offsets[w.src_rank] + w.src_offset,
            size=w.size.copy(),
            file_id=w.file_id.copy(),
            file_offset=w.file_offset.copy(),
            total=int(offsets[-1]),
        )

    @staticmethod
    def from_placement(
        placement,
        stored_sizes: Sequence[int],
        files: Dict[str, int],
    ) -> "FileLayout":
        """Build from a manifest placement (the persisted form of a
        flush's write set): either the columnar
        :class:`~repro_torch.core.serialize.Placement` (one gather, no loop)
        or the legacy rank -> [(file, file_offset, src_offset, size)]
        dict of tuples."""
        offsets = stored_space_offsets(stored_sizes)
        if hasattr(placement, "rank"):  # columnar Placement
            return FileLayout(
                file_names=list(placement.file_names),
                files=dict(files),
                start=offsets[placement.rank] + placement.src_offset,
                size=placement.size.copy(),
                file_id=placement.file_id.copy(),
                file_offset=placement.file_offset.copy(),
                total=int(offsets[-1]),
            )
        names: List[str] = []
        fid: Dict[str, int] = {}
        start: List[int] = []
        size: List[int] = []
        file_id: List[int] = []
        file_offset: List[int] = []
        for rank, entries in placement.items():
            base = int(offsets[rank])
            for fname, foff, soff, n in entries:
                j = fid.get(fname)
                if j is None:
                    j = fid[fname] = len(names)
                    names.append(fname)
                start.append(base + soff)
                size.append(n)
                file_id.append(j)
                file_offset.append(foff)
        return FileLayout(
            file_names=names,
            files=dict(files),
            start=start,
            size=size,
            file_id=file_id,
            file_offset=file_offset,
            total=int(offsets[-1]),
        )


_R_COLS = ("reader", "file_id", "file_offset", "size", "dst_req", "dst_offset")


@dataclass
class ReadColumns:
    """Parallel int64 columns, one row per ranged read (see module doc)."""

    reader: np.ndarray
    file_id: np.ndarray
    file_offset: np.ndarray
    size: np.ndarray
    dst_req: np.ndarray
    dst_offset: np.ndarray

    def __post_init__(self):
        for name in _R_COLS:
            setattr(self, name, _i64(getattr(self, name)))
        if len({getattr(self, c).shape for c in _R_COLS}) != 1:
            raise ValueError("ReadColumns columns must have identical length")

    def __len__(self) -> int:
        return len(self.reader)

    @staticmethod
    def empty() -> "ReadColumns":
        z = np.empty(0, np.int64)
        return ReadColumns(z, z, z, z, z, z)

    def take(self, idx: np.ndarray) -> "ReadColumns":
        return ReadColumns(*(getattr(self, c)[idx] for c in _R_COLS))


def coalesce_read_columns(r: ReadColumns) -> ReadColumns:
    """Merge runs contiguous in both file and destination coordinates.

    The read twin of :func:`coalesce_write_columns`: one ``np.lexsort``
    plus a boundary-difference pass.  Two sorted rows merge when they
    serve the same (reader, request, file) and both the file offset and
    the destination offset chain."""
    if len(r) <= 1:
        return r
    order = np.lexsort((r.dst_offset, r.file_id, r.dst_req, r.reader))
    b = r.take(order)
    same = (
        (b.reader[1:] == b.reader[:-1])
        & (b.dst_req[1:] == b.dst_req[:-1])
        & (b.file_id[1:] == b.file_id[:-1])
        & (b.dst_offset[1:] == b.dst_offset[:-1] + b.size[:-1])
        & (b.file_offset[1:] == b.file_offset[:-1] + b.size[:-1])
    )
    starts = np.flatnonzero(np.concatenate(([True], ~same)))
    return ReadColumns(
        reader=b.reader[starts],
        file_id=b.file_id[starts],
        file_offset=b.file_offset[starts],
        size=np.add.reduceat(b.size, starts),
        dst_req=b.dst_req[starts],
        dst_offset=b.dst_offset[starts],
    )


@dataclass
class ReadPlan:
    """One restore/reshard, columnar: ranged reads + the request table.

    ``req_start``/``req_size``/``req_reader`` describe the consumer's
    byte-range requests against stored space (one destination buffer per
    request); ``reads`` lists the ranged ``pread``s that fill them.
    """

    file_names: List[str]
    files: Dict[str, int]
    reads: ReadColumns
    req_start: np.ndarray
    req_size: np.ndarray
    req_reader: np.ndarray
    meta: Dict[str, object]

    def __post_init__(self):
        self.req_start = _i64(self.req_start)
        self.req_size = _i64(self.req_size)
        self.req_reader = _i64(self.req_reader)

    @property
    def n_reads(self) -> int:
        return len(self.reads)

    @property
    def n_requests(self) -> int:
        return len(self.req_start)

    @property
    def total_bytes(self) -> int:
        return int(self.req_size.sum())

    def reads_per_reader(self) -> Dict[int, int]:
        u, c = np.unique(self.reads.reader, return_counts=True)
        return dict(zip(u.tolist(), c.tolist()))


def merge_intervals(
    start: Sequence[int], size: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Union of half-open intervals ``[start_i, start_i + size_i)``.

    Returns sorted, disjoint, merged ``(starts, sizes)``; zero-size
    inputs are dropped.  Pure array program (sort + running-max
    boundary pass).  The chunk-granular restore path uses this to turn
    the stored-space extents of the needed chunks into a minimal set of
    :func:`build_read_plan` requests — adjacent chunks of one rank
    coalesce into a single ranged request before the planner ever sees
    them.
    """
    a = _i64(start)
    s = _i64(size)
    if len(a) != len(s):
        raise PlanError("merge_intervals: start and size length mismatch")
    keep = s > 0
    a, s = a[keep], s[keep]
    if not len(a):
        z = np.empty(0, np.int64)
        return z, z
    order = np.argsort(a, kind="stable")
    a, b = a[order], (a + s)[order]
    run_end = np.maximum.accumulate(b)
    new_seg = np.empty(len(a), bool)
    new_seg[0] = True
    new_seg[1:] = a[1:] > run_end[:-1]
    starts = a[new_seg]
    ends = np.maximum.reduceat(b, np.flatnonzero(new_seg))
    return starts, ends - starts


def assign_readers(
    stored_sizes: Sequence[int],
    n_readers: int,
    *,
    weights: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Balanced contiguous assignment of producer ranks to consumer nodes.

    Rank r goes to the reader whose byte share contains the midpoint of
    r's blob, so each of the ``n_readers`` consumers pulls ~equal bytes
    even when blob sizes are skewed.  Pure array program.

    ``weights`` (optional, one per reader, positive) skews the byte
    shares: a reader with weight 0.5 receives half the bytes of a
    weight-1.0 peer.  The health registry's straggler demotion feeds
    observed per-reader latency ratios through here so a slow node
    serves fewer extents instead of gating the whole restore.  With
    ``weights=None`` (or all-equal weights) the assignment is exactly
    the unweighted midpoint rule above — byte-identical plans."""
    sizes = _i64(stored_sizes)
    n_readers = max(1, int(n_readers))
    offsets = stored_space_offsets(sizes)
    total = int(offsets[-1])
    if total == 0:
        return np.zeros(len(sizes), np.int64)
    mid = offsets[:-1] + sizes // 2
    if weights is not None:
        w = np.asarray(weights, np.float64)
        if len(w) != n_readers:
            raise PlanError("assign_readers: one weight per reader required")
        if (w <= 0).any():
            raise PlanError("assign_readers: weights must be positive")
        if not np.allclose(w, w[0]):
            # reader k covers stored space (cum[k-1], cum[k]] of the
            # weight-proportional partition of [0, total]
            bounds = np.cumsum(w) * (total / float(w.sum()))
            return np.minimum(
                np.searchsorted(bounds, mid, side="right"), n_readers - 1
            ).astype(np.int64)
    return np.minimum(mid * n_readers // total, n_readers - 1)


def _cut_at_extents(
    layout: FileLayout, a: np.ndarray, b: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Subdivide stored-space intervals ``[a_i, b_i)`` at layout extent
    boundaries (two ``np.searchsorted`` calls + the repeat/arange trick).

    Returns ``(idx, eidx, p_start, p_end)`` per piece: source-interval
    index, extent index, piece bounds.  Zero-length intervals produce no
    pieces.  Callers guarantee intervals lie within ``[0, layout.total]``
    — this is the single subdivision used by both the builder and the
    validator, so they can never disagree about where extents cut.
    """
    nz = b > a
    first = np.searchsorted(layout.start, a, side="right") - 1
    last = np.searchsorted(layout.start, b - 1, side="right") - 1
    n_pieces = np.where(nz, last - first + 1, 0)
    total = int(n_pieces.sum())
    idx = np.repeat(np.arange(len(a), dtype=np.int64), n_pieces)
    base = np.cumsum(n_pieces) - n_pieces
    within = np.arange(total, dtype=np.int64) - np.repeat(base, n_pieces)
    eidx = first[idx] + within
    p_start = np.maximum(a[idx], layout.start[eidx])
    p_end = np.minimum(b[idx], layout.start[eidx] + layout.size[eidx])
    return idx, eidx, p_start, p_end


def build_read_plan(
    layout: FileLayout,
    req_start: Sequence[int],
    req_size: Sequence[int],
    req_reader: Optional[Sequence[int]] = None,
    *,
    coalesce: bool = True,
    validate: bool = True,
) -> ReadPlan:
    """Map consumer byte-range requests onto aggregated-file extents.

    The read-side twin of the columnar strategy builders: requests are
    cut at layout-extent boundaries with two ``np.searchsorted`` calls
    plus the repeat/arange subdivision trick — no per-request Python
    loop — so planning a paper-scale restore (10^5 requests against 10^5
    extents) is an array program.

    Requests may target any subset of stored space, in any order, with
    any consumer geometry (this is what makes N-rank save -> M-rank
    restore and partial per-leaf restore the same operation); zero-size
    requests are legal and produce no reads.
    """
    qa = _i64(req_start)
    qs = _i64(req_size)
    n_req = len(qa)
    if len(qs) != n_req:
        raise PlanError("req_start and req_size must have identical length")
    readers = (
        np.zeros(n_req, np.int64) if req_reader is None else _i64(req_reader)
    )
    if len(readers) != n_req:
        raise PlanError("req_reader must have one entry per request")
    if n_req:
        if int(qs.min()) < 0:
            raise PlanError("request sizes must be non-negative")
        if int(qa.min()) < 0 or int((qa + qs).max()) > layout.total:
            raise PlanError("request outside stored space")
    qb = qa + qs
    if not len(layout) or not (qs > 0).any():
        reads = ReadColumns.empty()
    else:
        ridx, eidx, p_start, p_end = _cut_at_extents(layout, qa, qb)
        reads = ReadColumns(
            reader=readers[ridx],
            file_id=layout.file_id[eidx],
            file_offset=layout.file_offset[eidx] + (p_start - layout.start[eidx]),
            size=p_end - p_start,
            dst_req=ridx,
            dst_offset=p_start - qa[ridx],
        )
        if coalesce:
            reads = coalesce_read_columns(reads)
    rp = ReadPlan(
        file_names=list(layout.file_names),
        files=dict(layout.files),
        reads=reads,
        req_start=qa,
        req_size=qs,
        req_reader=readers,
        meta={"n_extents": len(layout), "stored_total": layout.total},
    )
    if validate:
        validate_read_plan(rp, layout)
    return rp


def validate_read_plan(rp: ReadPlan, layout: Optional[FileLayout] = None) -> None:
    """Structural invariants of a read plan (columnar throughout).

    Checks the three rules from the module doc: per-request destination
    coverage (tile ``[0, req_size)`` exactly), in-bounds file reads, and
    — when ``layout`` is given — that every read's file extent is where
    the layout places the request's stored bytes."""
    r = rp.reads
    nr = len(r)
    n_req = rp.n_requests
    n_files = len(rp.file_names)

    if nr:
        if int(r.size.min()) <= 0:
            raise PlanError("read size must be positive")
        if int(r.file_offset.min()) < 0 or int(r.dst_offset.min()) < 0:
            raise PlanError("read offsets must be non-negative")
        if int(r.dst_req.min()) < 0 or int(r.dst_req.max()) >= n_req:
            raise PlanError("read references request outside the request table")
        if int(r.file_id.min()) < 0 or int(r.file_id.max()) >= n_files:
            raise PlanError("read references file id outside the file table")

    # 1. Destination coverage: per request, dst slices tile [0, req_size).
    covered = np.zeros(n_req, np.int64)
    if nr:
        np.add.at(covered, r.dst_req, r.size)
        order = np.lexsort((r.dst_offset, r.dst_req))
        q = r.dst_req[order]
        a = r.dst_offset[order]
        b = a + r.size[order]
        firstrow = np.empty(nr, bool)
        firstrow[0] = True
        firstrow[1:] = q[1:] != q[:-1]
        if (a[firstrow] != 0).any():
            bad = int(q[firstrow][np.flatnonzero(a[firstrow] != 0)[0]])
            raise PlanError(f"request {bad}: dst gap/overlap at 0")
        chain = ~firstrow[1:]
        bad_chain = chain & (a[1:] != b[:-1])
        if bad_chain.any():
            i = int(np.flatnonzero(bad_chain)[0])
            raise PlanError(
                f"request {int(q[i + 1])}: dst gap/overlap at {int(b[i])} "
                f"(next piece {int(a[i + 1])})"
            )
    short = covered != rp.req_size
    if short.any():
        bad = int(np.flatnonzero(short)[0])
        raise PlanError(
            f"request {bad}: reads cover {int(covered[bad])} of "
            f"{int(rp.req_size[bad])} bytes"
        )

    # 2. In-bounds file reads.
    if nr:
        fsizes = _i64([rp.files.get(nm, 0) for nm in rp.file_names])
        over = r.file_offset + r.size > fsizes[r.file_id]
        if over.any():
            i = int(np.flatnonzero(over)[0])
            raise PlanError(
                f"file {rp.file_names[int(r.file_id[i])]}: read past declared size"
            )

    # 3. Layout consistency: the stored position each read claims to fill
    #    must resolve (through the layout) to exactly the file extent the
    #    read targets.  Coalesced reads may legally span several extents
    #    that happen to be contiguous in the same file, so each read is
    #    first subdivided at extent boundaries (the builder's own
    #    :func:`_cut_at_extents`), then every piece is checked.
    if layout is not None and nr and len(layout):
        pos = rp.req_start[r.dst_req] + r.dst_offset
        end = pos + r.size
        if int(pos.min()) < 0 or int(end.max()) > layout.total:
            i = int(np.flatnonzero((pos < 0) | (end > layout.total))[0])
            raise PlanError(
                f"read {i} outside stored space at offset {int(pos[i])}"
            )
        ridx, eidx, p_start, _ = _cut_at_extents(layout, pos, end)
        ok = (layout.file_id[eidx] == r.file_id[ridx]) & (
            layout.file_offset[eidx] + (p_start - layout.start[eidx])
            == r.file_offset[ridx] + (p_start - pos[ridx])
        )
        if not ok.all():
            i = int(ridx[np.flatnonzero(~ok)[0]])
            raise PlanError(
                f"read {i} disagrees with the layout about stored offset "
                f"{int(pos[i])}"
            )


def count_false_sharing(plan: FlushPlan) -> Dict[str, int]:
    """Diagnostics: stripes touched by >1 backend (the paper's §2.1 issue)."""
    stripe = plan.cluster.pfs.stripe_size
    writers: Dict[Tuple[str, int], set] = defaultdict(set)
    for w in plan.writes:
        s0 = w.file_offset // stripe
        s1 = (w.file_offset + w.size - 1) // stripe
        for st in range(s0, s1 + 1):
            writers[(w.file, st)].add(w.backend)
    shared = {k: v for k, v in writers.items() if len(v) > 1}
    return {
        "stripes_total": len(writers),
        "stripes_shared": len(shared),
        "max_writers_per_stripe": max((len(v) for v in writers.values()), default=0),
        "excess_writers": sum(len(v) - 1 for v in shared.values()),
    }
