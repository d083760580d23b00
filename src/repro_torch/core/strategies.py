"""Aggregation strategies for the asynchronous flush phase.

Implemented strategies (paper section in brackets):

* ``file_per_process``  — VELOC default baseline: N ranks -> N files, zero
  coordination [§1].
* ``posix``             — prefix-sum offsets into one shared file, each
  active backend pwrite()s its co-located ranks' data [§2.1].  Suffers
  false sharing on PFS stripes.
* ``mpiio``             — GenericIO-style two-phase collective: I/O
  leaders matched to the number of I/O servers, disjoint stripe sets,
  one *barrier-synchronized collective round per node-local checkpoint*
  (the paper's multi-phase workaround for MPI-IO's single-contiguous-
  buffer restriction) [§2.2].
* ``stripe_aligned``    — the paper's §3 proposal, fully implemented:
  piggy-backed prefix-sum -> deterministic election of M leaders ->
  static stripe-aligned region ownership -> non-leaders stream their
  bytes to the owning leader(s); no barriers, no collectives.
* ``gio_sync``          — synchronous GenericIO-like baseline (blocks the
  application; used for the Fig. 1/2 comparison).

Every strategy returns a validated :class:`~repro_torch.core.plan.FlushPlan`.

All builders are *columnar*: they emit :class:`~repro_torch.core.plan.PlanArrays`
int64 columns via vectorized interval splitting (``np.searchsorted`` over
merged stripe/region/chunk boundary arrays) instead of per-chunk Python
loops, so plan construction at 100k+ ranks is an array program.  The
original item-loop builders are preserved verbatim in
:mod:`repro_torch.core.strategies_ref` and the equivalence test suite
(tests/test_plan_arrays.py) asserts byte-identical write/send sets.

The column-by-column meaning of the emitted ``WriteColumns`` /
``SendColumns`` (``backend``, ``file_id``, ``file_offset``, ``size``,
``src_rank``, ``src_offset``, ``round`` / ``src_backend``,
``dst_backend``, …) and the invariants :func:`~repro_torch.core.plan.
validate_plan` holds every builder to — source coverage, destination
disjointness, send coverage, stripe disjointness — are documented in the
:mod:`repro_torch.core.plan` module docstring, which is the validator's source
of truth.  Because every builder satisfies *source coverage* (each
rank's stored bytes written exactly once), any plan built here inverts
losslessly into the read-side extent table
(:meth:`~repro_torch.core.plan.FileLayout.from_flush_plan`): strategies only
ever decide the *write* layout, and restore planning works uniformly on
the inverse, whatever strategy wrote the checkpoint.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.plan import (
    FlushPlan,
    PlanArrays,
    SendColumns,
    WriteColumns,
    coalesce_send_columns,
    coalesce_write_columns,
    validate_plan,
)
from repro_torch.core.prefix_sum import (
    elect_leaders,
    exclusive_prefix_sum_np,
    piggybacked_scan,
)

AGGREGATE_FILE = "aggregate.dat"


def _rank_file(rank: int) -> str:
    return f"rank_{rank:06d}.dat"


def _split_at_multiples(
    starts: np.ndarray, sizes: np.ndarray, step: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split intervals [starts, starts+sizes) at absolute multiples of step.

    Returns (interval_index, piece_start, piece_size); pieces are emitted
    in interval order, ascending within each interval — the same order a
    per-interval ``while`` loop would produce.
    """
    starts = starts.astype(np.int64)
    sizes = sizes.astype(np.int64)
    ends = starts + sizes
    n_pieces = (ends - 1) // step - starts // step + 1
    n_pieces = np.where(sizes > 0, n_pieces, 0)
    total = int(n_pieces.sum())
    idx = np.repeat(np.arange(len(starts), dtype=np.int64), n_pieces)
    first = np.cumsum(n_pieces) - n_pieces
    within = np.arange(total, dtype=np.int64) - np.repeat(first, n_pieces)
    bases = starts[idx] // step
    p_start = np.where(within == 0, starts[idx], (bases + within) * step)
    p_end = np.minimum(ends[idx], (bases + within + 1) * step)
    return idx, p_start, p_end - p_start


# ---------------------------------------------------------------------------
# Baseline: one file per process (VELOC default)
# ---------------------------------------------------------------------------


def plan_file_per_process(
    cluster: ClusterSpec, rank_sizes: Sequence[int], **_: object
) -> FlushPlan:
    sizes = np.asarray(rank_sizes, dtype=np.int64)
    nz = np.flatnonzero(sizes > 0)
    file_names = [_rank_file(int(r)) for r in nz]
    zeros = np.zeros(len(nz), np.int64)
    writes = WriteColumns(
        backend=cluster.nodes_of_ranks(nz),
        file_id=np.arange(len(nz), dtype=np.int64),
        file_offset=zeros,
        size=sizes[nz],
        src_rank=nz,
        src_offset=zeros,
        round=zeros,
    )
    files = {nm: int(sz) for nm, sz in zip(file_names, sizes[nz].tolist())}
    plan = FlushPlan(
        strategy="file_per_process",
        cluster=cluster,
        rank_sizes=[int(s) for s in rank_sizes],
        files=files,
        arrays=PlanArrays(file_names, writes, SendColumns.empty()),
        scan_meta=None,  # embarrassingly parallel: no coordination at all
        stripe_disjoint=True,  # distinct files => distinct OST objects
    )
    validate_plan(plan)
    return plan


# ---------------------------------------------------------------------------
# §2.1 POSIX-based aggregation
# ---------------------------------------------------------------------------


def plan_posix(
    cluster: ClusterSpec,
    rank_sizes: Sequence[int],
    *,
    write_chunk: Optional[int] = None,
    **_: object,
) -> FlushPlan:
    """Shared file, prefix-sum offsets, independent pwrites per backend.

    Writes are issued in ``write_chunk``-sized pieces (default: one write
    per rank blob) — the chunking matters to the simulator's request-size
    efficiency model and to straggler-mitigating work stealing, not to
    correctness.  No attempt is made to align to stripes: that is
    precisely the false-sharing bug this strategy exhibits.
    """
    offsets, total = exclusive_prefix_sum_np(rank_sizes)
    scan = piggybacked_scan(cluster, rank_sizes, payload_extra_bytes=0)
    sizes = np.asarray(rank_sizes, dtype=np.int64)
    nz = np.flatnonzero(sizes > 0)
    if write_chunk:
        step = max(1, int(write_chunk))
        # Chunk boundaries are relative to each blob start: split [0, size)
        # at multiples of step.
        idx, pos, psize = _split_at_multiples(
            np.zeros(len(nz), np.int64), sizes[nz], step
        )
        ranks = nz[idx]
    else:
        ranks = nz
        pos = np.zeros(len(nz), np.int64)
        psize = sizes[nz]
    writes = WriteColumns(
        backend=cluster.nodes_of_ranks(ranks),
        file_id=np.zeros(len(ranks), np.int64),
        file_offset=offsets[ranks] + pos,
        size=psize,
        src_rank=ranks,
        src_offset=pos,
        round=np.zeros(len(ranks), np.int64),
    )
    plan = FlushPlan(
        strategy="posix",
        cluster=cluster,
        rank_sizes=[int(s) for s in rank_sizes],
        files={AGGREGATE_FILE: total},
        arrays=PlanArrays([AGGREGATE_FILE], writes, SendColumns.empty()),
        scan_meta=scan.meta,
        stripe_disjoint=False,  # the whole point of §2.1's finding
    )
    validate_plan(plan)
    return plan


# ---------------------------------------------------------------------------
# §2.2 MPI-IO collective aggregation (two-phase I/O, multi-round)
# ---------------------------------------------------------------------------


def plan_mpiio(
    cluster: ClusterSpec,
    rank_sizes: Sequence[int],
    *,
    n_leaders: Optional[int] = None,
    chunk_stripes: int = 1,
    **_: object,
) -> FlushPlan:
    """Two-phase collective write with I/O leaders.

    Faithful to the paper's description of running GenericIO-style
    aggregation from the active backends:

    * leaders = min(#I/O servers, #backends) — observation (1);
    * each leader owns a disjoint, stripe-aligned *interleaved* stripe set
      (leader j owns stripes ``{s : s % M == j}``) — observation (2),
      eliminating false sharing;
    * MPI-IO accepts one contiguous region per rank per collective call,
      and each backend holds ``procs_per_node`` node-local checkpoints, so
      the flush needs ``procs_per_node`` successive barrier-synchronized
      collective rounds — the paper's multi-phase workaround.  Round k
      collectively writes every node's k-th local checkpoint.

    ``chunk_stripes`` coarsens the exchange granularity to ``chunk_stripes``
    PFS stripes per unit (ADIO ``cb_buffer_size`` analogue); 1 = exact
    stripe-granular two-phase I/O.  Benchmarks at Theta scale use larger
    values to keep plan sizes tractable; correctness is unaffected (the
    plan validator enforces coverage either way).
    """
    offsets, total = exclusive_prefix_sum_np(rank_sizes)
    scan = piggybacked_scan(cluster, rank_sizes, payload_extra_bytes=0)
    pfs = cluster.pfs
    stripe = pfs.stripe_size * max(1, int(chunk_stripes))
    m = min(
        n_leaders if n_leaders is not None else pfs.n_io_servers,
        cluster.n_nodes,
        max(1, pfs.n_stripes(total)),
    )
    sizes = np.asarray(rank_sizes, dtype=np.int64)
    nodes = np.arange(cluster.n_nodes, dtype=np.int64)

    w_parts: List[WriteColumns] = []
    s_parts: List[SendColumns] = []
    for local_idx in range(cluster.procs_per_node):  # one collective / round
        rnd = local_idx + 1
        ranks = nodes * cluster.procs_per_node + local_idx
        idx, p_start, p_size = _split_at_multiples(offsets[ranks], sizes[ranks], stripe)
        # Interleaved static stripe ownership: stripe s -> leader (s % m).
        leader = (p_start // stripe) % m
        src_rank = ranks[idx]
        src_off = p_start - offsets[src_rank]
        rnd_col = np.full(len(idx), rnd, np.int64)
        w_parts.append(
            WriteColumns(
                backend=leader,
                file_id=np.zeros(len(idx), np.int64),
                file_offset=p_start,
                size=p_size,
                src_rank=src_rank,
                src_offset=src_off,
                round=rnd_col,
            )
        )
        remote = leader != nodes[idx]
        s_parts.append(
            SendColumns(
                src_backend=nodes[idx][remote],
                dst_backend=leader[remote],
                src_rank=src_rank[remote],
                src_offset=src_off[remote],
                size=p_size[remote],
                round=rnd_col[remote],
            )
        )
    writes = coalesce_write_columns(WriteColumns.concat(w_parts))
    sends = coalesce_send_columns(SendColumns.concat(s_parts))
    plan = FlushPlan(
        strategy="mpiio",
        cluster=cluster,
        rank_sizes=[int(s) for s in rank_sizes],
        files={AGGREGATE_FILE: total},
        arrays=PlanArrays([AGGREGATE_FILE], writes, sends),
        scan_meta=scan.meta,
        n_rounds=cluster.procs_per_node,
        barrier_per_round=True,  # collective semantics: all ready, together
        leaders=None,  # interleaved stripe ownership, not contiguous regions
        stripe_disjoint=True,
        meta={"interleaved_stripes": True, "m": m,
              "leader_nodes": list(range(m))},
    )
    validate_plan(plan)
    return plan


# ---------------------------------------------------------------------------
# §3 The paper's proposal: stripe-aligned asynchronous aggregation
# ---------------------------------------------------------------------------


def plan_stripe_aligned(
    cluster: ClusterSpec,
    rank_sizes: Sequence[int],
    *,
    n_leaders: Optional[int] = None,
    w_size: float = 1.0,
    w_load: float = 0.75,
    w_topo: float = 0.25,
    pipeline_chunk: Optional[int] = None,
    capacity_regions: bool = False,
    **_: object,
) -> FlushPlan:
    """M elected leaders own static stripe-aligned regions; everyone else
    streams bytes to the owning leader(s).  One piggy-backed prefix sum is
    the only synchronization (paper §3).

    ``pipeline_chunk`` (default: 8 stripes) controls the granularity at
    which sends/writes are decomposed so leaders can overlap receive and
    write, and so the work-stealing executor has units to steal.

    Construction is one global subdivision: the rank offsets (prefix sum),
    leader-region starts and absolute pipeline-chunk multiples are merged
    into a single sorted cut array; each resulting segment maps to its
    source rank and owning leader with two ``np.searchsorted`` calls.
    """
    scan = piggybacked_scan(cluster, rank_sizes)
    pfs = cluster.pfs
    stripe = pfs.stripe_size
    total = scan.total_bytes
    m = n_leaders if n_leaders is not None else min(
        pfs.n_io_servers, cluster.n_nodes
    )
    assign = elect_leaders(
        cluster, scan, m, w_size=w_size, w_load=w_load, w_topo=w_topo,
        capacity_regions=capacity_regions,
    )
    chunk = int(pipeline_chunk) if pipeline_chunk else 8 * stripe

    offsets = scan.offsets_array()
    sizes = np.asarray(rank_sizes, dtype=np.int64)
    region_starts = np.asarray([s for s, _ in assign.regions], np.int64)
    region_leaders = np.asarray(assign.leaders, np.int64)

    # Every write is a maximal segment between consecutive cuts: rank blob
    # boundaries, leader-region starts, and absolute chunk multiples.
    cuts = np.unique(np.concatenate([
        offsets[sizes > 0],
        region_starts,
        np.arange(chunk, total, chunk, dtype=np.int64),
    ]))
    cuts = cuts[(cuts >= 0) & (cuts < total)]
    seg_a = cuts
    seg_b = np.append(cuts[1:], total) if len(cuts) else cuts
    src_rank = np.searchsorted(offsets, seg_a, side="right") - 1
    leader = region_leaders[np.searchsorted(region_starts, seg_a, side="right") - 1]
    home = cluster.nodes_of_ranks(src_rank)
    src_off = seg_a - offsets[src_rank]
    seg_size = seg_b - seg_a

    writes = WriteColumns(
        backend=leader,
        file_id=np.zeros(len(seg_a), np.int64),
        file_offset=seg_a,
        size=seg_size,
        src_rank=src_rank,
        src_offset=src_off,
        round=np.zeros(len(seg_a), np.int64),
    )
    remote = leader != home
    sends = SendColumns(
        src_backend=home[remote],
        dst_backend=leader[remote],
        src_rank=src_rank[remote],
        src_offset=src_off[remote],
        size=seg_size[remote],
        round=np.zeros(int(remote.sum()), np.int64),
    )
    plan = FlushPlan(
        strategy="stripe_aligned",
        cluster=cluster,
        rank_sizes=[int(s) for s in rank_sizes],
        files={AGGREGATE_FILE: total},
        arrays=PlanArrays([AGGREGATE_FILE], writes, sends),
        scan_meta=scan.meta,
        leaders=assign,
        stripe_disjoint=True,
        meta={"m": assign.m, "pipeline_chunk": chunk},
    )
    validate_plan(plan)
    return plan


# ---------------------------------------------------------------------------
# Synchronous GenericIO-like baseline (application blocked)
# ---------------------------------------------------------------------------


def plan_gio_sync(
    cluster: ClusterSpec,
    rank_sizes: Sequence[int],
    *,
    n_leaders: Optional[int] = None,
    chunk_stripes: int = 1,
    **_: object,
) -> FlushPlan:
    """Collective synchronous aggregation straight from application ranks.

    Structurally the MPI-IO plan with a single round (GenericIO hands MPI
    one contiguous buffer per rank) and ``synchronous=True`` — the
    executor charges the *application* for the full duration, and there is
    no separate local phase (Fig. 1 shows GIO writing directly to the
    PFS).
    """
    inner = plan_mpiio(
        cluster, rank_sizes, n_leaders=n_leaders, chunk_stripes=chunk_stripes
    )
    ia = inner.arrays
    plan = FlushPlan(
        strategy="gio_sync",
        cluster=cluster,
        rank_sizes=list(inner.rank_sizes),
        files=dict(inner.files),
        arrays=PlanArrays(
            list(ia.file_names),
            ia.writes.with_round(1),
            ia.sends.with_round(1),
        ),
        scan_meta=inner.scan_meta,
        n_rounds=1,
        barrier_per_round=True,
        leaders=inner.leaders,
        synchronous=True,
        stripe_disjoint=True,
        meta=dict(inner.meta),
    )
    validate_plan(plan)
    return plan


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


StrategyFn = Callable[..., FlushPlan]

STRATEGIES: Dict[str, StrategyFn] = {
    "file_per_process": plan_file_per_process,
    "posix": plan_posix,
    "mpiio": plan_mpiio,
    "stripe_aligned": plan_stripe_aligned,
    "gio_sync": plan_gio_sync,
}


def make_plan(
    name: str, cluster: ClusterSpec, rank_sizes: Sequence[int], **kw
) -> FlushPlan:
    try:
        fn = STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; available: {sorted(STRATEGIES)}"
        ) from None
    return fn(cluster, rank_sizes, **kw)
