"""Prefix-sum offset computation + piggy-backed leader election.

The paper's key coordination primitive: one exclusive prefix sum over the
per-rank checkpoint sizes yields every rank's offset in the aggregated
remote file.  The proposed strategy (paper §3) *piggy-backs* extra
per-node summaries (local bytes, load, topology coordinate) on the same
scan so that every active backend can afterwards compute — independently
and deterministically — the identical leader assignment, without any
further agreement protocol.

Everything here is a pure algorithm (no I/O): the planner uses it
directly, and the simulator prices its message complexity.

At paper scale the scan and the election inputs are array programs: the
exclusive scan is one ``np.cumsum``, per-node byte totals are a reshape-
sum, and the per-(region, node) election scores are computed as
broadcast NumPy expressions rather than nested Python loops.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import ClusterSpec


@dataclass(frozen=True)
class ScanMeta:
    """Cost model of the scan used for coordination.

    A classic up-/down-sweep tree over P participants: ``2*ceil(log2 P)``
    latency-bound rounds, ``2*(P-1)`` point-to-point messages total, each
    carrying ``payload_bytes`` (offset partial + piggy-backed summary).
    """

    participants: int
    rounds: int
    messages: int
    payload_bytes: int

    @staticmethod
    def for_participants(p: int, payload_bytes: int) -> "ScanMeta":
        rounds = 2 * max(1, math.ceil(math.log2(max(2, p))))
        return ScanMeta(
            participants=p,
            rounds=rounds,
            messages=2 * max(0, p - 1),
            payload_bytes=payload_bytes,
        )


@dataclass(frozen=True)
class NodeSummary:
    """Per-node info carried by the piggy-backed scan (paper §3)."""

    node: int
    bytes: int          # total node-local checkpoint bytes on this node
    load: float         # current background load in [0, 1)
    coord: int          # topology coordinate (proximity = |a - b|)


@dataclass
class ScanResult:
    """Output of the (piggy-backed) exclusive prefix sum."""

    rank_offsets: List[int]           # exclusive prefix sum per rank
    total_bytes: int
    node_summaries: List[NodeSummary]
    meta: ScanMeta = field(default=None)  # type: ignore[assignment]
    # Columnar twins, populated by piggybacked_scan so the vectorized
    # planner layers never rebuild them from the Python lists.
    offsets_np: Optional[np.ndarray] = None   # int64, len world_size
    node_bytes_np: Optional[np.ndarray] = None  # int64, len n_nodes

    def offsets_array(self) -> np.ndarray:
        if self.offsets_np is None:
            self.offsets_np = np.asarray(self.rank_offsets, dtype=np.int64)
        return self.offsets_np


def exclusive_prefix_sum_np(sizes: Sequence[int]) -> Tuple[np.ndarray, int]:
    """Vectorized exclusive scan: (int64 offsets, total)."""
    arr = np.asarray(sizes, dtype=np.int64)
    if arr.size and int(arr.min()) < 0:
        raise ValueError("checkpoint sizes must be non-negative")
    offsets = np.zeros(arr.size, dtype=np.int64)
    if arr.size:
        np.cumsum(arr[:-1], out=offsets[1:])
    total = int(arr.sum())
    return offsets, total


def exclusive_prefix_sum(sizes: Sequence[int]) -> Tuple[List[int], int]:
    offsets, total = exclusive_prefix_sum_np(sizes)
    return offsets.tolist(), total


def piggybacked_scan(
    cluster: ClusterSpec,
    rank_sizes: Sequence[int],
    *,
    payload_extra_bytes: int = 24,
) -> ScanResult:
    """Exclusive scan over rank sizes + per-node summary exchange.

    ``payload_extra_bytes`` models the piggy-backed (bytes, load, coord)
    triple added to each scan message; it appears only in the cost model.
    """
    if len(rank_sizes) != cluster.world_size:
        raise ValueError(
            f"expected {cluster.world_size} rank sizes, got {len(rank_sizes)}"
        )
    offsets, total = exclusive_prefix_sum_np(rank_sizes)
    sizes = np.asarray(rank_sizes, dtype=np.int64)
    node_bytes = sizes.reshape(cluster.n_nodes, cluster.procs_per_node).sum(axis=1)
    loads = cluster.loads()
    coords = cluster.coords()
    summaries = [
        NodeSummary(node=node, bytes=int(node_bytes[node]),
                    load=float(loads[node]), coord=int(coords[node]))
        for node in range(cluster.n_nodes)
    ]
    meta = ScanMeta.for_participants(
        cluster.n_nodes, payload_bytes=8 + payload_extra_bytes
    )
    return ScanResult(
        rank_offsets=offsets.tolist(),
        total_bytes=total,
        node_summaries=summaries,
        meta=meta,
        offsets_np=offsets,
        node_bytes_np=node_bytes,
    )


# ---------------------------------------------------------------------------
# Leader election (paper §3, criteria 1-3)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LeaderAssignment:
    """M leaders, each statically owning a stripe-aligned file region.

    ``regions[j] = (start, end)`` in file-offset bytes, start/end aligned
    to the PFS stripe size (end of the last region = padded total).
    ``leaders[j]`` is the node id leading region j.
    """

    leaders: List[int]
    regions: List[Tuple[int, int]]

    def leader_of_offset(self, off: int) -> int:
        for j, (s, e) in enumerate(self.regions):
            if s <= off < e:
                return self.leaders[j]
        raise ValueError(f"offset {off} outside every region")

    @property
    def m(self) -> int:
        return len(self.leaders)


def elect_leaders(
    cluster: ClusterSpec,
    scan: ScanResult,
    m_leaders: int,
    *,
    w_size: float = 1.0,
    w_load: float = 0.75,
    w_topo: float = 0.25,
    capacity_regions: bool = False,
) -> LeaderAssignment:
    """Deterministic leader election from piggy-backed summaries.

    Every node evaluates this identical pure function on the identical
    scan output, hence all nodes agree on the assignment with zero extra
    communication (the paper's "no further agreement protocols").

    Scoring per (region, candidate node):
      + ``w_size`` * fraction of the region's bytes already held locally
        (criterion 1: big holders lead, minimizing network transfer)
      - ``w_load`` * node background load (criterion 2)
      - ``w_topo`` * normalized topology distance from the region's
        centroid sender (criterion 3: leaders near their senders)

    ``capacity_regions`` (beyond-paper straggler mitigation): after the
    election, region sizes are re-proportioned to each leader's capacity
    (1 - load) and re-snapped to stripes, so a loaded leader owns fewer
    stripes instead of the same S/M share — the deterministic analogue of
    work stealing (still zero extra communication: every backend computes
    the same resize from the same piggy-backed loads).
    """
    if m_leaders <= 0:
        raise ValueError("m_leaders must be positive")
    pfs = cluster.pfs
    stripe = pfs.stripe_size
    total = scan.total_bytes
    n_nodes = cluster.n_nodes
    ppn = cluster.procs_per_node
    n_stripes = max(1, pfs.n_stripes(total))
    m = min(m_leaders, n_stripes, n_nodes)
    stripes_per_region = -(-n_stripes // m)

    regions: List[Tuple[int, int]] = []
    for j in range(m):
        start = j * stripes_per_region * stripe
        end = min((j + 1) * stripes_per_region * stripe, n_stripes * stripe)
        if start >= end:
            break
        regions.append((start, end))
    m = len(regions)

    # Node byte-extent in the aggregate file: [first rank offset, last end).
    # Ranks of a node are contiguous, so the extent is simply the first
    # rank's offset up to the next node's first offset (or the total).
    offsets = scan.offsets_array()
    if offsets.size:
        ext_lo = offsets[::ppn]
        ext_hi = np.append(offsets[ppn::ppn], total)
    else:
        ext_lo = np.zeros(n_nodes, np.int64)
        ext_hi = np.zeros(n_nodes, np.int64)

    node_bytes = (
        scan.node_bytes_np
        if scan.node_bytes_np is not None
        else np.asarray([s.bytes for s in scan.node_summaries], np.int64)
    )
    loads = cluster.loads()
    coords = cluster.coords().astype(np.float64)
    max_node_bytes = max(1, int(node_bytes.max(initial=0)))
    coord_span = max(1.0, float(coords.max() - coords.min()))

    reg_lo = np.asarray([r[0] for r in regions], np.int64)
    reg_hi = np.asarray([r[1] for r in regions], np.int64)
    # (m, n_nodes) byte overlap between each region and each node extent.
    ob = np.maximum(
        0,
        np.minimum(ext_hi[None, :], reg_hi[:, None])
        - np.maximum(ext_lo[None, :], reg_lo[:, None]),
    ).astype(np.float64)

    leaders: List[int] = []
    taken = np.zeros(n_nodes, bool)
    allow_reuse = m > n_nodes  # only possible via tiny clusters
    base_score = (
        w_size * 0.5 * (node_bytes.astype(np.float64) / max_node_bytes)
        - w_load * loads
    )
    for j in range(m):
        reg_bytes = max(1, int(reg_hi[j] - reg_lo[j]))
        # Topology centroid of the senders feeding this region, weighted by
        # how many of their bytes land here.
        wsum = float(ob[j].sum())
        centroid = float((ob[j] * coords).sum() / wsum) if wsum > 0 else float(coords[0])
        score = (
            base_score
            + w_size * 0.5 * (ob[j] / reg_bytes)
            - w_topo * np.abs(coords - centroid) / coord_span
        )
        if not allow_reuse:
            score = np.where(taken, -np.inf, score)
        best = int(np.argmax(score))
        leaders.append(best)
        taken[best] = True

    if capacity_regions and len(leaders) > 1:
        caps = [max(1e-3, 1.0 - cluster.load_of(nd)) for nd in leaders]
        total_cap = sum(caps)
        new_regions: List[Tuple[int, int]] = []
        start_stripe = 0
        total_stripes = n_stripes
        for j, cap in enumerate(caps):
            if j == len(caps) - 1:
                n_str = total_stripes - start_stripe
            else:
                n_str = max(1, round(total_stripes * cap / total_cap))
                n_str = min(n_str, total_stripes - start_stripe - (len(caps) - 1 - j))
            s0 = start_stripe * stripe
            e0 = min((start_stripe + n_str) * stripe, n_stripes * stripe)
            new_regions.append((s0, e0))
            start_stripe += n_str
        regions = [r for r in new_regions if r[0] < r[1]]
        leaders = leaders[: len(regions)]

    return LeaderAssignment(leaders=leaders, regions=regions)
