"""Reference (item-loop) strategy builders — the executable spec.

These are the original per-item planners that :mod:`repro_torch.core.strategies`
replaced with columnar array programs.  They are kept verbatim (minus the
``validate_plan`` calls, which tests run explicitly) so that
``tests/test_plan_arrays.py`` can assert the columnar builders produce
byte-identical coalesced write/send sets on small clusters for every
strategy.  They are quadratic-ish in places and allocate one frozen
dataclass per movement — do not use them at scale.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.plan import FlushPlan, SendItem, WriteItem
from repro_torch.core.prefix_sum import (
    elect_leaders,
    exclusive_prefix_sum,
    piggybacked_scan,
)
from repro_torch.core.strategies import AGGREGATE_FILE, _rank_file


def plan_file_per_process_ref(
    cluster: ClusterSpec, rank_sizes: Sequence[int], **_: object
) -> FlushPlan:
    writes: List[WriteItem] = []
    files: Dict[str, int] = {}
    for rank, size in enumerate(rank_sizes):
        if size == 0:
            continue
        fname = _rank_file(rank)
        files[fname] = int(size)
        writes.append(
            WriteItem(
                backend=cluster.node_of_rank(rank),
                file=fname,
                file_offset=0,
                size=int(size),
                src_rank=rank,
                src_offset=0,
            )
        )
    return FlushPlan(
        strategy="file_per_process",
        cluster=cluster,
        rank_sizes=[int(s) for s in rank_sizes],
        files=files,
        writes=writes,
        scan_meta=None,
        stripe_disjoint=True,
    )


def plan_posix_ref(
    cluster: ClusterSpec,
    rank_sizes: Sequence[int],
    *,
    write_chunk: Optional[int] = None,
    **_: object,
) -> FlushPlan:
    offsets, total = exclusive_prefix_sum(rank_sizes)
    scan = piggybacked_scan(cluster, rank_sizes, payload_extra_bytes=0)
    writes: List[WriteItem] = []
    for rank, size in enumerate(rank_sizes):
        size = int(size)
        if size == 0:
            continue
        backend = cluster.node_of_rank(rank)
        step = size if not write_chunk else max(1, int(write_chunk))
        pos = 0
        while pos < size:
            n = min(step, size - pos)
            writes.append(
                WriteItem(
                    backend=backend,
                    file=AGGREGATE_FILE,
                    file_offset=offsets[rank] + pos,
                    size=n,
                    src_rank=rank,
                    src_offset=pos,
                )
            )
            pos += n
    return FlushPlan(
        strategy="posix",
        cluster=cluster,
        rank_sizes=[int(s) for s in rank_sizes],
        files={AGGREGATE_FILE: total},
        writes=writes,
        scan_meta=scan.meta,
        stripe_disjoint=False,
    )


def plan_mpiio_ref(
    cluster: ClusterSpec,
    rank_sizes: Sequence[int],
    *,
    n_leaders: Optional[int] = None,
    chunk_stripes: int = 1,
    **_: object,
) -> FlushPlan:
    offsets, total = exclusive_prefix_sum(rank_sizes)
    scan = piggybacked_scan(cluster, rank_sizes, payload_extra_bytes=0)
    pfs = cluster.pfs
    stripe = pfs.stripe_size * max(1, int(chunk_stripes))
    m = min(
        n_leaders if n_leaders is not None else pfs.n_io_servers,
        cluster.n_nodes,
        max(1, pfs.n_stripes(total)),
    )
    leader_nodes = list(range(m))

    writes: List[WriteItem] = []
    sends: List[SendItem] = []
    for local_idx in range(cluster.procs_per_node):
        rnd = local_idx + 1
        for node in range(cluster.n_nodes):
            rank = node * cluster.procs_per_node + local_idx
            size = int(rank_sizes[rank])
            if size == 0:
                continue
            base = offsets[rank]
            pos = 0
            while pos < size:
                off = base + pos
                s_idx = off // stripe
                stripe_end = (s_idx + 1) * stripe
                n = min(size - pos, stripe_end - off)
                leader = leader_nodes[s_idx % m]
                if leader != node:
                    sends.append(
                        SendItem(
                            src_backend=node,
                            dst_backend=leader,
                            src_rank=rank,
                            src_offset=pos,
                            size=n,
                            round=rnd,
                        )
                    )
                writes.append(
                    WriteItem(
                        backend=leader,
                        file=AGGREGATE_FILE,
                        file_offset=off,
                        size=n,
                        src_rank=rank,
                        src_offset=pos,
                        round=rnd,
                    )
                )
                pos += n
    writes = _coalesce_writes_ref(writes)
    sends = _coalesce_sends_ref(sends)
    return FlushPlan(
        strategy="mpiio",
        cluster=cluster,
        rank_sizes=[int(s) for s in rank_sizes],
        files={AGGREGATE_FILE: total},
        writes=writes,
        sends=sends,
        scan_meta=scan.meta,
        n_rounds=cluster.procs_per_node,
        barrier_per_round=True,
        leaders=None,
        stripe_disjoint=True,
        meta={"interleaved_stripes": True, "m": m, "leader_nodes": leader_nodes},
    )


def plan_stripe_aligned_ref(
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

    writes: List[WriteItem] = []
    sends: List[SendItem] = []
    for rank, size in enumerate(rank_sizes):
        size = int(size)
        if size == 0:
            continue
        home = cluster.node_of_rank(rank)
        base = scan.rank_offsets[rank]
        pos = 0
        while pos < size:
            off = base + pos
            leader = assign.leader_of_offset(off)
            # Slice ends at the first of: blob end, leader-region end,
            # pipeline-chunk boundary (aligned to absolute file offsets so
            # chunk edges coincide with stripe edges).
            region_end = next(e for (s, e) in assign.regions if s <= off < e)
            chunk_end = (off // chunk + 1) * chunk
            n = min(size - pos, region_end - off, chunk_end - off)
            if leader != home:
                sends.append(
                    SendItem(
                        src_backend=home,
                        dst_backend=leader,
                        src_rank=rank,
                        src_offset=pos,
                        size=n,
                    )
                )
            writes.append(
                WriteItem(
                    backend=leader,
                    file=AGGREGATE_FILE,
                    file_offset=off,
                    size=n,
                    src_rank=rank,
                    src_offset=pos,
                )
            )
            pos += n
    return FlushPlan(
        strategy="stripe_aligned",
        cluster=cluster,
        rank_sizes=[int(s) for s in rank_sizes],
        files={AGGREGATE_FILE: total},
        writes=writes,
        sends=sends,
        scan_meta=scan.meta,
        leaders=assign,
        stripe_disjoint=True,
        meta={"m": assign.m, "pipeline_chunk": chunk},
    )


def plan_gio_sync_ref(
    cluster: ClusterSpec,
    rank_sizes: Sequence[int],
    *,
    n_leaders: Optional[int] = None,
    chunk_stripes: int = 1,
    **_: object,
) -> FlushPlan:
    inner = plan_mpiio_ref(
        cluster, rank_sizes, n_leaders=n_leaders, chunk_stripes=chunk_stripes
    )
    writes = [
        WriteItem(
            backend=w.backend,
            file=w.file,
            file_offset=w.file_offset,
            size=w.size,
            src_rank=w.src_rank,
            src_offset=w.src_offset,
            round=1,
        )
        for w in inner.writes
    ]
    sends = [
        SendItem(
            src_backend=s.src_backend,
            dst_backend=s.dst_backend,
            src_rank=s.src_rank,
            src_offset=s.src_offset,
            size=s.size,
            round=1,
        )
        for s in inner.sends
    ]
    return FlushPlan(
        strategy="gio_sync",
        cluster=cluster,
        rank_sizes=list(inner.rank_sizes),
        files=dict(inner.files),
        writes=writes,
        sends=sends,
        scan_meta=inner.scan_meta,
        n_rounds=1,
        barrier_per_round=True,
        leaders=inner.leaders,
        synchronous=True,
        stripe_disjoint=True,
        meta=dict(inner.meta),
    )


def _coalesce_writes_ref(items: List[WriteItem]) -> List[WriteItem]:
    """Merge adjacent stripe-chunk writes with identical (backend, file,
    rank, round) and contiguous offsets into maximal runs."""
    items = sorted(
        items, key=lambda w: (w.round, w.backend, w.file, w.src_rank, w.file_offset)
    )
    out: List[WriteItem] = []
    for w in items:
        if out:
            p = out[-1]
            if (
                p.round == w.round
                and p.backend == w.backend
                and p.file == w.file
                and p.src_rank == w.src_rank
                and p.file_offset + p.size == w.file_offset
                and p.src_offset + p.size == w.src_offset
            ):
                out[-1] = WriteItem(
                    backend=p.backend,
                    file=p.file,
                    file_offset=p.file_offset,
                    size=p.size + w.size,
                    src_rank=p.src_rank,
                    src_offset=p.src_offset,
                    round=p.round,
                )
                continue
        out.append(w)
    return out


def _coalesce_sends_ref(items: List[SendItem]) -> List[SendItem]:
    items = sorted(
        items,
        key=lambda s: (s.round, s.src_backend, s.dst_backend, s.src_rank, s.src_offset),
    )
    out: List[SendItem] = []
    for s in items:
        if out:
            p = out[-1]
            if (
                p.round == s.round
                and p.src_backend == s.src_backend
                and p.dst_backend == s.dst_backend
                and p.src_rank == s.src_rank
                and p.src_offset + p.size == s.src_offset
            ):
                out[-1] = SendItem(
                    src_backend=p.src_backend,
                    dst_backend=p.dst_backend,
                    src_rank=p.src_rank,
                    src_offset=p.src_offset,
                    size=p.size + s.size,
                    round=p.round,
                )
                continue
        out.append(s)
    return out


REFERENCE_STRATEGIES = {
    "file_per_process": plan_file_per_process_ref,
    "posix": plan_posix_ref,
    "mpiio": plan_mpiio_ref,
    "stripe_aligned": plan_stripe_aligned_ref,
    "gio_sync": plan_gio_sync_ref,
}


def make_plan_reference(
    name: str, cluster: ClusterSpec, rank_sizes: Sequence[int], **kw
) -> FlushPlan:
    return REFERENCE_STRATEGIES[name](cluster, rank_sizes, **kw)
