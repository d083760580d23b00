"""Discrete-event, max-min-fair flow simulator for pricing FlushPlans.

The real executor (:mod:`repro_torch.core.storage`) runs plans against actual
files; this module prices the *same* plans on a modeled Theta-like
machine so the benchmark harness can reproduce the paper's Figures 1-2 at
thousands-of-ranks scale on one CPU box.

Model
-----
Byte movements become *flows* traversing shared resources; concurrent
flows share capacity max-min fairly (progressive filling, recomputed at
every flow start/finish — the standard fluid network approximation).
Resources:

* per-node NIC tx / rx (Aries injection, application keeps
  ``app_net_load`` of tx for itself — the Tseng et al. interference
  trade-off),
* per-node local-storage read bandwidth (draining L1 checkpoints),
* the PFS data path as one aggregate resource (writes stripe round-robin
  over all OSTs, so every writer engages every OST ~uniformly; per-OST
  lock conflicts are priced separately as a capacity derating),
* a metadata server with bounded op throughput gating file opens,
* a per-flow stream cap (one client stream cannot saturate Lustre).

Flow shapes are derived from plan *structure*, not strategy name:

* direct writes (file-per-process, POSIX aggregation):
  ``[SSD_read(home), NIC_tx(home), PFS]``;
* pipelined leader aggregation (paper §3): one cut-through flow
  ``[SSD_read(home), NIC_tx(home), NIC_rx(leader), NIC_tx(leader), PFS]``
  — leaders stream, receive and write overlap;
* barrier-synchronized collective rounds (MPI-IO, GIO) are priced with a
  closed-form per-round model (gather makespan + write makespan, rounds
  strictly ordered) — barriers remove the overlap that the event loop
  exists to capture, so the analytic form is both faster and faithful.

Lock contention ("false sharing", §2.1) derates PFS capacity:

* non-stripe-aligned shared-file writes: each write RPC into a file with
  ``W > 1`` concurrent writers risks a Lustre extent-lock revocation;
  conflict cost ``rpcs * (W-1)/W * penalty`` serialized across OSTs
  ⇒ ``eff = T_pure / (T_pure + T_lock)``;
* stripe-disjoint plans (MPI-IO leaders, §3 proposal): only ownership
  switches between adjacent extents conflict, with lockahead (half
  penalty) — near-zero derating, by construction.

The front-end consumes :class:`~repro_torch.core.plan.PlanArrays` columns
directly: lock-efficiency, the metadata schedule, write coalescing and
flow construction are array programs, and the fluid engine itself runs
on flat NumPy state (per-flow resource rows, residual capacities updated
with ``np.add.at`` scatters).  Flows with identical resource signatures
receive identical max-min rates, so rates are cached per signature class
and only recomputed when the active class census actually changes —
most starts that replace a same-shaped completion reuse the last rates.

Calibration targets (see EXPERIMENTS.md §Calibration): POSIX aggregation
degrades ~3x vs file-per-process at paper scale (Fig. 2), local phase is
orders of magnitude faster than GIO-direct (Fig. 1), aggregation leaves
the local phase unchanged (Fig. 1).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.plan import (
    FlushPlan,
    PlanArrays,
    coalesce_write_columns,
)

MAX_RPC = 4 << 20  # Lustre max RPC size (4 MiB)


# ---------------------------------------------------------------------------
# Static plan analytics
# ---------------------------------------------------------------------------


def pfs_lock_efficiency(
    plan: FlushPlan, *, rpc_size: Optional[int] = None
) -> Tuple[float, float]:
    """Return (PFS efficiency in (0,1], lock seconds serialized per OST)."""
    pfs = plan.cluster.pfs
    n_srv = max(1, min(pfs.stripe_count, pfs.n_io_servers))
    rpc = min(int(rpc_size or pfs.stripe_size), MAX_RPC)
    penalty = pfs.lock_switch_penalty

    pa = plan.ensure_arrays()
    w = pa.writes
    n_files = max(1, len(pa.file_names))
    n_nodes = plan.cluster.n_nodes

    if len(w) == 0:
        return 1.0, 0.0

    if plan.stripe_disjoint:
        # Only extent-ownership switches conflict; stripe-aligned writers
        # benefit from Lustre lockahead => half penalty.  A switch is a
        # backend change between offset-adjacent writes of the same file.
        order = np.lexsort((w.backend, w.file_offset, w.file_id))
        f = w.file_id[order]
        b = w.backend[order]
        switches = int(np.sum((f[1:] == f[:-1]) & (b[1:] != b[:-1])))
        lock_time = switches / n_srv * (penalty * 0.5)
    else:
        # writers per file (distinct backends) and bytes per file
        pairs = np.unique(w.file_id * n_nodes + w.backend)
        writers = np.bincount((pairs // n_nodes).astype(np.intp), minlength=n_files)
        fbytes = np.zeros(n_files, np.int64)
        np.add.at(fbytes, w.file_id, w.size)
        multi = writers > 1
        conflicted = float(
            (fbytes[multi] / rpc * (writers[multi] - 1) / writers[multi]).sum()
        )
        lock_time = conflicted / n_srv * penalty

    t_pure = plan.total_bytes / pfs.aggregate_bw
    if lock_time <= 0 or t_pure <= 0:
        return 1.0, max(lock_time, 0.0)
    eff = t_pure / (t_pure + lock_time)
    return max(eff, 1e-3), lock_time


def _open_schedule(plan: FlushPlan, pa: PlanArrays) -> Tuple[np.ndarray, np.ndarray]:
    """Unique (backend, file) opens and their MDS completion times.

    File creates (one per file) are serviced first, then opens in
    (backend, file) order, all by a single metadata server with bounded
    throughput.  Returns (encoded backend*n_files+file_id, done_time).
    """
    pfs = plan.cluster.pfs
    w = pa.writes
    n_files = max(1, len(pa.file_names))
    enc = np.unique(w.backend * n_files + w.file_id)
    n_creates = len(plan.files)
    done = pfs.md_latency + (
        n_creates + np.arange(1, len(enc) + 1, dtype=np.float64)
    ) / pfs.md_ops_per_sec
    return enc, done


def metadata_schedule(plan: FlushPlan) -> Dict[Tuple[int, str], float]:
    """Completion time of each (backend, file) open through the MDS queue.

    The returned times gate the first write of each (backend, file).
    (Opens are ordered by (backend, file_id); strategy builders assign
    file ids in name order, so this matches the historical name sort.)
    """
    pa = plan.ensure_arrays()
    enc, done = _open_schedule(plan, pa)
    n_files = max(1, len(pa.file_names))
    names = pa.file_names
    return {
        (int(e // n_files), names[int(e % n_files)]): float(t)
        for e, t in zip(enc, done)
    }


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------


@dataclass
class SimReport:
    strategy: str
    n_ranks: int
    total_bytes: int
    local_time: float
    local_bw: float
    flush_time: float
    flush_bw: float
    md_gate_time: float
    pfs_lock_eff: float
    lock_time_per_ost: float
    network_bytes: int
    n_files: int
    metadata_ops: int
    scan_time: float
    app_slowdown: float
    n_rounds: int
    synchronous: bool
    # Global flush write cap priced into this report (0 = unthrottled);
    # the real-executor twin is the engine's TokenBucket with the same
    # bytes/s, so the simulated and measured trade-off curves agree.
    flush_bw_cap: float = 0.0
    per_backend_finish: Dict[int, float] = field(default_factory=dict)

    def row(self) -> Dict[str, object]:
        d = dict(self.__dict__)
        d.pop("per_backend_finish")
        return d


# ---------------------------------------------------------------------------
# Event-driven fluid simulation (asynchronous, pipelined strategies)
# ---------------------------------------------------------------------------


class _FluidSim:
    """Max-min fair sharing with per-node worker slots and start gates.

    All flow state is columnar: ``res`` holds each flow's resource ids
    (-1 padded), ``slot_nodes`` the nodes whose worker slots it occupies.
    A flow arrives at its gate time, starts when every slot node has a
    free slot (otherwise it queues on each of them), and finishes when
    its bytes drain at the max-min fair rate.
    """

    def __init__(self, caps: np.ndarray, io_threads: int, n_nodes: int):
        self.caps = caps
        self.io_threads = io_threads
        self.n_nodes = n_nodes

    def run(
        self,
        res: np.ndarray,          # (nf, deg) int64, -1 padded
        slot_nodes: np.ndarray,   # (nf, 2) int64, -1 padded
        nbytes: np.ndarray,       # (nf,) float64
        gates: np.ndarray,        # (nf,) float64
        max_rate: float,
        backend: np.ndarray,      # (nf,) int64
        t0: float = 0.0,
    ) -> Tuple[float, Dict[int, float]]:
        nf = len(nbytes)
        if nf == 0:
            return t0, {}
        n_nodes = self.n_nodes
        valid = res >= 0
        # Signature classes: flows with identical resource rows get equal
        # max-min rates, so rates are cached per class (see module doc).
        _, cls = np.unique(res, axis=0, return_inverse=True)
        cls = cls.astype(np.intp)

        remaining = nbytes.astype(np.float64).copy()
        started = np.zeros(nf, bool)
        slots = np.full(n_nodes, self.io_threads, np.int64)
        queues: List[deque] = [deque() for _ in range(n_nodes)]
        arrivals = np.argsort(gates, kind="stable")
        gates_sorted = gates[arrivals]
        ptr = 0

        active = np.empty(nf, np.intp)
        n_active = 0
        per_backend = np.full(n_nodes, -1.0)
        class_rate = np.zeros(int(cls.max()) + 1)
        rate_deltas: Dict[int, int] = {}

        slot_rows = slot_nodes  # alias
        flow_cap = float(max_rate)

        def note(c: int, d: int) -> None:
            v = rate_deltas.get(c, 0) + d
            if v:
                rate_deltas[c] = v
            else:
                rate_deltas.pop(c, None)

        def can_start(fid: int) -> bool:
            a, b = slot_rows[fid]
            if b == a:  # duplicated row: start() takes (and free returns) two
                return slots[a] > 1
            if slots[a] <= 0:
                return False
            return b < 0 or slots[b] > 0

        def start(fid: int) -> None:
            nonlocal n_active
            a, b = slot_rows[fid]
            slots[a] -= 1
            if b >= 0:
                slots[b] -= 1
            started[fid] = True
            active[n_active] = fid
            n_active += 1
            note(int(cls[fid]), +1)

        def admit(fid: int) -> None:
            if can_start(fid):
                start(fid)
            else:
                a, b = slot_rows[fid]
                queues[a].append(fid)
                if b >= 0 and b != a:
                    queues[b].append(fid)

        def try_start_from(node: int) -> None:
            q = queues[node]
            for _ in range(len(q)):
                if slots[node] <= 0:
                    # every flow queued here needs a slot on this node
                    break
                fid = q.popleft()
                if started[fid]:
                    continue  # duplicate entry (queued on several slot
                    # nodes, started via another one): drop, don't requeue
                if can_start(fid):
                    start(fid)
                else:
                    q.append(fid)

        now = t0
        eps = 1e-12
        while True:
            while ptr < nf and gates_sorted[ptr] <= now + eps:
                admit(int(arrivals[ptr]))
                ptr += 1
            if n_active == 0:
                if ptr < nf:
                    now = max(now, float(gates_sorted[ptr]))
                    continue
                break

            act = active[:n_active]
            if rate_deltas:
                rates_a = _maxmin_rates(
                    res[act], valid[act], flow_cap, self.caps
                )
                class_rate[cls[act]] = rates_a
                rate_deltas.clear()
            else:
                rates_a = class_rate[cls[act]]

            rem_a = remaining[act]
            with np.errstate(divide="ignore"):
                ttf = np.where(rates_a > 0, rem_a / np.maximum(rates_a, 1e-30), np.inf)
            dt = float(ttf.min())
            next_arrival = float(gates_sorted[ptr]) if ptr < nf else math.inf
            dt = min(dt, next_arrival - now)
            if not math.isfinite(dt):
                raise RuntimeError("simulation stalled: active flows with zero rate")
            dt = max(dt, 0.0)
            now += dt

            rem_a = rem_a - rates_a * dt
            remaining[act] = rem_a
            comp = rem_a <= 1e-6
            if comp.any():
                done = act[comp]
                per_backend[backend[done]] = now  # monotone: later is larger
                freed = slot_rows[done]
                freed = freed[freed >= 0]
                np.add.at(slots, freed, 1)
                for c in cls[done].tolist():
                    note(int(c), -1)
                keep = act[~comp]
                n_active = len(keep)
                active[:n_active] = keep
                for nd in np.unique(freed).tolist():
                    try_start_from(int(nd))

        out = {int(b): float(t) for b, t in enumerate(per_backend) if t >= 0.0}
        return now, out


def _maxmin_rates(
    res: np.ndarray, valid: np.ndarray, flow_cap: float, caps: np.ndarray
) -> np.ndarray:
    """Progressive-filling max-min fair rates.

    ``res``/``valid`` are the active flows' resource rows, flattened once
    into (flow, resource) incidence arrays; residual capacities are
    updated with ``np.add.at`` scatters (no per-flow Python loops).  All
    resources whose share ties the bottleneck saturate at the same water
    level, so they freeze together in one iteration — with symmetric
    node groups this collapses the iteration count to the number of
    *distinct* bottleneck levels.
    """
    nf = len(res)
    rates = np.zeros(nf)
    frozen = np.zeros(nf, bool)
    res_cap = caps.astype(np.float64).copy()
    nres = len(caps)
    valid_flat = valid.ravel()
    flat_res = res.ravel()[valid_flat].astype(np.intp)
    flat_flow = np.repeat(np.arange(nf, dtype=np.intp), res.shape[1])[valid_flat]

    for _ in range(nres + nf + 1):
        if frozen.all():
            break
        un = ~frozen
        live = un[flat_flow]
        idx = flat_res[live]
        if idx.size == 0:
            rates[un] = flow_cap
            break
        counts = np.bincount(idx, minlength=nres)
        with np.errstate(divide="ignore", invalid="ignore"):
            share = np.where(counts > 0, res_cap / np.maximum(counts, 1), np.inf)
        b_share = float(share.min())
        # flows capped below the bottleneck share freeze at their own cap
        if flow_cap <= b_share + 1e-9:
            rates[un] = flow_cap
            frozen |= un
            np.add.at(res_cap, idx, -flow_cap)
            continue
        if not math.isfinite(b_share):
            rates[un] = flow_cap
            break
        bmask = share == b_share
        touch = np.zeros(nf, bool)
        touch[flat_flow[live][bmask[idx]]] = True
        rates[touch] = b_share
        frozen |= touch
        flat_t = touch[flat_flow]
        sub_idx = flat_res[flat_t]
        keep = ~bmask[sub_idx]
        np.add.at(res_cap, sub_idx[keep], -b_share)
        res_cap[bmask] = 0.0
    return np.maximum(rates, 0.0)


# ---------------------------------------------------------------------------
# The simulator facade
# ---------------------------------------------------------------------------


class FlushSimulator:
    def __init__(
        self,
        plan: FlushPlan,
        *,
        io_threads: int = 2,
        rpc_size: Optional[int] = None,
        msg_latency: float = 5e-6,
        flush_bw_cap: Optional[float] = None,
    ) -> None:
        self.plan = plan
        self.cluster = plan.cluster
        self.io_threads = max(1, int(io_threads))
        self.rpc_size = rpc_size
        self.msg_latency = msg_latency
        # Global flush write cap (bytes/s) — the engine's token-bucket
        # throttle priced as one extra shared resource every write flow
        # traverses (event-driven strategies) / a per-round floor of
        # round_bytes / cap (barrier strategies).  None/<=0 = off.
        self.flush_bw_cap = (
            float(flush_bw_cap) if flush_bw_cap and flush_bw_cap > 0 else None
        )

    # resource ids: [0,n) NIC_tx · [n,2n) NIC_rx · [2n,3n) SSD_read · [3n] PFS
    # · [3n+1] the global flush_bw_cap token bucket (only when set)
    def _caps(self, pfs_eff: float) -> np.ndarray:
        c = self.cluster
        n = c.n_nodes
        derate = np.maximum(1e-3, 1.0 - c.loads())
        caps = np.empty(3 * n + 1 + (1 if self.flush_bw_cap else 0))
        caps[:n] = c.node.nic_bw * (1.0 - c.node.app_net_load) * derate
        caps[n: 2 * n] = c.node.nic_bw * derate
        caps[2 * n: 3 * n] = c.node.local_read_bw * derate
        caps[3 * n] = c.pfs.aggregate_bw * pfs_eff
        if self.flush_bw_cap:
            caps[3 * n + 1] = self.flush_bw_cap
        return caps

    def run(self) -> SimReport:
        plan = self.plan
        c = self.cluster
        pfs_eff, lock_time = pfs_lock_efficiency(plan, rpc_size=self.rpc_size)
        pa = plan.ensure_arrays()
        enc_opens, open_done = _open_schedule(plan, pa)
        md_max = float(open_done[-1]) if len(open_done) else 0.0

        scan_time = 0.0
        if plan.scan_meta is not None:
            scan_time = (
                plan.scan_meta.rounds * self.msg_latency
                + plan.scan_meta.messages * plan.scan_meta.payload_bytes / c.node.nic_bw
            )

        if plan.barrier_per_round:
            flush_time, per_backend = self._analytic_rounds(pfs_eff, md_max)
        else:
            flush_time, per_backend = self._event_driven(
                pfs_eff, enc_opens, open_done
            )
        flush_time += scan_time

        total = plan.total_bytes
        if plan.synchronous:
            local_time = flush_time  # GIO: app blocked for the whole write
        else:
            sizes = np.asarray(plan.rank_sizes, np.int64)
            node_bytes = sizes.reshape(c.n_nodes, c.procs_per_node).sum(axis=1)
            derate = np.maximum(1e-3, 1.0 - c.loads())
            local_time = (
                float((node_bytes / (c.node.local_bw * derate)).max(initial=0.0))
                + scan_time
            )

        net_bytes = plan.network_bytes()
        cpu_steal = self.io_threads / c.node.cores
        net_frac = 0.0
        if flush_time > 0 and not plan.synchronous:
            net_frac = min(
                1.0, (net_bytes + total) / (c.n_nodes * c.node.nic_bw * flush_time)
            )
        app_slowdown = (
            1.0
            if plan.synchronous
            else cpu_steal + net_frac * c.node.app_net_load
        )

        return SimReport(
            strategy=plan.strategy,
            n_ranks=c.world_size,
            total_bytes=total,
            local_time=local_time,
            local_bw=total / local_time if local_time > 0 else float("inf"),
            flush_time=flush_time,
            flush_bw=total / flush_time if flush_time > 0 else float("inf"),
            md_gate_time=md_max,
            pfs_lock_eff=pfs_eff,
            lock_time_per_ost=lock_time,
            network_bytes=net_bytes,
            n_files=plan.n_files,
            metadata_ops=plan.metadata_ops(),
            scan_time=scan_time,
            app_slowdown=app_slowdown,
            n_rounds=plan.n_rounds,
            synchronous=plan.synchronous,
            flush_bw_cap=self.flush_bw_cap or 0.0,
            per_backend_finish=per_backend,
        )

    # -- asynchronous strategies: event loop --------------------------------
    def _event_driven(
        self, pfs_eff: float, opens: np.ndarray, open_done: np.ndarray
    ) -> Tuple[float, Dict[int, float]]:
        plan = self.plan
        c = self.cluster
        n = c.n_nodes
        stream_cap = c.pfs.client_stream_bw
        pa = plan.ensure_arrays()
        w = coalesce_write_columns(pa.writes)
        nf = len(w)
        if nf == 0:
            return 0.0, {}
        n_files = max(1, len(pa.file_names))
        enc = w.backend * n_files + w.file_id
        gates = open_done[np.searchsorted(opens, enc)]

        home = c.nodes_of_ranks(w.src_rank)
        direct = w.backend == home
        remote = ~direct
        # direct: [SSD(home), TX(home), PFS]
        # remote: pipelined cut-through gather+write (paper §3 streaming)
        #         [SSD(home), TX(home), RX(leader), TX(leader), PFS]
        # with a flush_bw_cap every flow additionally traverses the
        # shared token-bucket resource (id 3n+1)
        width = 6 if self.flush_bw_cap else 5
        res = np.full((nf, width), -1, np.int64)
        res[:, 0] = 2 * n + home
        res[:, 1] = home
        res[direct, 2] = 3 * n
        res[remote, 2] = n + w.backend[remote]
        res[remote, 3] = w.backend[remote]
        res[remote, 4] = 3 * n
        if self.flush_bw_cap:
            res[direct, 3] = 3 * n + 1
            res[remote, 5] = 3 * n + 1
        slot_nodes = np.full((nf, 2), -1, np.int64)
        slot_nodes[:, 0] = home
        slot_nodes[remote, 1] = w.backend[remote]

        sim = _FluidSim(self._caps(pfs_eff), self.io_threads, n)
        return sim.run(
            res, slot_nodes, w.size.astype(np.float64), gates,
            stream_cap, w.backend,
        )

    # -- collective strategies: closed-form barrier rounds -------------------
    def _analytic_rounds(
        self, pfs_eff: float, md_max: float
    ) -> Tuple[float, Dict[int, float]]:
        plan = self.plan
        c = self.cluster
        n = c.n_nodes
        stream_cap = c.pfs.client_stream_bw
        nic_tx_eff = c.node.nic_bw * (1.0 - c.node.app_net_load)
        pa = plan.ensure_arrays()
        w, s = pa.writes, pa.sends

        rounds = np.union1d(np.unique(w.round), np.unique(s.round))
        R = len(rounds)
        if R == 0:
            return md_max, {}
        ri_w = np.searchsorted(rounds, w.round)
        ri_s = np.searchsorted(rounds, s.round)

        out_b = np.zeros((R, n), np.int64)
        in_b = np.zeros((R, n), np.int64)
        read_b = np.zeros((R, n), np.int64)
        wr_b = np.zeros((R, n), np.int64)
        np.add.at(out_b, (ri_s, s.src_backend), s.size)
        np.add.at(in_b, (ri_s, s.dst_backend), s.size)
        if not plan.synchronous:
            np.add.at(read_b, (ri_s, s.src_backend), s.size)
            home_w = c.nodes_of_ranks(w.src_rank)
            local = home_w == w.backend
            np.add.at(read_b, (ri_w[local], home_w[local]), w.size[local])
        np.add.at(wr_b, (ri_w, w.backend), w.size)
        round_bytes = wr_b.sum(axis=1)

        derate = np.maximum(1e-3, 1.0 - c.loads())
        t_gather = np.maximum(
            out_b / (nic_tx_eff * derate),
            np.maximum(in_b / (c.node.nic_bw * derate),
                       read_b / (c.node.local_read_bw * derate)),
        ).max(axis=1)
        t_write = np.where(
            round_bytes > 0, round_bytes / (c.pfs.aggregate_bw * pfs_eff), 0.0
        )
        per_node_write = wr_b / np.minimum(
            nic_tx_eff * derate, stream_cap * self.io_threads
        )
        t_write = np.maximum(t_write, per_node_write.max(axis=1))
        if self.flush_bw_cap:
            # the token bucket is global: each barrier round drains no
            # faster than the cap, exactly like the real executor
            t_write = np.maximum(t_write, round_bytes / self.flush_bw_cap)

        cum = md_max + np.cumsum(t_gather + t_write)
        per_backend: Dict[int, float] = {}
        writes_in_round = wr_b > 0
        any_write = writes_in_round.any(axis=0)
        last_round = R - 1 - np.argmax(writes_in_round[::-1, :], axis=0)
        for nd in np.flatnonzero(any_write).tolist():
            per_backend[int(nd)] = float(cum[last_round[nd]])
        return float(cum[-1]), per_backend


def simulate_flush(
    plan: FlushPlan,
    *,
    io_threads: int = 2,
    rpc_size: Optional[int] = None,
    flush_bw_cap: Optional[float] = None,
) -> SimReport:
    return FlushSimulator(
        plan, io_threads=io_threads, rpc_size=rpc_size,
        flush_bw_cap=flush_bw_cap,
    ).run()


def simulate_flush_shared(
    plans: List[FlushPlan],
    *,
    flush_bw_cap: float,
    weights: Optional[List[float]] = None,
    io_threads: int = 2,
    rpc_size: Optional[int] = None,
) -> List[SimReport]:
    """Multi-tenant pricing of one shared ``flush_bw_cap``.

    ``plans[i]`` is tenant *i*'s concurrent flush.  The global cap is
    split by :func:`repro_torch.core.storage.fair_share_rates` — each
    tenant's *demand* is the bandwidth its flush would sustain
    unthrottled (its uncapped sim), its *weight* the operator
    priority — and tenant *i* is then priced exactly like a single-job
    ``flush_bw_cap`` equal to its granted share.  This is the fluid
    twin of the runtime's hierarchical token buckets
    (:class:`repro_torch.core.storage.FairShareLimiter`): both layers reduce
    a tenant's view of the shared PFS to "one private cap of my
    granted rate", so the single-job sim-vs-real throttle equivalence
    carries over tenant by tenant.

    A zero/negative cap means unthrottled: every plan is simulated
    independently (no shared resource to split).
    """
    from repro_torch.core.storage import fair_share_rates

    if not plans:
        return []
    w = list(weights) if weights is not None else [1.0] * len(plans)
    if len(w) != len(plans):
        raise ValueError("weights must match plans")
    base = [
        simulate_flush(p, io_threads=io_threads, rpc_size=rpc_size)
        for p in plans
    ]
    if flush_bw_cap <= 0:
        return base
    demands = [
        min(b.flush_bw, 1e30) if p.total_bytes > 0 else 0.0
        for p, b in zip(plans, base)
    ]
    rates = fair_share_rates(w, demands, flush_bw_cap)
    out: List[SimReport] = []
    for i, (p, b, r) in enumerate(zip(plans, base, rates)):
        if p.total_bytes <= 0 or r >= demands[i] - 1e-9:
            out.append(b)  # its own demand binds before the quota does
        else:
            out.append(
                simulate_flush(
                    p, io_threads=io_threads, rpc_size=rpc_size,
                    flush_bw_cap=float(r),
                )
            )
    return out
