"""Cluster / PFS descriptions shared by every aggregation strategy.

These dataclasses describe the machine the checkpoint planner reasons
about.  The *same* specs drive both executors:

* the **real** executor only uses the topology part (which ranks live on
  which node, who the active backends are);
* the **sim** executor additionally uses the performance part (bandwidths,
  metadata capacity, lock-contention constants) to price a FlushPlan at
  Theta-like scale.

Performance constants are calibrated so that the simulated micro-benchmark
reproduces the *relative* behaviour of the paper's Figures 1-2 (see
EXPERIMENTS.md); they are not meant to be an exact digital twin of Theta.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
from typing import List, Optional, Sequence


@dataclass(frozen=True)
class PFSSpec:
    """A Lustre-like parallel file system.

    A file is striped round-robin in `stripe_size` chunks over
    `stripe_count` of the `n_io_servers` object storage targets (OSTs).
    Writes from different clients into the same file+OST object suffer
    extent-lock ping-pong ("false sharing" in the paper's terminology);
    `lock_switch_penalty`/`lock_conflict_alpha` price that.  Metadata
    operations (file create/open per client) are served by a single
    metadata server with bounded throughput.
    """

    n_io_servers: int = 48
    server_bw: float = 4.5e9           # B/s per OST
    stripe_size: int = 1 << 20         # 1 MiB (Lustre default)
    stripe_count: int = 48             # OSTs a single file is striped over
    server_latency: float = 0.5e-3     # per-request latency (s)
    max_conc_per_server: int = 8       # streams an OST overlaps efficiently
    lock_switch_penalty: float = 0.5e-3  # extent-lock revocation cost (s)
    client_stream_bw: float = 3.0e9    # single client stream ceiling (B/s)
    md_latency: float = 0.8e-3         # base metadata op latency (s)
    md_ops_per_sec: float = 12_000.0   # metadata server capacity

    @property
    def aggregate_bw(self) -> float:
        return self.n_io_servers * self.server_bw

    def n_stripes(self, nbytes: int) -> int:
        return -(-int(nbytes) // self.stripe_size)

    def stripe_of(self, offset: int) -> int:
        return int(offset) // self.stripe_size

    def server_of_stripe(self, stripe: int) -> int:
        return stripe % min(self.stripe_count, self.n_io_servers)


@dataclass(frozen=True)
class NodeSpec:
    """A compute node (Theta: Cray XC40 KNL node w/ local SSD + Aries NIC)."""

    local_bw: float = 2.1e9    # node-local SSD sequential write B/s
    local_read_bw: float = 2.4e9
    mem_bw: float = 16.0e9     # effective tmpfs/memcpy B/s (in-memory tier)
    nic_bw: float = 8.0e9      # injection bandwidth B/s
    cores: int = 64
    # Fraction of NIC the application claims while computing; the async
    # flush competes for the rest (Tseng et al. interference trade-off).
    app_net_load: float = 0.0


@dataclass(frozen=True)
class ClusterSpec:
    """The checkpointing cluster: nodes x processes-per-node + PFS."""

    n_nodes: int
    procs_per_node: int
    node: NodeSpec = NodeSpec()
    pfs: PFSSpec = PFSSpec()
    # Optional per-node background load in [0,1) used by leader election
    # criterion (2) and by the simulator's straggler model.  len == n_nodes.
    node_load: Optional[Sequence[float]] = None
    # Topology coordinate per node (e.g. dragonfly group); proximity is
    # |coord_a - coord_b|.  Defaults to linear placement.
    node_coord: Optional[Sequence[int]] = None

    def __post_init__(self):
        if self.n_nodes <= 0 or self.procs_per_node <= 0:
            raise ValueError("n_nodes and procs_per_node must be positive")
        if self.node_load is not None and len(self.node_load) != self.n_nodes:
            raise ValueError("node_load must have n_nodes entries")
        if self.node_coord is not None and len(self.node_coord) != self.n_nodes:
            raise ValueError("node_coord must have n_nodes entries")

    @property
    def world_size(self) -> int:
        return self.n_nodes * self.procs_per_node

    def node_of_rank(self, rank: int) -> int:
        return rank // self.procs_per_node

    def nodes_of_ranks(self, ranks) -> np.ndarray:
        """Vectorized :meth:`node_of_rank` over an int array."""
        return np.asarray(ranks, dtype=np.int64) // self.procs_per_node

    def ranks_of_node(self, node: int) -> List[int]:
        base = node * self.procs_per_node
        return list(range(base, base + self.procs_per_node))

    def load_of(self, node: int) -> float:
        if self.node_load is None:
            return 0.0
        return float(self.node_load[node])

    def loads(self) -> np.ndarray:
        """Per-node background load as a float64 vector (len n_nodes)."""
        if self.node_load is None:
            return np.zeros(self.n_nodes)
        return np.asarray(self.node_load, dtype=np.float64)

    def coord_of(self, node: int) -> int:
        if self.node_coord is None:
            return node
        return int(self.node_coord[node])

    def coords(self) -> np.ndarray:
        """Per-node topology coordinate as an int64 vector (len n_nodes)."""
        if self.node_coord is None:
            return np.arange(self.n_nodes, dtype=np.int64)
        return np.asarray(self.node_coord, dtype=np.int64)

    def with_(self, **kw) -> "ClusterSpec":
        return dataclasses.replace(self, **kw)


def theta_like(
    n_nodes: int,
    procs_per_node: int,
    *,
    local_tier: str = "mem",
    **node_kw,
) -> ClusterSpec:
    """The testbed used in the paper's evaluation (Theta, Cray XC40+Lustre).

    ``local_tier='mem'`` checkpoints to the in-memory tier (tmpfs on KNL
    DDR4) — the configuration behind the paper's Fig. 1 "orders of
    magnitude faster than GIO" observation; ``'ssd'`` models the node
    SSDs instead.
    """
    if local_tier == "mem":
        node_kw.setdefault("local_bw", 16.0e9)
        node_kw.setdefault("local_read_bw", 16.0e9)
    elif local_tier != "ssd":
        raise ValueError(f"unknown local_tier {local_tier!r}")
    return ClusterSpec(
        n_nodes=n_nodes,
        procs_per_node=procs_per_node,
        node=NodeSpec(**node_kw),
        pfs=PFSSpec(),
    )
