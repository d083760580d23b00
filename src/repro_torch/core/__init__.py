"""Aggregated asynchronous multi-level checkpointing (the paper's core),
on PyTorch. Counterpart of ``repro.core``.

Public API:

* :class:`~repro_torch.core.engine.CheckpointManager` — multi-level async
  checkpointing with pluggable aggregation, with the device pre-codec on CUDA.
* :func:`~repro_torch.core.strategies.make_plan` — build a FlushPlan from a
  strategy name (``file_per_process`` | ``posix`` | ``mpiio`` |
  ``stripe_aligned`` | ``gio_sync``).
* :func:`~repro_torch.core.sim.simulate_flush` — price a plan on the modeled
  Theta-like machine (benchmark harness).
"""
from repro_torch.core.admission import AdmissionController
from repro_torch.core.cluster import ClusterSpec, NodeSpec, PFSSpec, theta_like
from repro_torch.core.engine import (
    CheckpointConfig,
    CheckpointManager,
    L1CapacityError,
    ManagerHealth,
    SaveStats,
)
from repro_torch.core.faults import FaultPlan, FaultSpec
from repro_torch.core.repair import RepairReport, repair_step
from repro_torch.core.plan import (
    FileLayout,
    FlushPlan,
    PlanArrays,
    ReadColumns,
    ReadPlan,
    SendColumns,
    SendItem,
    WriteColumns,
    WriteItem,
    assign_readers,
    build_read_plan,
    count_false_sharing,
    merge_intervals,
    stored_space_offsets,
    validate_plan,
    validate_plan_reference,
    validate_read_plan,
)
from repro_torch.core.prefix_sum import (
    LeaderAssignment,
    ScanResult,
    elect_leaders,
    exclusive_prefix_sum,
    piggybacked_scan,
)
from repro_torch.core.serialize import (
    ChunkTable,
    EncodedState,
    Manifest,
    Placement,
    decode_state,
    decode_stream,
    default_codec_impl,
    encode_state,
    serialize_tree,
)
from repro_torch.core.sim import (
    FlushSimulator,
    SimReport,
    simulate_flush,
    simulate_flush_shared,
)
from repro_torch.core.storage import (
    CancelToken,
    CircuitOpenError,
    DomainHealth,
    FairShareLimiter,
    FlushCancelled,
    FlushJournal,
    FlushResult,
    HedgePolicy,
    LocalStore,
    MissingBlobError,
    RealExecutor,
    RetryPolicy,
    StorageError,
    StorageHealth,
    TenantLimiter,
    TokenBucket,
    classify_error,
    fair_share_rates,
)
from repro_torch.core.strategies import STRATEGIES, make_plan

__all__ = [
    "AdmissionController",
    "ClusterSpec",
    "NodeSpec",
    "PFSSpec",
    "theta_like",
    "CheckpointConfig",
    "CheckpointManager",
    "L1CapacityError",
    "ManagerHealth",
    "SaveStats",
    "FileLayout",
    "FlushPlan",
    "PlanArrays",
    "ReadColumns",
    "ReadPlan",
    "SendColumns",
    "SendItem",
    "WriteColumns",
    "WriteItem",
    "assign_readers",
    "build_read_plan",
    "merge_intervals",
    "stored_space_offsets",
    "validate_plan",
    "validate_plan_reference",
    "validate_read_plan",
    "count_false_sharing",
    "ChunkTable",
    "EncodedState",
    "Manifest",
    "Placement",
    "decode_state",
    "decode_stream",
    "default_codec_impl",
    "encode_state",
    "serialize_tree",
    "FlushSimulator",
    "SimReport",
    "simulate_flush",
    "simulate_flush_shared",
    "LeaderAssignment",
    "ScanResult",
    "elect_leaders",
    "exclusive_prefix_sum",
    "piggybacked_scan",
    "CancelToken",
    "CircuitOpenError",
    "DomainHealth",
    "FairShareLimiter",
    "FlushCancelled",
    "FlushJournal",
    "FlushResult",
    "HedgePolicy",
    "LocalStore",
    "MissingBlobError",
    "RealExecutor",
    "RetryPolicy",
    "StorageError",
    "StorageHealth",
    "TenantLimiter",
    "TokenBucket",
    "classify_error",
    "fair_share_rates",
    "FaultPlan",
    "FaultSpec",
    "RepairReport",
    "repair_step",
    "STRATEGIES",
    "make_plan",
]
