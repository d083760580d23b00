"""Multi-tenant checkpoint control plane.

Public surface:

* :class:`~repro_torch.control.plane.ControlPlane` — register/attach jobs,
  list/pin steps, per-tenant GC policy, cross-geometry restore, and the
  shared arbitration runtime (bandwidth quotas, admission, breaker).
* :class:`~repro_torch.core.admission.AdmissionController` — the cluster-wide
  pending-flush budget with priority preemption (re-exported; it lives
  in ``core`` so the engine can default to a private instance).
* :class:`~repro_torch.core.storage.FairShareLimiter` /
  :func:`~repro_torch.core.storage.fair_share_rates` — the hierarchical
  token-bucket quota layer (re-exported from ``core.storage``).
"""
from repro_torch.control.plane import ControlPlane, JobRecord
from repro_torch.core.admission import AdmissionController
from repro_torch.core.storage import (
    FairShareLimiter,
    TenantLimiter,
    fair_share_rates,
)

__all__ = [
    "ControlPlane",
    "JobRecord",
    "AdmissionController",
    "FairShareLimiter",
    "TenantLimiter",
    "fair_share_rates",
]
