"""The port's flush simulator: the paper's Figure 1/2 claims hold
qualitatively (the cases of ``tests/test_sim.py``), and every price
equals the JAX package's exactly.

``scan_time`` and every other field of a :class:`SimReport` is modelled,
not a wall clock, so the port's ``SimReport.row()`` is held equal to
``repro``'s field for field with tolerance zero: for the five strategies
on the Figure 1/2 cluster, and for ``simulate_flush_shared`` with 2 and
3 tenants under a cap that binds.
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest

import repro.core as R
import repro_torch.core as T
from repro_torch.core import make_plan, simulate_flush, simulate_flush_shared, theta_like

GiB = 1 << 30
MiB = 1 << 20

STRATEGY_KW = [
    ("file_per_process", {}),
    ("posix", {}),
    ("mpiio", {"chunk_stripes": 64}),
    ("stripe_aligned", {"pipeline_chunk": 256 << 20}),
    ("gio_sync", {"chunk_stripes": 64}),
]


def _fig_reports(pkg):
    c = pkg.theta_like(32, 8)
    sizes = [GiB] * c.world_size
    return {
        strat: pkg.simulate_flush(pkg.make_plan(strat, c, sizes, **kw), io_threads=4)
        for strat, kw in STRATEGY_KW
    }


@pytest.fixture(scope="module")
def reports():
    return _fig_reports(T)


def test_fig1_local_phase(reports):
    # aggregation leaves the local phase unchanged (prefix sum ~ free)
    base = reports["file_per_process"].local_time
    for s in ("posix", "mpiio", "stripe_aligned"):
        assert reports[s].local_time == pytest.approx(base, rel=0.05)
    # GIO writes synchronously to the PFS: much slower local phase
    assert reports["gio_sync"].local_time > 4 * base


def test_fig2_flush_ordering(reports):
    fpp = reports["file_per_process"].flush_bw
    # false sharing collapses POSIX aggregation (paper: §2.1)
    assert reports["posix"].flush_bw < 0.5 * fpp
    assert reports["posix"].pfs_lock_eff < 0.5
    # MPI-IO collective rounds underperform (paper: §2.2)
    assert reports["mpiio"].flush_bw < 0.8 * fpp
    # the §3 proposal is within 10% of embarrassingly-parallel flush
    assert reports["stripe_aligned"].flush_bw > 0.85 * fpp
    assert reports["stripe_aligned"].pfs_lock_eff > 0.99


def test_s3_aggregation_wins_on_metadata(reports):
    assert reports["stripe_aligned"].n_files == 1
    assert reports["file_per_process"].n_files == 256
    assert (
        reports["stripe_aligned"].metadata_ops
        < reports["file_per_process"].metadata_ops / 5
    )


def test_io_threads_tradeoff():
    # Tseng et al.: more flush threads -> more app slowdown
    c = theta_like(8, 4)
    plan = make_plan("stripe_aligned", c, [GiB] * 32)
    slow = [simulate_flush(plan, io_threads=t).app_slowdown for t in (1, 4, 8)]
    assert slow[0] < slow[1] < slow[2]


def test_straggler_derates_node():
    c = theta_like(8, 2)
    sizes = [GiB] * 16
    base = simulate_flush(make_plan("file_per_process", c, sizes)).flush_time
    c2 = c.with_(node_load=[0.8] + [0.0] * 7)
    slow = simulate_flush(make_plan("file_per_process", c2, sizes)).flush_time
    assert slow > 1.5 * base  # straggler dominates the unmitigated flush


def test_interference_shrinks_effective_nic():
    c = theta_like(8, 4)
    c = c.with_(node=dataclasses.replace(c.node, app_net_load=0.6))
    sizes = [GiB] * 32
    busy = simulate_flush(make_plan("file_per_process", c, sizes))
    quiet = simulate_flush(make_plan("file_per_process", theta_like(8, 4), sizes))
    assert busy.flush_time > quiet.flush_time


# ---------------------------------------------------------------------------
# Cross-package: equal reports, field for field
# ---------------------------------------------------------------------------


def test_reports_equal_jax_for_every_strategy(reports):
    ref = _fig_reports(R)
    assert sorted(reports) == sorted(ref)
    for strat in reports:
        got, want = reports[strat].row(), ref[strat].row()
        assert got == want, strat
        assert reports[strat].per_backend_finish == ref[strat].per_backend_finish, strat


def _tenant_plans(pkg, strategies):
    c = pkg.theta_like(8, 4)
    plans = []
    for i, strat in enumerate(strategies):
        sizes = [(64 + 16 * i) * MiB + 4096 * r for r in range(c.world_size)]
        plans.append(pkg.make_plan(strat, c, sizes))
    return plans


@pytest.mark.parametrize("strategies,weights", [
    (("stripe_aligned", "posix"), (1.0, 1.0)),
    (("stripe_aligned", "file_per_process", "mpiio"), (4.0, 1.0, 2.0)),
], ids=["2-tenants-1:1", "3-tenants-4:1:2"])
def test_shared_flush_prices_equal_jax(strategies, weights):
    plans = _tenant_plans(T, strategies)
    rplans = _tenant_plans(R, strategies)
    # a cap well under the tenants' unthrottled demand, so the quota binds
    demand = sum(simulate_flush(p).flush_bw for p in plans)
    cap = demand / 4
    got = simulate_flush_shared(plans, flush_bw_cap=cap, weights=list(weights))
    want = R.simulate_flush_shared(rplans, flush_bw_cap=cap, weights=list(weights))
    assert len(got) == len(want) == len(plans)
    for g, w in zip(got, want):
        assert g.flush_bw_cap > 0          # priced at its granted share
        assert g.row() == w.row()
    assert sum(g.flush_bw_cap for g in got) == pytest.approx(cap)
