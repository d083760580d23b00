"""The port's degraded-mode availability runtime: circuit breaker,
parking, backpressure, hedged reads (the cases of
``tests/test_degraded_mode.py`` through ``repro_torch.core``, with
``device="cpu"`` managers).

The acceptance surface:

* the :class:`StorageHealth` circuit breaker transitions exactly per
  its fault schedule (injectable clock — no wall-clock scheduling);
* a PFS outage never fails a ``save()`` and never burns a retry
  budget to a giveup: flushes *park* at ``flush_partial`` with their
  journals intact while saves keep landing on L0/L1;
* once the outage heals, the parked backlog auto-drains and every
  step restores byte-identically — on all five strategies;
* the L1 byte budget applies backpressure by evicting the oldest
  non-pinned step, and raises :class:`L1CapacityError` (before any
  byte is written) only when nothing is evictable;
* hedged reads cut the restore tail under a straggler reader and are
  harmless when the hedge loses the race (or has no alternate copy);
* ``TokenBucket.acquire`` sleeps the computed deficit, not fixed
  poll slices;
* the serve fleet's ``stop()`` never silently discards a live
  follower, and its follower defers adoption while the manager
  reports itself degraded.
"""
import errno
import functools
import threading
import time

import numpy as np
import pytest

from repro_torch.core import (
    CheckpointConfig,
    CheckpointManager,
    CircuitOpenError,
    FaultPlan,
    FaultSpec,
    L1CapacityError,
    RetryPolicy,
    StorageHealth,
    TokenBucket,
    theta_like,
)
from repro_torch.core.plan import PlanError, assign_readers

cpu_config = functools.partial(CheckpointConfig, device="cpu")
ALL_STRATEGIES = ["file_per_process", "posix", "mpiio", "stripe_aligned", "gio_sync"]


def state(step, kib=64):
    rng = np.random.default_rng(step)
    return {
        "w": rng.standard_normal((kib * 1024 // 8 // 2, 2)).astype(np.float64),
        "b": np.full((32,), step, np.float32),
    }


def trees_equal(a, b):
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def make_mgr(tmp_path, **kw):
    faults = kw.pop("_faults", None)
    kw.setdefault("cluster", theta_like(2, 2))
    kw.setdefault("async_flush", False)
    cfg = cpu_config(root=str(tmp_path / "ckpt"), **kw)
    return CheckpointManager(cfg, faults=faults)


def forget_memory(mgr):
    mgr._l0 = None
    mgr._last_full = None


class FakeClock:
    def __init__(self, t=100.0):
        self.t = float(t)

    def __call__(self):
        return self.t


# ---------------------------------------------------- circuit transitions


def test_circuit_trips_on_window_error_rate():
    clk = FakeClock()
    sh = StorageHealth(min_ops=4, error_threshold=0.5, cooldown=10.0, clock=clk)
    # below min_ops: errors accumulate but never trip
    for _ in range(3):
        sh.record("pfs", False)
        assert sh.state("pfs") == "closed"
    sh.record("pfs", False)  # 4th error: rate 1.0 over >= min_ops
    assert sh.state("pfs") == "open"
    assert sh.trips == 1
    with pytest.raises(CircuitOpenError) as ei:
        sh.check("pfs")
    assert ei.value.errno == errno.EHOSTDOWN
    assert ei.value.domain == "pfs"
    assert 0 < ei.value.retry_in <= 10.0
    # a healthy domain is untouched
    sh.check("l1:n0")
    assert sh.state("l1:n0") == "closed"


def test_circuit_successes_dilute_error_rate():
    sh = StorageHealth(min_ops=4, error_threshold=0.5, clock=FakeClock())
    for ok in (True, True, True, False, True, False, True, True):
        sh.record("pfs", ok)
    assert sh.state("pfs") == "closed"  # 2/8 = 0.25 < 0.5


def test_circuit_half_open_probe_admission_and_close():
    clk = FakeClock()
    sh = StorageHealth(
        min_ops=2, cooldown=5.0, probe_successes=2, probe_parallel=2, clock=clk
    )
    sh.record("pfs", False)
    sh.record("pfs", False)
    assert sh.state("pfs") == "open"
    with pytest.raises(CircuitOpenError):
        sh.check("pfs")
    clk.t += 5.0  # cooldown elapsed: probes admitted
    assert sh.state("pfs") == "half_open"
    sh.check("pfs")  # probe 1 admitted
    sh.check("pfs")  # probe 2 admitted
    with pytest.raises(CircuitOpenError):
        sh.check("pfs")  # probe_parallel exhausted
    sh.record("pfs", True)
    assert sh.state("pfs") == "half_open"  # 1 of probe_successes
    sh.record("pfs", True)
    assert sh.state("pfs") == "closed"
    sh.check("pfs")  # and ops flow freely again


def test_circuit_failed_probe_reopens_with_fresh_cooldown():
    clk = FakeClock()
    sh = StorageHealth(min_ops=2, cooldown=5.0, clock=clk)
    sh.record("pfs", False)
    sh.record("pfs", False)
    clk.t += 5.0
    sh.check("pfs")  # admitted as probe
    sh.record("pfs", False)  # probe fails
    assert sh.state("pfs") == "open"
    assert sh.trips == 2
    with pytest.raises(CircuitOpenError) as ei:
        sh.check("pfs")
    assert ei.value.retry_in == pytest.approx(5.0)  # cooldown restarted


def test_circuit_opens_immediately_on_giveup():
    sh = StorageHealth(min_ops=64, clock=FakeClock())
    sh.record("pfs", False, giveup=True)
    assert sh.state("pfs") == "open"
    sh2 = StorageHealth(min_ops=64, open_on_giveup=False, clock=FakeClock())
    sh2.record("pfs", False, giveup=True)
    assert sh2.state("pfs") == "closed"


def test_retry_layer_feeds_health_but_never_enoent():
    """FileNotFoundError is a correct answer from a healthy medium
    (the restore ladder probes levels with it constantly) — it must
    not charge the circuit."""
    sh = StorageHealth(min_ops=2, clock=FakeClock())
    pol = RetryPolicy(attempts=3, base_delay=0.001, max_delay=0.002, seed=0)
    pol.health = sh

    def gone():
        raise FileNotFoundError(errno.ENOENT, "probe miss")

    for _ in range(8):
        with pytest.raises(FileNotFoundError):
            pol.run(gone, domain="pfs")
    snap = sh.snapshot()
    assert snap.get("pfs") is None or snap["pfs"].errors == 0
    assert sh.state("pfs") == "closed"
    # a genuinely permanent error IS recorded
    with pytest.raises(OSError):
        pol.run(
            lambda: (_ for _ in ()).throw(OSError(errno.ENOSPC, "full")),
            domain="pfs",
        )
    assert sh.snapshot()["pfs"].errors == 1


def test_open_circuit_fails_fast_without_running_the_op():
    sh = StorageHealth(min_ops=2, cooldown=60.0, clock=FakeClock())
    sh.record("pfs", False)
    sh.record("pfs", False)
    pol = RetryPolicy(attempts=5, base_delay=0.001, seed=0)
    pol.health = sh
    calls = {"n": 0}

    def op():
        calls["n"] += 1
        return "ok"

    with pytest.raises(CircuitOpenError):
        pol.run(op, domain="pfs")
    assert calls["n"] == 0, "check() must gate before the attempt"
    assert pol.giveups == 0 and pol.retries == 0


# ------------------------------------------------ outage -> park -> drain


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
def test_outage_parks_then_drains_byte_identical(tmp_path, strategy):
    """A PFS outage across two sync saves: no save fails, no retry
    budget gives up, both steps park at flush_partial and stay
    L1-restorable; after heal the backlog drains byte-identically."""
    faults = FaultPlan(
        [FaultSpec(kind="outage", domain="pfs", op="write", index=0, count=10**9)]
    )
    mgr = make_mgr(
        tmp_path, strategy=strategy, _faults=faults,
        retry_attempts=5, retry_base_delay=0.001, retry_max_delay=0.002,
        health_min_ops=2, health_cooldown=0.05,
    )
    mgr.faults.arm("save")
    try:
        for s in (1, 2):
            st = mgr.save(s, state(s))
            assert st.flush is None, f"{strategy}: parked save must not flush"
        h = mgr.health()
        assert h.mode == "degraded"
        assert h.parked_steps == [1, 2]
        assert h.degraded_since is not None
        assert h.circuits["pfs"] in ("open", "half_open")
        assert mgr.flush_errors == []
        assert mgr.retry.giveups == 0
        assert mgr.storage_health.snapshot()["pfs"].giveups == 0
        assert mgr.steps("pfs") == []
        assert mgr.steps("local") == [1, 2]
        assert mgr.step_status(2) == "flush_partial"
        # parked steps restore from L1 during the outage
        forget_memory(mgr)
        s, tree = mgr.restore(state(2))
        assert s == 2 and trees_equal(tree, state(2))
        # heal -> the public health surface probes and drains
        faults.heal()
        faults.disarm()
        deadline = time.monotonic() + 30
        while mgr.health().parked_steps and time.monotonic() < deadline:
            mgr.health_check()
            time.sleep(0.01)
        h = mgr.health()
        assert h.parked_steps == []
        assert h.mode == "normal"
        assert h.drained_steps == 2
        assert mgr.flush_errors == []
        assert mgr.steps("pfs") == [1, 2]
    finally:
        mgr.close()
    # byte-identical from the PFS alone: fresh manager, no L0, no L1
    m2 = make_mgr(tmp_path, strategy=strategy)
    try:
        m2.local.drop_node(0)
        m2.local.drop_node(1)
        for s in (1, 2):
            got, tree = m2.restore(state(s), step=s)
            assert got == s and trees_equal(tree, state(s))
    finally:
        m2.close()


def test_outage_async_scheduler_parks_and_auto_drains(tmp_path):
    """Async manager: the flush scheduler parks jobs while the circuit
    is open and drains them on its own idle ticks after heal — no
    explicit resume_flushes()/health_check() calls."""
    faults = FaultPlan(
        [FaultSpec(kind="outage", domain="pfs", op="write", index=0, count=10**9)]
    )
    mgr = make_mgr(
        tmp_path, strategy="posix", async_flush=True, _faults=faults,
        retry_attempts=5, retry_base_delay=0.001, retry_max_delay=0.002,
        health_min_ops=2, health_cooldown=0.05, health_tick=0.05,
        max_pending_flushes=4,
    )
    mgr.faults.arm("save")
    try:
        for s in (1, 2, 3):
            mgr.save(s, state(s))
        deadline = time.monotonic() + 30
        while (
            len(mgr.health().parked_steps) < 3 and time.monotonic() < deadline
        ):
            time.sleep(0.01)
        h = mgr.health()
        assert h.parked_steps == [1, 2, 3]
        assert h.mode == "degraded"
        assert mgr.flush_errors == []
        assert mgr.retry.giveups == 0
        faults.heal()
        faults.disarm()
        deadline = time.monotonic() + 30
        while mgr.steps("pfs") != [1, 2, 3] and time.monotonic() < deadline:
            time.sleep(0.02)
        assert mgr.steps("pfs") == [1, 2, 3]
        assert mgr.flush_errors == []
        assert mgr.retry.giveups == 0
        h = mgr.health()
        assert h.mode == "normal" and h.parked_steps == []
        forget_memory(mgr)
        mgr.local.drop_node(0)
        mgr.local.drop_node(1)
        s, tree = mgr.restore(state(3))
        assert s == 3 and trees_equal(tree, state(3))
    finally:
        mgr.close()


def test_auto_resume_drains_leftover_partial_on_construction(tmp_path):
    """A flush_partial left by a crashed/failed run finishes during
    construction when auto_resume=True — no explicit call."""
    faults = FaultPlan(
        [FaultSpec(kind="enospc", domain="pfs", op="write", index=1)]
    )
    mgr = make_mgr(tmp_path, strategy="posix", _faults=faults)
    mgr.faults.arm("save")
    try:
        with pytest.raises(OSError):
            mgr.save(1, state(1))
        assert 1 not in mgr.steps("pfs")
        assert mgr.step_status(1) == "flush_partial"
    finally:
        mgr.close()
    m2 = make_mgr(tmp_path, strategy="posix", auto_resume=True)
    try:
        assert m2.steps("pfs") == [1]
        assert m2.step_status(1) == "flush_done"
        forget_memory(m2)
        m2.local.drop_node(0)
        m2.local.drop_node(1)
        s, tree = m2.restore(state(1))
        assert s == 1 and trees_equal(tree, state(1))
    finally:
        m2.close()


# ------------------------------------------------------- L1 backpressure


def _one_step_l1_cost(tmp_path):
    probe = make_mgr(tmp_path / "probe", strategy="posix")
    try:
        probe.save(0, state(0))
        return probe.health().l1_bytes
    finally:
        probe.close()


def test_l1_budget_evicts_oldest_keeps_pfs_intact(tmp_path):
    cost = _one_step_l1_cost(tmp_path)
    assert cost > 0
    mgr = make_mgr(
        tmp_path, strategy="posix",
        l1_capacity_bytes=int(cost * 3) + 256,
    )
    try:
        for s in range(6):
            mgr.save(s, state(s))
        h = mgr.health()
        assert h.l1_bytes <= h.l1_capacity
        assert h.evicted_steps, "over-budget saves must evict"
        assert min(h.evicted_steps) == 0, "victims are oldest-first"
        # every step still flushed: eviction never loses PFS data
        assert mgr.steps("pfs") == list(range(6))
        assert mgr.flush_errors == []
        # an evicted step restores from the PFS copy
        forget_memory(mgr)
        s, tree = mgr.restore(state(0), step=0)
        assert s == 0 and trees_equal(tree, state(0))
    finally:
        mgr.close()


def test_l1_budget_raises_before_writing_when_all_pinned(tmp_path):
    cost = _one_step_l1_cost(tmp_path)
    mgr = make_mgr(
        tmp_path, strategy="posix", keep_n=8,
        l1_capacity_bytes=int(cost * 2) + 256,
    )
    try:
        mgr.save(1, state(1))
        mgr.save(2, state(2))
        with pytest.raises(L1CapacityError) as ei:
            mgr.save(3, state(3))
        assert "L1 budget" in str(ei.value)
        # nothing of step 3 landed anywhere
        assert 3 not in mgr.steps("local")
        assert 3 not in mgr.steps("pfs")
        # and the resident steps are untouched
        forget_memory(mgr)
        s, tree = mgr.restore(state(2))
        assert s == 2 and trees_equal(tree, state(2))
    finally:
        mgr.close()


def test_l1_budget_never_evicts_delta_anchor(tmp_path):
    """Under zstd+delta the full-snapshot anchor must survive
    eviction pressure — evicting it would strand every delta built
    on it."""
    cost = _one_step_l1_cost(tmp_path)
    mgr = make_mgr(
        tmp_path, codec="zstd+delta", delta_every=4, chunk_size=4096,
        l1_capacity_bytes=int(cost * 3) + 256,
    )
    try:
        for s in range(1, 4):  # 1 = full anchor, 2..3 deltas
            mgr.save(s, state(s))
        assert 1 not in mgr.health().evicted_steps
        forget_memory(mgr)
        s, tree = mgr.restore(state(3))
        assert s == 3 and trees_equal(tree, state(3))
    finally:
        mgr.close()


# ---------------------------------------------------------- hedged reads


def test_hedged_restore_beats_straggler_reader(tmp_path):
    """One straggler reader node slows every PFS pread it runs; the
    hedge re-issues those extents from L1 and the restore finishes
    without waiting out the straggler."""
    mgr = make_mgr(tmp_path, strategy="posix")
    mgr.save(1, state(1))
    mgr.close()

    delay = 0.15
    faults = FaultPlan(
        [FaultSpec(kind="straggler", domain="pfs", op="read", node=1,
                   delay=delay, phase="verify")]
    )
    # unhedged: the plan waits out every slowed pread
    m_plain = make_mgr(tmp_path, strategy="posix", _faults=faults)
    try:
        faults.arm("verify")
        t0 = time.perf_counter()
        s, tree = m_plain.restore(state(1))
        t_plain = time.perf_counter() - t0
        assert s == 1 and trees_equal(tree, state(1))
    finally:
        m_plain.close()
    assert t_plain >= delay * 0.9

    m_hedge = make_mgr(
        tmp_path, strategy="posix", _faults=faults,
        hedged_reads=True, hedge_min_delay=0.01,
    )
    try:
        faults.arm("verify")
        t0 = time.perf_counter()
        s, tree = m_hedge.restore(state(1))
        t_hedge = time.perf_counter() - t0
        assert s == 1 and trees_equal(tree, state(1))
        rr = m_hedge.last_read_result
        assert rr is not None and rr.hedges_issued > 0
        assert rr.hedge_wins > 0, "the L1 hedge must beat the straggler"
        assert t_hedge < t_plain
    finally:
        m_hedge.close()


def test_hedge_losing_the_race_is_harmless(tmp_path):
    """With the L1 copies gone the hedge has no alternate source —
    issued hedges all lose, and the plan still completes correctly
    from the (slow) primary reads."""
    mgr = make_mgr(tmp_path, strategy="posix")
    mgr.save(1, state(1))
    mgr.close()

    faults = FaultPlan(
        [FaultSpec(kind="straggler", domain="pfs", op="read", node=1,
                   delay=0.08, phase="verify")]
    )
    m2 = make_mgr(
        tmp_path, strategy="posix", _faults=faults,
        hedged_reads=True, hedge_min_delay=0.01,
    )
    try:
        m2.local.drop_node(0)
        m2.local.drop_node(1)
        faults.arm("verify")
        s, tree = m2.restore(state(1))
        assert s == 1 and trees_equal(tree, state(1))
        rr = m2.last_read_result
        assert rr is not None and rr.hedge_wins == 0
    finally:
        m2.close()


def test_reader_weights_demote_straggler_node(tmp_path):
    mgr = make_mgr(tmp_path, strategy="posix", hedged_reads=True)
    try:
        assert mgr._reader_weights() is None  # no history yet
        sh = mgr.storage_health
        for _ in range(8):
            sh.note_latency("reader:n0", 0.25)
            sh.note_latency("reader:n1", 0.01)
        w = mgr._reader_weights()
        assert w is not None
        assert w[0] < w[1], "the slow reader must get less space"
    finally:
        mgr.close()


def test_assign_readers_weights_identity_and_skew():
    sizes = np.asarray([100, 100, 100, 100, 100, 100], np.int64)
    base = assign_readers(sizes, 2)
    # None and all-equal weights are byte-identical to unweighted
    assert np.array_equal(assign_readers(sizes, 2, weights=[3.0, 3.0]), base)
    # a demoted reader 0 takes a strictly smaller share
    skew = assign_readers(sizes, 2, weights=[0.2, 1.0])
    assert (skew == 0).sum() < (base == 0).sum()
    with pytest.raises(PlanError):
        assign_readers(sizes, 2, weights=[1.0])  # wrong length
    with pytest.raises(PlanError):
        assign_readers(sizes, 2, weights=[1.0, -1.0])  # non-positive


# ------------------------------------------------------------ TokenBucket


def test_token_bucket_sleeps_computed_deficit_not_poll_slices():
    rate = 4_000_000.0
    tb = TokenBucket(rate, burst=1_000_000)
    assert tb.acquire(1_000_000) == 0.0  # burst covers it
    tb.acquire(400_000)  # drives the bucket into debt
    t0 = time.monotonic()
    waited = tb.acquire(1)
    elapsed = time.monotonic() - t0
    # the debt refills in ~0.1 s; the old implementation polled in
    # fixed 0.25 s slices and would oversleep past 0.25 s here
    assert waited == pytest.approx(0.1, abs=0.06)
    assert elapsed < 0.24
    assert tb.wait_total == pytest.approx(waited, rel=0.5)


# --------------------------------------------------------- ManagerHealth


def test_manager_health_surface_normal_mode(tmp_path):
    mgr = make_mgr(tmp_path, strategy="posix")
    try:
        mgr.save(1, state(1))
        h = mgr.health()
        assert h.mode == "normal"
        assert h.queue_depth == 0
        assert h.parked_steps == [] and h.evicted_steps == []
        assert h.l1_bytes > 0 and h.l1_capacity == 0
        assert h.degraded_since is None and h.drained_steps == 0
        assert h.circuits.get("pfs", "closed") == "closed"
    finally:
        mgr.close()


def test_health_disabled_keeps_seed_retry_semantics(tmp_path):
    """health_enabled=False: an outage burns the retry budget and
    fails the flush the old way — no parking, no circuit."""
    faults = FaultPlan(
        [FaultSpec(kind="outage", domain="pfs", op="write", index=0, count=10**9)]
    )
    mgr = make_mgr(
        tmp_path, strategy="posix", _faults=faults, health_enabled=False,
        retry_attempts=3, retry_base_delay=0.001, retry_max_delay=0.002,
    )
    mgr.faults.arm("save")
    try:
        with pytest.raises(OSError):
            mgr.save(1, state(1))
        assert mgr.retry.giveups >= 1
        assert mgr.health().parked_steps == []
    finally:
        mgr.close()


# ------------------------------------------------------------ serve fleet


def test_fleet_stop_raises_on_stuck_follower(tmp_path):
    from repro_torch.serve.fleet import FleetConfig, ServeFleet

    class _Mgr:
        def __init__(self):
            self.release = threading.Event()
            self.entered = threading.Event()

        def steps(self, level):
            self.entered.set()
            self.release.wait(20)  # a wedged PFS listing
            return []

    fm = _Mgr()
    fleet = ServeFleet(
        object(), fm, {"w": np.zeros(3)},
        cfg=FleetConfig(n_servers=1, poll_interval=0.01),
    )
    try:
        fleet.start_follower()
        assert fm.entered.wait(5)
        with pytest.raises(RuntimeError, match="did not stop"):
            fleet.stop(timeout=0.2)
        assert fleet._follower is not None, "live thread must not be dropped"
    finally:
        fm.release.set()
        fleet.close(timeout=10)
    assert fleet._follower is None
    assert fleet.servers == []


def test_fleet_follower_defers_adoption_while_degraded(tmp_path):
    from repro_torch.serve.fleet import FleetConfig, ServeFleet

    class _H:
        def __init__(self, mode):
            self.mode = mode

    class _Mgr:
        def __init__(self):
            self.h = _H("degraded")
            self.steps_calls = 0

        def health(self):
            return self.h

        def steps(self, level):
            self.steps_calls += 1
            return []

    fm = _Mgr()
    fleet = ServeFleet(
        object(), fm, {"w": np.zeros(3)},
        cfg=FleetConfig(n_servers=1, poll_interval=0.01),
    )
    try:
        fleet.start_follower()
        time.sleep(0.2)
        assert fm.steps_calls == 0, "no adoption attempts while degraded"
        fm.h = _H("normal")
        deadline = time.monotonic() + 5
        while fm.steps_calls == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fm.steps_calls > 0, "healthy manager resumes adoption"
    finally:
        fleet.stop(timeout=10)
