"""The port's multi-tenant control plane, on the CPU: arbitration,
quotas, preemption, recovery, and registries and steps shared with the
JAX package's plane.

The cases of ``tests/test_control_plane.py`` run through
``repro_torch.control`` with ``device="cpu"`` planes:

* concurrency stress — ≥ 8 tenants of interleaved save/restore/GC on
  ONE PFS root, per-tenant byte-identical restores, and no
  cross-tenant manifest leakage in ``list_steps``;
* admission preemption — a queued low-priority flush yields its slot
  to a higher-priority tenant, parks journaled/resumable, and still
  reaches ``flush_done``;
* the shared-budget regression (seed bug: per-manager
  ``BoundedSemaphore`` let co-located managers exceed
  ``max_pending_flushes``);
* fair-share bucket properties (hypothesis) and the two-tenant
  sim-vs-real throttle pricing equivalence at the single-job test's
  tolerance;
* registry crash-restart recovery, pins vs GC, shared-breaker outage
  isolation with priority-ordered drain, and the fleet's control-plane
  subscription path (a dense smoke model served through the plane).

Then the cross-package cases: a registry written by
``repro.control.ControlPlane`` is recovered by the port's plane and the
other way round (the same jobs, priorities, weights, ``keep_n``, pins
and steps, ``registry.json`` identical apart from ``created_at``), and
a tenant's step saved through one package's plane restores byte for
byte through the other's ``restore_to_geometry`` on 3x1 with L1 dropped.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import functools
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.control as RC
from repro_torch.control import (
    AdmissionController,
    ControlPlane,
    FairShareLimiter,
    fair_share_rates,
)
from repro_torch.core import (
    CheckpointConfig,
    CheckpointManager,
    ClusterSpec,
    make_plan,
    simulate_flush_shared,
    theta_like,
)
from repro_torch.core.faults import FaultPlan, FaultSpec
from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy
from repro_torch.utils.treelib import flatten_with_names

MiB = 1 << 20

# every plane of this file runs its tenants on the host
cpu_plane = functools.partial(ControlPlane, device="cpu")


def cluster(n_nodes=2, ppn=2):
    return ClusterSpec(n_nodes=n_nodes, procs_per_node=ppn)


def tenant_state(name, step, kb=48):
    """Per-tenant, per-step state whose bytes encode both identities."""
    seed = (hash(name) & 0xFFFF) * 1000 + step
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((kb * 1024 // 8,)).astype(np.float64),
        "s": np.full((16,), step, np.int32),
    }


def trees_equal(a, b):
    return all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a
    )


# ---------------------------------------------------------------------------
# concurrency stress: >= 8 tenants on one root
# ---------------------------------------------------------------------------


def test_eight_tenant_stress_isolated_and_byte_identical(tmp_path):
    n_tenants = 8
    cp = cpu_plane(str(tmp_path), max_pending_flushes=2 * n_tenants)
    strategies = ["posix", "file_per_process", "mpiio", "stripe_aligned"]
    names = [f"team{i}" for i in range(n_tenants)]
    for i, n in enumerate(names):
        cp.register_job(
            n, cluster(), priority=1.0 + (i % 3), keep_n=2,
            strategy=strategies[i % len(strategies)], codec="none",
        )
    errors = []

    def client(name):
        try:
            m = cp.manager(name)
            for s in (1, 2, 3):
                m.save(s, tenant_state(name, s))
                if s == 2:  # interleave a mid-run restore with live flushes
                    got_s, got = m.restore(tenant_state(name, 0))
                    assert trees_equal(got, tenant_state(name, got_s))
            m.wait()
            got_s, got = m.restore(tenant_state(name, 0))
            assert got_s == 3 and trees_equal(got, tenant_state(name, 3))
        except BaseException as e:  # surfaced below, never swallowed
            errors.append((name, e))

    threads = [threading.Thread(target=client, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    for n in names:
        steps = cp.list_steps(n)
        # keep_n=2 GC ran per tenant; the newest steps survive
        assert steps[-1] == 3 and set(steps) <= {1, 2, 3}
        # no cross-tenant leakage: the listing is exactly this
        # tenant's namespace, and its bytes restore to ITS state
        got_s, got = cp.manager(n).restore(tenant_state(n, 0))
        assert got_s == 3 and trees_equal(got, tenant_state(n, 3))
    # every tenant's manifests live under its own subtree only
    for n in names:
        others = set(names) - {n}
        for d in (tmp_path / "jobs" / n).rglob("manifest.json"):
            assert not any(o in str(d.relative_to(tmp_path / "jobs" / n))
                           for o in others)
    cp.close()


# ---------------------------------------------------------------------------
# admission: shared budget + priority preemption
# ---------------------------------------------------------------------------


def test_shared_admission_budget_regression(tmp_path):
    """Seed bug (engine.py `_slots`): two managers, each configured with
    max_pending_flushes=2, could hold 4 slots between them.  Sharing one
    AdmissionController caps the CLUSTER at 2: a third save blocks until
    a slot frees."""
    ac = AdmissionController(2)
    mgrs = []
    for i in range(2):
        cfg = CheckpointConfig(
            root=str(tmp_path / f"m{i}"), cluster=cluster(),
            strategy="posix", codec="none", async_flush=True,
            max_pending_flushes=2, flush_bw_cap=1 * MiB,  # slow drain
            device="cpu",
        )
        mgrs.append(CheckpointManager(cfg, admission=ac, tenant=f"m{i}"))
    try:
        # 2 MiB states exceed the bucket burst, so each flush takes ~1 s
        mgrs[0].save(1, tenant_state("m0", 1, kb=2048))
        mgrs[1].save(1, tenant_state("m1", 1, kb=2048))
        assert ac.held() == 2 and ac.available() == 0
        done = threading.Event()

        def third():
            mgrs[0].save(2, tenant_state("m0", 2, kb=2048))
            done.set()

        t = threading.Thread(target=third)
        t.start()
        # the third save must block on the cluster budget (the seed
        # runtime would have admitted it instantly through m0's own
        # second slot)
        assert not done.wait(0.3)
        assert ac.held() == 2
        t.join(timeout=60)
        assert done.is_set()
    finally:
        for m in mgrs:
            m.close()
    assert ac.held() == 0


def test_priority_preemption_parks_queued_flush_resumably(tmp_path):
    cap = 4 * MiB
    cp = cpu_plane(str(tmp_path), flush_bw_cap=cap, max_pending_flushes=2)
    lo = cp.register_job(
        "lo", cluster(), priority=1.0, strategy="posix", codec="none",
        health_tick=0.05,
    )
    hi = cp.register_job(
        "hi", cluster(), priority=10.0, strategy="posix", codec="none",
        health_tick=0.05,
    )
    try:
        # lo fills the cluster budget: step 1 goes mid-flight (slowed by
        # the cap), step 2 sits queued behind it
        lo.save(1, tenant_state("lo", 1, kb=2048))
        lo.save(2, tenant_state("lo", 2, kb=64))
        assert cp.admission.held() == 2
        t0 = time.perf_counter()
        hi.save(1, tenant_state("hi", 1, kb=64))
        acquired_in = time.perf_counter() - t0
        # hi got its slot by preempting lo's QUEUED step 2 — well before
        # lo's mid-flight multi-second step-1 flush could have finished
        assert cp.admission.preemptions == 1
        assert acquired_in < 2.0
        deadline = time.monotonic() + 30
        while 2 not in lo.health().parked_steps:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert lo.step_status(2) == "flush_partial"  # journaled, resumable
        assert lo.flush_errors == []
        # budget never exceeded
        assert cp.admission.held() <= 2
        # once the burst drains, the parked step auto-resumes to
        # flush_done (budget headroom gates the drain)
        deadline = time.monotonic() + 60
        while lo.step_status(2) != "flush_done":
            assert time.monotonic() < deadline
            time.sleep(0.05)
        lo.wait(), hi.wait()
        got_s, got = cp.manager("lo").restore(tenant_state("lo", 0, kb=64))
        assert got_s == 2 and trees_equal(got, tenant_state("lo", 2, kb=64))
    finally:
        cp.close()


# ---------------------------------------------------------------------------
# fair-share bucket: hypothesis properties + runtime rates
# ---------------------------------------------------------------------------


def test_fair_share_runtime_rates_follow_demand():
    f = FairShareLimiter(100.0)
    a = f.register("a", weight=1.0)
    b = f.register("b", weight=3.0)
    a.add_demand(1)
    assert a.rate == pytest.approx(100.0)  # idle b's share redistributed
    b.add_demand(1)
    assert a.rate == pytest.approx(25.0)
    assert b.rate == pytest.approx(75.0)
    a.sub_demand(1)
    assert b.rate == pytest.approx(100.0)
    f.unregister("a")
    assert f.tenants() == ["b"]


def test_fair_share_acquire_implies_demand():
    f = FairShareLimiter(64 * MiB)
    a = f.register("a")
    f.register("b")
    # no declared backlog: the acquire itself must register demand and
    # proceed at a real rate, not starve on the idle trickle
    t0 = time.perf_counter()
    a.acquire(1 * MiB)
    assert time.perf_counter() - t0 < 5.0
    assert a.rate >= 32 * MiB - 1


try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - optional dep
    HAVE_HYPOTHESIS = False


if HAVE_HYPOTHESIS:

    @settings(max_examples=200, deadline=None)
    @given(
        st.lists(
            st.tuples(
                st.floats(0.01, 100.0),   # weight
                st.floats(0.0, 1e9),      # demand (0 = idle)
            ),
            min_size=1,
            max_size=12,
        ),
        st.floats(1.0, 1e9),              # cap
    )
    def test_fair_share_properties(wd, cap):
        weights = [w for w, _ in wd]
        demands = [d for _, d in wd]
        r = fair_share_rates(weights, demands, cap)
        tol = 1e-6 * max(1.0, cap)
        # granted rates never exceed the cap or the tenant's own demand
        assert r.sum() <= cap + tol
        assert all(ri <= di + tol for ri, di in zip(r, demands))
        # no backlogged tenant starves: each gets >= its weighted share
        # of the cap (or its full demand, whichever is smaller)
        total_w = sum(w for w, d in zip(weights, demands) if d > 0)
        for ri, wi, di in zip(r, weights, demands):
            if di > 0:
                floor = min(di, cap * wi / total_w)
                assert ri >= floor - tol
        # idle tenants take nothing; their share is fully redistributed
        assert all(ri == 0 for ri, di in zip(r, demands) if di == 0)
        assert r.sum() == pytest.approx(
            min(cap, sum(demands)), rel=1e-6, abs=tol
        )


# ---------------------------------------------------------------------------
# sim-vs-real pricing equivalence (two throttled managers, one cap)
# ---------------------------------------------------------------------------


def test_two_tenant_throttle_prices_like_the_sim(tmp_path):
    """Two equal-weight tenants saturating one 8 MiB/s cap must each be
    priced like a single-job flush_bw_cap of 4 MiB/s — by the sim
    (`simulate_flush_shared`) and by the real runtime, within the same
    0.8x tolerance the single-job throttle test uses."""
    cap = 8 * MiB
    # >> the 1 MiB bucket burst, so the fluid sim's burstless price and
    # the real bucket's price converge
    per_tenant_bytes = 8 * MiB
    cp = cpu_plane(str(tmp_path), flush_bw_cap=cap, max_pending_flushes=4)
    c = theta_like(2, 2)
    mgrs = [
        cp.register_job(f"j{i}", c, strategy="posix", codec="none")
        for i in range(2)
    ]
    try:
        state = {"w": np.ones(per_tenant_bytes // 8, np.float64)}
        barrier = threading.Barrier(2)

        def run(m):
            barrier.wait()
            m.save(1, state)
            m.wait()

        threads = [threading.Thread(target=run, args=(m,)) for m in mgrs]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.perf_counter() - t0
        from repro_torch.core import simulate_flush

        stored = [r.stored_size for r in mgrs[0]._manifest_pfs(1).ranks]
        plan = make_plan("posix", c, stored)
        sims = simulate_flush_shared([plan, plan], flush_bw_cap=cap)
        single = simulate_flush(plan, flush_bw_cap=cap / 2)
        for m, sim in zip(mgrs, sims):
            # pricing identity: each saturated equal-weight tenant is
            # priced exactly like a single job capped at its cap/2 share
            assert sim.flush_time == pytest.approx(single.flush_time)
            # the single-job sim test's 0.8x floor, at the granted share
            assert sim.flush_time >= 0.8 * plan.total_bytes / (cap / 2)
            real = m.stats[0].flush
            assert real is not None and real.throttle_wait > 0
            # the real bucket grants a 1 MiB burst and lets the final
            # per-rank charge (total/4) ride as pay-ahead debt; net of
            # that credit the 0.8x floor applies to the wall clock too
            credit = 1 * MiB + plan.total_bytes / 4
            assert real.duration >= (
                0.8 * (plan.total_bytes - credit) / (cap / 2)
            )
        # aggregate: two tenants' bytes through one cap
        assert elapsed >= 0.8 * (2 * plan.total_bytes - 2 * credit) / cap
    finally:
        cp.close()


# ---------------------------------------------------------------------------
# registry: crash-restart recovery, pins, GC policy
# ---------------------------------------------------------------------------


def test_registry_crash_restart_recovery(tmp_path):
    cp = cpu_plane(str(tmp_path), max_pending_flushes=4)
    m = cp.register_job(
        "prod", cluster(), priority=2.0, keep_n=3,
        strategy="stripe_aligned", codec="none",
    )
    for s in (1, 2):
        m.save(s, tenant_state("prod", s))
    m.wait()
    cp.pin("prod", 1)
    cp.close()  # "crash": only the on-disk registry + manifests survive

    cp2 = cpu_plane(str(tmp_path), max_pending_flushes=4)
    assert cp2.jobs() == ["prod"]
    rec = cp2.record("prod")
    assert rec.priority == 2.0 and rec.keep_n == 3
    assert rec.config["strategy"] == "stripe_aligned"
    assert rec.pinned == [1]
    assert cp2.list_steps("prod") == [1, 2]
    m2 = cp2.manager("prod")  # lazily rebuilt from the record
    assert m2.pinned_steps() == [1]
    got_s, got = m2.restore(tenant_state("prod", 0))
    assert got_s == 2 and trees_equal(got, tenant_state("prod", 2))
    cp2.close()


def test_pin_survives_gc_and_unpin_releases(tmp_path):
    cp = cpu_plane(str(tmp_path), max_pending_flushes=4)
    m = cp.register_job(
        "j", cluster(), keep_n=1, strategy="posix", codec="none",
    )
    try:
        m.save(1, tenant_state("j", 1))
        m.wait()
        cp.pin("j", 1)
        for s in (2, 3):
            m.save(s, tenant_state("j", s))
            m.wait()
        assert 1 in cp.list_steps("j")  # keep_n=1 alone would have reaped it
        got_s, got = m.restore(tenant_state("j", 0), 1)
        assert got_s == 1 and trees_equal(got, tenant_state("j", 1))
        cp.unpin("j", 1)
        m.save(4, tenant_state("j", 4))
        m.wait()
        assert 1 not in cp.list_steps("j")
        assert cp.list_steps("j")[-1] == 4
    finally:
        cp.close()


def test_per_tenant_gc_policy(tmp_path):
    cp = cpu_plane(str(tmp_path), max_pending_flushes=8)
    a = cp.register_job("a", cluster(), keep_n=1, strategy="posix",
                        codec="none")
    b = cp.register_job("b", cluster(), strategy="posix", codec="none")
    try:
        for s in (1, 2, 3):
            a.save(s, tenant_state("a", s))
            b.save(s, tenant_state("b", s))
            a.wait(), b.wait()
        assert cp.list_steps("a") == [3]      # keep_n=1
        assert cp.list_steps("b") == [1, 2, 3]  # no GC policy
        cp.set_gc_policy("b", 2)
        b.save(4, tenant_state("b", 4))
        b.wait()
        assert cp.list_steps("b") == [3, 4]
        assert cp.record("b").keep_n == 2  # persisted
    finally:
        cp.close()


# ---------------------------------------------------------------------------
# chaos: shared breaker, tenant isolation, priority drain order
# ---------------------------------------------------------------------------


def test_outage_on_one_tenant_isolates_and_drains_by_priority(tmp_path):
    """PFS outage while tenant A flushes: the SHARED breaker opens (one
    PFS, one truth), so B's flushes park — but B's L1 saves never park,
    never fail, never burn a retry.  After heal, `drain()` publishes
    the higher-priority tenant's parked steps first."""
    # max_index=1 pins the outage to the victim's first PFS write
    plans = FaultPlan.generate_fleet(11, 2, victim=0, outage_ops=10**9,
                                     max_index=1)
    cp = cpu_plane(
        str(tmp_path), max_pending_flushes=8,
        health_min_ops=2, health_cooldown=0.05,
    )
    common = dict(
        strategy="posix", codec="none",
        retry_base_delay=0.001, retry_max_delay=0.002,
        health_min_ops=2, health_cooldown=0.05, health_tick=10.0,
    )
    vic = cp.register_job("victim", cluster(), priority=1.0,
                          faults=plans[0], **common)
    oth = cp.register_job("other", cluster(), priority=5.0,
                          faults=plans[1], **common)
    vic.faults.arm("save")
    done_order = []
    cp.subscribe("victim", lambda s: done_order.append(("victim", s)))
    cp.subscribe("other", lambda s: done_order.append(("other", s)))
    try:
        vic.save(1, tenant_state("victim", 1))
        deadline = time.monotonic() + 30
        while cp.health_state() == "closed":
            assert time.monotonic() < deadline
            time.sleep(0.01)
        # circuit is open for EVERYONE; other's saves still land on L1
        st = oth.save(1, tenant_state("other", 1))
        assert st is not None
        deadline = time.monotonic() + 30
        while not (vic.health().parked_steps and oth.health().parked_steps):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert oth.flush_errors == [] and oth.retry.giveups == 0
        assert oth.health().mode == "degraded"
        # other's state is restorable from L1 during the outage
        got_s, got = oth.restore(tenant_state("other", 0))
        assert got_s == 1 and trees_equal(got, tenant_state("other", 1))
        # heal: the plane drains highest priority first
        plans[0].heal()
        plans[0].disarm()
        deadline = time.monotonic() + 30
        order = None
        while time.monotonic() < deadline:
            order = cp.drain()
            if (vic.step_status(1) == "flush_done"
                    and oth.step_status(1) == "flush_done"):
                break
            time.sleep(0.05)
        assert order == ["other", "victim"]  # priority 5 before 1
        assert done_order[0][0] == "other"
        assert vic.flush_errors == [] and oth.flush_errors == []
        h = cp.health()
        assert h["tenants"]["other"]["mode"] == "normal"
    finally:
        cp.close()


# ---------------------------------------------------------------------------
# serving: fleets subscribe through the plane
# ---------------------------------------------------------------------------


def test_plane_subscription_delivers_tenant_events_only(tmp_path):
    cp = cpu_plane(str(tmp_path), max_pending_flushes=4)
    a = cp.register_job("a", cluster(), strategy="posix", codec="none")
    b = cp.register_job("b", cluster(), strategy="posix", codec="none")
    seen = []
    cp.subscribe("a", lambda s: seen.append(s))
    try:
        a.save(1, tenant_state("a", 1))
        b.save(7, tenant_state("b", 7))
        a.wait(), b.wait()
        assert seen == [1]  # b's step 7 never leaks into a's stream
        fn = seen.append
    finally:
        cp.unsubscribe("a", lambda s: None)  # unknown fn: no-op
        cp.close()


def test_fleet_via_control_plane(tmp_path):
    """ServeFleet resolves its manager and its flush-done subscription
    through the plane — the multi-tenant serving path, serving a dense
    smoke model."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.fleet import FleetConfig, ServeFleet

    cp = cpu_plane(str(tmp_path), max_pending_flushes=4)
    m = cp.register_job("serve-me", cluster(), strategy="posix",
                        codec="none")
    model = get_model(get_smoke_config("tinyllama-1.1b"))

    def params(step):
        return model.init(torch.Generator().manual_seed(step), "cpu").state_tree()

    def state(step):
        return {"params": params(step), "opt": {"t": torch.zeros(4)}}

    m.save(1, state(1))
    m.wait()
    fleet = ServeFleet.via_control_plane(
        model, cp, "serve-me", Transformer(model.cfg, device="meta").state_tree(),
        cfg=FleetConfig(n_servers=1, poll_interval=0.02),
    )
    try:
        cs = fleet.cold_start()
        assert cs.step == 1
        fleet.start_follower()
        assert fleet._plane is cp and fleet._job == "serve-me"
        assert fleet.manager is m
        m.save(2, state(2))
        m.wait()
        deadline = time.monotonic() + 30
        while fleet.current_step != 2:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        want = flatten_with_names(params(2))[0]
        got = flatten_with_names(fleet.servers[0].params)[0]
        assert [n for n, _ in got] == [n for n, _ in want]
        for (n, x), (_, y) in zip(got, want):
            assert torch.equal(x, y), n
        tokens, _, version = fleet.servers[0].generate(
            {"tokens": np.full((1, 4), 3, np.int32)}, with_version=True)
        assert tokens.shape == (1, fleet.servers[0].cfg.max_new_tokens)
        assert version == 1                   # served from the swapped step
    finally:
        fleet.close()
        cp.close()


# ---------------------------------------------------------------------------
# cross-package: one registry and one PFS root, read by either plane
# ---------------------------------------------------------------------------

PLANES = {"jax": RC.ControlPlane, "torch": cpu_plane}
DIRECTIONS = [("jax", "torch"), ("torch", "jax")]
JOB_CONFIG = dict(strategy="stripe_aligned", codec="zstd+delta", chunk_size=4096,
                  delta_every=3)


def mixed_state(step):
    """A train state of float32, bfloat16, int32 and bool leaves."""
    rng = np.random.default_rng(500 + step)
    return {
        "params": {
            "w": rng.standard_normal((48, 130)).astype(np.float32),
            "h": np.asarray(jnp.asarray(rng.standard_normal((33, 70)), jnp.bfloat16)),
        },
        "opt": {"mask": rng.random(301) < 0.5, "count": np.array(step, np.int32)},
    }


def as_pkg(pkg, tree):
    return tree_from_numpy(tree, "cpu") if pkg == "torch" else tree


def as_numpy(pkg, tree):
    if pkg == "torch":
        return tree_to_numpy(tree)
    return {k: as_numpy(pkg, v) for k, v in tree.items()} if isinstance(tree, dict) \
        else np.asarray(tree)


def assert_bytes_equal(a, b):
    fa, fb = flatten_with_names(a)[0], flatten_with_names(b)[0]
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (n, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, n
        assert x.tobytes() == y.tobytes(), n


def build_registry(pkg, root):
    """Two tenants with their own policies, three steps each, step 1 of
    ``prod`` pinned; returns the steps each tenant flushed."""
    cp = PLANES[pkg](str(root), max_pending_flushes=4)
    prod = cp.register_job("prod", cluster(), priority=4.0, keep_n=3, **JOB_CONFIG)
    dev = cp.register_job("dev", cluster(), priority=1.0, weight=2.5, **JOB_CONFIG)
    for s in (1, 2, 3):
        prod.save(s, as_pkg(pkg, mixed_state(s)))
        dev.save(s, as_pkg(pkg, mixed_state(10 + s)))
        prod.wait(), dev.wait()
    cp.pin("prod", 1)
    cp.close()


def registry_doc(root):
    doc = json.loads((root / "control" / "registry.json").read_text())
    for rec in doc["jobs"].values():
        rec.pop("created_at")
    return doc


def test_registries_of_both_packages_are_equal(tmp_path):
    build_registry("jax", tmp_path / "jax")
    build_registry("torch", tmp_path / "torch")
    doc = registry_doc(tmp_path / "torch")
    assert doc == registry_doc(tmp_path / "jax")
    assert all("device" not in rec["config"] for rec in doc["jobs"].values())


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_registry_recovered_across_packages(tmp_path, src, dst):
    build_registry(src, tmp_path)
    written = (tmp_path / "control" / "registry.json").read_text()
    cp = PLANES[dst](str(tmp_path), max_pending_flushes=4)
    try:
        assert cp.jobs() == ["dev", "prod"]
        prod, dev = cp.record("prod"), cp.record("dev")
        assert (prod.priority, prod.weight, prod.keep_n, prod.pinned) == (4.0, 4.0, 3, [1])
        assert (dev.priority, dev.weight, dev.keep_n, dev.pinned) == (1.0, 2.5, None, [])
        assert prod.config == dev.config == JOB_CONFIG
        assert cp.list_steps("prod") == cp.list_steps("dev") == [1, 2, 3]
        assert cp.manager("prod").pinned_steps() == [1]
        for name, seed in (("prod", 0), ("dev", 10)):
            got_s, got = cp.manager(name).restore(as_pkg(dst, mixed_state(0)))
            assert got_s == 3
            assert_bytes_equal(as_numpy(dst, got), mixed_state(seed + 3))
        cp.pin("prod", 1)   # re-persists the recovered registry
        assert (tmp_path / "control" / "registry.json").read_text() == written
    finally:
        cp.close()


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_step_restores_across_packages_on_another_geometry(tmp_path, src, dst):
    """A tenant's steps saved through one package's plane on 2x2 restore
    byte for byte through the other's ``restore_to_geometry`` on 3x1,
    with the saving nodes' L1 dropped (read from the PFS)."""
    build_registry(src, tmp_path)
    cp = PLANES[dst](str(tmp_path), max_pending_flushes=4)
    try:
        live = cp.manager("dev")
        for n in range(2):
            live.local.drop_node(n)
        for step in (1, 3):          # the anchor and a delta on it
            got_s, got = cp.restore_to_geometry("dev", as_pkg(dst, mixed_state(0)),
                                                theta_like(3, 1), step=step)
            assert got_s == step
            assert_bytes_equal(as_numpy(dst, got), mixed_state(10 + step))
    finally:
        cp.close()
