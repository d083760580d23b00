"""The port's self-healing storage runtime: retries, fault injection,
scrub-and-repair (the cases of ``tests/test_self_healing.py`` through
``repro_torch.core``, with ``device="cpu"`` managers).

The acceptance surface:

* transient I/O errors (EIO & friends) heal inside the retry layer —
  zero ``flush_errors``, ``io_retries`` surfaced, restores byte-identical;
* permanent failures (ENOSPC, errno-less) fail fast and stay
  journal-resumable;
* scrub-and-repair rewrites damaged PFS extents from L1/partner,
  re-replicates lost L1 blobs back from the PFS (anti-entropy), and
  quarantines steps with no intact copy — including delta descendants
  of a quarantined base;
* the restore ladder, ``steps()``, and GC all honor quarantine;
* double failures (home-node loss x partner loss x corrupt PFS chunk)
  restore per the docs/OPERATIONS.md fallback matrix, all strategies;
* the deterministic chaos engine (seeded FaultPlan schedules) drives
  all of the above end to end.
"""
import errno
import functools
import os
import threading
import time

import numpy as np
import pytest

from repro_torch.core import (
    CheckpointConfig,
    CheckpointManager,
    FaultPlan,
    FaultSpec,
    MissingBlobError,
    RetryPolicy,
    StorageError,
    classify_error,
    repair_step,
    theta_like,
)
from repro_torch.core.faults import flip_bit
from repro_torch.core.storage import CancelToken, FlushCancelled, LocalStore

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
    """Drop the in-memory L0/last-full twins so restores hit disk."""
    mgr._l0 = None
    mgr._last_full = None


# ---------------------------------------------------------------- classify


def test_classify_error_errno_taxonomy():
    assert classify_error(OSError(errno.EIO, "eio")) == "transient"
    assert classify_error(OSError(errno.EAGAIN, "again")) == "transient"
    assert classify_error(OSError(errno.ENOSPC, "full")) == "permanent"
    assert classify_error(OSError(errno.ENOENT, "gone")) == "permanent"
    # errno-less IOError stays permanent: legacy fault_hook semantics
    assert classify_error(IOError("injected backend crash")) == "permanent"
    assert classify_error(ValueError("not io")) == "permanent"


def test_storage_error_is_oserror_and_filenotfound():
    cause = FileNotFoundError(errno.ENOENT, "gone", "/x/y")
    e = MissingBlobError("l1", 7, 3, "/x/y", cause)
    assert isinstance(e, OSError)
    assert isinstance(e, FileNotFoundError)
    assert (e.level, e.step, e.rank) == ("l1", 7, 3)
    assert e.errno == errno.ENOENT
    g = StorageError("pfs", 1, 0, "/p", OSError(errno.EIO, "eio"))
    assert isinstance(g, OSError) and not isinstance(g, FileNotFoundError)
    assert "pfs" in str(g) and "step 1" in str(g)


# ------------------------------------------------------------- RetryPolicy


def test_retry_policy_heals_transient():
    pol = RetryPolicy(attempts=5, base_delay=0.001, max_delay=0.002, seed=0)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError(errno.EIO, "flaky")
        return "ok"

    stats = {"retries": 0, "giveups": 0}
    assert pol.run(flaky, stats=stats) == "ok"
    assert calls["n"] == 3
    assert stats["retries"] == 2 and stats["giveups"] == 0
    assert pol.retries == 2 and pol.giveups == 0


def test_retry_policy_permanent_fails_first_try():
    pol = RetryPolicy(attempts=5, base_delay=0.001, seed=0)
    calls = {"n": 0}

    def bad():
        calls["n"] += 1
        raise OSError(errno.ENOSPC, "disk full")

    with pytest.raises(OSError) as ei:
        pol.run(bad)
    assert ei.value.errno == errno.ENOSPC
    assert calls["n"] == 1 and pol.retries == 0


def test_retry_policy_gives_up_after_budget():
    pol = RetryPolicy(attempts=3, base_delay=0.001, max_delay=0.002, seed=0)
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise OSError(errno.EIO, "always")

    stats = {"retries": 0, "giveups": 0}
    with pytest.raises(OSError):
        pol.run(always, stats=stats)
    assert calls["n"] == 3
    assert stats["giveups"] == 1 and pol.giveups == 1


def test_retry_policy_deadline_bounds_total_time():
    pol = RetryPolicy(attempts=50, base_delay=0.05, max_delay=0.05, deadline=0.12, seed=0)
    t0 = time.monotonic()
    with pytest.raises(OSError):
        pol.run(lambda: (_ for _ in ()).throw(OSError(errno.EIO, "x")))
    assert time.monotonic() - t0 < 1.0


def test_retry_policy_cancel_token_aborts_sleep():
    pol = RetryPolicy(attempts=10, base_delay=5.0, max_delay=5.0, seed=0)
    tok = CancelToken()
    threading.Timer(0.05, tok.cancel).start()
    t0 = time.monotonic()
    with pytest.raises(FlushCancelled):
        pol.run(lambda: (_ for _ in ()).throw(OSError(errno.EIO, "x")), cancel=tok)
    assert time.monotonic() - t0 < 2.0


def test_retry_policy_custom_classify():
    pol = RetryPolicy(
        attempts=3, base_delay=0.001, seed=0, classify=lambda e: "transient"
    )
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 2:
            raise ValueError("not even an OSError family we retry")
        return 1

    # classify override only applies to OSErrors; ValueError still raises
    with pytest.raises(ValueError):
        pol.run(flaky)
    calls["n"] = 0

    def flaky_os():
        calls["n"] += 1
        if calls["n"] < 2:
            raise OSError(errno.ENOENT, "would be permanent by errno")
        return 1

    assert pol.run(flaky_os) == 1 and calls["n"] == 2


# ---------------------------------------------------------- LocalStore I/O


def test_write_blob_atomic_fsyncs_parent_dir(tmp_path, monkeypatch):
    """Satellite 1: the atomic path must fsync the parent directory
    after os.replace, else the rename is not durable."""
    store = LocalStore(tmp_path / "l1", n_nodes=1)
    synced = []
    real_fsync = os.fsync

    def spy(fd):
        try:
            import stat

            if stat.S_ISDIR(os.fstat(fd).st_mode):
                synced.append(fd)
        except OSError:
            pass
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", spy)
    store.write_blob(0, 1, 0, b"payload", sync=True, atomic=True)
    assert synced, "atomic+sync write_blob never fsynced the parent directory"
    assert store.read_blob(0, 1, 0) == b"payload"
    # non-sync path must NOT pay the dir fsync
    synced.clear()
    store.write_blob(0, 1, 1, b"p2", sync=False, atomic=False)
    assert not synced


def test_read_blob_missing_raises_structured_error(tmp_path):
    store = LocalStore(tmp_path / "l1", n_nodes=2)
    with pytest.raises(MissingBlobError) as ei:
        store.read_blob(0, 5, 3)
    e = ei.value
    assert (e.level, e.step, e.rank) == ("l1", 5, 3)
    assert "rank_000003" in str(e.path)
    # and it still satisfies the legacy except clauses
    with pytest.raises(FileNotFoundError):
        store.read_blob(0, 5, 3)
    with pytest.raises(OSError):
        store.read_slice(1, 5, 3, 0, 4, partner=True)


def test_read_slice_partner_domain_attribution(tmp_path):
    store = LocalStore(tmp_path / "l1", n_nodes=2)
    with pytest.raises(StorageError) as ei:
        store.read_slice(1, 2, 0, 0, 8, partner=True)
    assert ei.value.level == "partner"


def test_local_store_write_retries_transient(tmp_path):
    faults = FaultPlan(
        [FaultSpec(kind="transient_eio", domain="l1", op="write", index=0, count=2)]
    )
    faults.arm("save")
    store = LocalStore(
        tmp_path / "l1", 1, faults=faults,
        retry=RetryPolicy(attempts=5, base_delay=0.001, max_delay=0.002, seed=0),
    )
    store.write_blob(0, 1, 0, b"healed")
    assert store.read_blob(0, 1, 0) == b"healed"
    assert len(faults.fired) == 2


# ----------------------------------------------------------------- faults


def test_flip_bit():
    assert flip_bit(b"\x00\x00", 0) == b"\x01\x00"
    assert flip_bit(b"\x00\x00", 9) == b"\x00\x02"
    assert flip_bit(flip_bit(b"abc", 13), 13) == b"abc"


def test_fault_plan_fires_at_exact_index():
    plan = FaultPlan(
        [FaultSpec(kind="transient_eio", domain="pfs", op="write", index=2, count=1)]
    )
    plan.arm("save")
    plan.on_op("pfs", "write")  # index 0
    plan.on_op("pfs", "write")  # index 1
    with pytest.raises(OSError) as ei:
        plan.on_op("pfs", "write")  # index 2: fires
    assert ei.value.errno == errno.EIO
    plan.on_op("pfs", "write")  # index 3 (the "retry"): healed
    assert [f[:2] for f in plan.fired] == [("transient_eio", "pfs")]


def test_fault_plan_count_fails_consecutive_attempts():
    plan = FaultPlan(
        [FaultSpec(kind="transient_eio", domain="pfs", op="write", index=1, count=2)]
    )
    plan.arm("save")
    plan.on_op("pfs", "write")
    for _ in range(2):
        with pytest.raises(OSError):
            plan.on_op("pfs", "write")
    plan.on_op("pfs", "write")  # third attempt: healed
    assert len(plan.fired) == 2


def test_fault_plan_phases_isolate_save_from_verify():
    plan = FaultPlan(
        [FaultSpec(kind="transient_eio", domain="pfs", op="read", index=0,
                   count=1, phase="verify")]
    )
    plan.arm("save")
    plan.on_op("pfs", "read")  # save phase: verify-spec must not fire
    plan.arm("verify")
    with pytest.raises(OSError):
        plan.on_op("pfs", "read")
    assert plan.fired_kinds() == {"transient_eio"}


def test_fault_plan_disarm_and_rearm():
    plan = FaultPlan(
        [FaultSpec(kind="enospc", domain="l1", op="write", index=0)]
    )
    plan.disarm()
    for _ in range(5):
        plan.on_op("l1", "write")
    assert not plan.fired
    plan.arm("save")  # re-arms and zeroes the stream counters
    with pytest.raises(OSError):
        plan.on_op("l1", "write")


def test_fault_plan_generate_deterministic_and_valid():
    a = FaultPlan.generate(seed=1234)
    b = FaultPlan.generate(seed=1234)
    assert [repr(s) for s in a.specs] == [repr(s) for s in b.specs]
    c = FaultPlan.generate(seed=1235)
    assert [repr(s) for s in a.specs] != [repr(s) for s in c.specs]
    for s in a.specs:
        assert s.kind in ("transient_eio", "enospc", "torn_write",
                          "bit_flip", "stall", "node_crash")
        assert s.domain in ("l1", "partner", "pfs")
    # coverage: over many seeds every kind appears
    kinds = set()
    for seed in range(40):
        kinds |= {s.kind for s in FaultPlan.generate(seed=seed).specs}
    assert kinds == {"transient_eio", "enospc", "torn_write",
                     "bit_flip", "stall", "node_crash"}


# ----------------------------------------------- flush-path fault healing


def test_transient_pfs_eio_heals_with_zero_flush_errors(tmp_path):
    faults = FaultPlan(
        [FaultSpec(kind="transient_eio", domain="pfs", op="write", index=1, count=2)]
    )
    mgr = make_mgr(tmp_path, strategy="posix", _faults=faults)
    mgr.faults.arm("save")
    try:
        res = mgr.save(1, state(1)).flush
        assert res is not None and not res.failed
        assert res.io_retries >= 2 and res.io_giveups == 0
        assert mgr.flush_errors == []
        faults.disarm()
        forget_memory(mgr)
        s, tree = mgr.restore(state(1))
        assert s == 1 and trees_equal(tree, state(1))
    finally:
        mgr.close()


def test_torn_pfs_write_heals_idempotently(tmp_path):
    faults = FaultPlan(
        [FaultSpec(kind="torn_write", domain="pfs", op="write", index=0, frac=0.4)]
    )
    mgr = make_mgr(tmp_path, strategy="stripe_aligned", _faults=faults)
    mgr.faults.arm("save")
    try:
        mgr.save(1, state(1))
        assert mgr.flush_errors == []
        assert "torn_write" in faults.fired_kinds()
        faults.disarm()
        forget_memory(mgr)
        s, tree = mgr.restore(state(1))
        assert s == 1 and trees_equal(tree, state(1))
        rep = mgr.validate(1)
        assert all(rep["pfs"].values())
    finally:
        mgr.close()


def test_enospc_is_permanent_and_journal_resumable(tmp_path):
    faults = FaultPlan(
        [FaultSpec(kind="enospc", domain="pfs", op="write", index=1)]
    )
    mgr = make_mgr(tmp_path, strategy="posix", _faults=faults)
    mgr.faults.arm("save")
    try:
        # sync flush: the permanent error propagates out of save()
        # after exactly one attempt (no retry on ENOSPC)
        with pytest.raises(OSError) as ei:
            mgr.save(1, state(1))
        assert ei.value.errno == errno.ENOSPC
        assert len(faults.fired) == 1
        assert 1 not in mgr.steps("pfs")
        assert 1 in mgr.steps("local"), "local phase committed before the flush"
        # the spec is exhausted (count=1): resume finishes the flush
        resumed = mgr.resume_flushes()
        assert 1 in resumed
        assert 1 in mgr.steps("pfs")
        faults.disarm()
        forget_memory(mgr)
        mgr.local.drop_node(0)
        mgr.local.drop_node(1)
        s, tree = mgr.restore(state(1))
        assert s == 1 and trees_equal(tree, state(1))
    finally:
        mgr.close()


def test_node_crash_mid_flush_restores_via_partner(tmp_path):
    faults = FaultPlan(
        [FaultSpec(kind="node_crash", domain="pfs", op="write", index=0, node=0)]
    )
    mgr = make_mgr(tmp_path, strategy="file_per_process",
                   partner_replication=True, _faults=faults)
    mgr.faults.arm("save")
    try:
        mgr.save(1, state(1))
        assert mgr.flush_errors == []
        assert "node_crash" in faults.fired_kinds()
        faults.disarm()
        forget_memory(mgr)
        s, tree = mgr.restore(state(1))
        assert s == 1 and trees_equal(tree, state(1))
    finally:
        mgr.close()


def test_restore_read_retries_transient_pfs_reads(tmp_path):
    faults = FaultPlan(
        [FaultSpec(kind="transient_eio", domain="pfs", op="read", index=0,
                   count=2, phase="verify")]
    )
    mgr = make_mgr(tmp_path, strategy="mpiio", _faults=faults)
    try:
        mgr.save(1, state(1))
        assert mgr.flush_errors == []
        forget_memory(mgr)
        mgr.local.drop_node(0)
        mgr.local.drop_node(1)
        faults.arm("verify")
        s, tree = mgr.restore(state(1))
        assert s == 1 and trees_equal(tree, state(1))
        assert len(faults.fired) == 2
    finally:
        mgr.close()


# ------------------------------------------------------- scrub and repair


def test_scrub_reports_partner_level(tmp_path):
    mgr = make_mgr(tmp_path, partner_replication=True)
    try:
        mgr.save(1, state(1))
        rep = mgr.validate(1)
        assert set(rep["partner"]) == {0, 1, 2, 3}
        assert all(rep["partner"].values())
    finally:
        mgr.close()


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
def test_repair_pfs_extent_from_l1(tmp_path, strategy):
    faults = FaultPlan(
        [FaultSpec(kind="bit_flip", domain="pfs", op="write", index=2, bit=5)]
    )
    mgr = make_mgr(tmp_path, strategy=strategy, _faults=faults)
    mgr.faults.arm("save")
    try:
        mgr.save(1, state(1))
        assert mgr.flush_errors == []
        faults.disarm()
        rep = mgr.validate(1)
        bad = [r for r, ok in rep["pfs"].items() if not ok]
        assert bad, "bit flip must be caught by the CRC scrub"
        rep = mgr.validate(1, repair=True)
        assert sorted(rep["repair"].pfs_repaired) == sorted(bad)
        assert not rep["repair"].quarantined
        assert all(rep["post"]["pfs"].values())
        forget_memory(mgr)
        mgr.local.drop_node(0)
        mgr.local.drop_node(1)
        s, tree = mgr.restore(state(1))
        assert s == 1 and trees_equal(tree, state(1))
    finally:
        mgr.close()


def test_anti_entropy_rereplicates_lost_node_from_pfs(tmp_path):
    mgr = make_mgr(tmp_path, partner_replication=True)
    try:
        mgr.save(1, state(1))
        mgr.local.drop_node(0)  # home blobs of ranks 0,1; partner of 2,3
        rep = mgr.validate(1, repair=True)
        r = rep["repair"]
        assert sorted(r.l1_restored) == [0, 1]
        assert sorted(r.partner_restored) == [2, 3]
        assert all(rep["post"]["local"].values())
        assert all(rep["post"]["partner"].values())
        # and the restored L1 is genuinely usable: kill PFS, restore
        forget_memory(mgr)
        for f in (mgr.pfs_dir / "step_00000001").glob("*"):
            if f.name != "manifest.json":
                f.unlink()
        s, tree = mgr.restore(state(1))
        assert s == 1 and trees_equal(tree, state(1))
    finally:
        mgr.close()


def test_irreparable_step_is_quarantined_never_wrong_bytes(tmp_path):
    mgr = make_mgr(tmp_path)
    try:
        mgr.save(1, state(1))
        mgr.save(2, state(2))
        for n in range(2):
            mgr.local.drop_node(n, 2)
        for f in (mgr.pfs_dir / "step_00000002").glob("*"):
            if f.name != "manifest.json":
                b = bytearray(f.read_bytes())
                if b:
                    b[0] ^= 0xFF
                    f.write_bytes(bytes(b))
        rep = mgr.validate(2, repair=True)
        assert rep["repair"].quarantined
        assert rep["repair"].unrepairable
        # honored by steps() on both levels...
        assert 2 not in mgr.steps("pfs")
        assert 2 not in mgr.steps("local")
        forget_memory(mgr)
        # ...by explicit restore (clean error, never wrong bytes)...
        with pytest.raises(FileNotFoundError) as ei:
            mgr.restore(state(2), step=2)
        assert "quarantined" in str(ei.value)
        # ...and by the ladder's fallback to the newest healthy step
        s, tree = mgr.restore(state(1))
        assert s == 1 and trees_equal(tree, state(1))
        # idempotent: repairing again stays quarantined, no crash
        r2 = repair_step(mgr, 2)
        assert r2.quarantined
    finally:
        mgr.close()


def test_quarantined_base_poisons_delta_descendants(tmp_path):
    mgr = make_mgr(tmp_path, codec="zstd+delta", delta_every=4, chunk_size=4096)
    try:
        for s in (1, 2, 3):
            mgr.save(s, state(s))
        assert mgr._manifest_pfs(3).base_step is not None
        for n in range(2):
            mgr.local.drop_node(n, 1)
        for f in (mgr.pfs_dir / "step_00000001").glob("*"):
            if f.name != "manifest.json":
                b = bytearray(f.read_bytes())
                if b:
                    b[0] ^= 0xFF
                    f.write_bytes(bytes(b))
        rep = mgr.validate(1, repair=True)
        r = rep["repair"]
        assert r.quarantined
        assert sorted(r.suspect_descendants) == [2, 3]
        assert mgr.steps("pfs") == []
        forget_memory(mgr)
        with pytest.raises(FileNotFoundError):
            mgr.restore(state(3), step=3)
        # next save must re-anchor with a full snapshot, not a delta
        # against the quarantined base
        mgr.save(4, state(4))
        assert mgr._manifest_pfs(4).base_step is None
        forget_memory(mgr)
        s, tree = mgr.restore(state(4))
        assert s == 4 and trees_equal(tree, state(4))
    finally:
        mgr.close()


def test_gc_reaps_quarantined_steps(tmp_path):
    mgr = make_mgr(tmp_path, keep_n=2)
    try:
        for s in (1, 2, 3):
            mgr.save(s, state(s))
        for n in range(2):
            mgr.local.drop_node(n, 1)
        for f in (mgr.pfs_dir / "step_00000001").glob("*"):
            if f.name != "manifest.json":
                b = bytearray(f.read_bytes())
                if b:
                    b[0] ^= 0xFF
                    f.write_bytes(bytes(b))
        mgr.validate(1, repair=True)
        mgr.save(4, state(4))  # triggers GC; quarantined 1 is below keep
        assert not (mgr.pfs_dir / "step_00000001").exists()
        assert mgr.steps("pfs") == [3, 4]
    finally:
        mgr.close()


# --------------------------------------- satellite 3: double-failure matrix


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
def test_double_failure_matrix(tmp_path, strategy):
    """Home-node loss x partner loss x one corrupt PFS chunk: per the
    OPERATIONS.md fallback matrix every rank still has exactly one good
    source, so repair must fully heal and restore byte-identically."""
    mgr = make_mgr(tmp_path, strategy=strategy, partner_replication=True)
    try:
        mgr.save(1, state(1))
        # node 0 loses home blobs (ranks 0,1) and partner copies (2,3)
        mgr.local.drop_node(0)
        # corrupt one PFS payload region
        payloads = sorted(
            f for f in (mgr.pfs_dir / "step_00000001").glob("*")
            if f.name != "manifest.json"
        )
        b = bytearray(payloads[0].read_bytes())
        b[len(b) // 2] ^= 0x80
        payloads[0].write_bytes(bytes(b))
        rep = mgr.validate(1, repair=True)
        r = rep["repair"]
        assert not r.quarantined, f"{strategy}: {r.as_dict()}"
        assert all(rep["post"]["pfs"].values())
        assert all(rep["post"]["local"].values())
        assert all(rep["post"]["partner"].values())
        forget_memory(mgr)
        s, tree = mgr.restore(state(1))
        assert s == 1 and trees_equal(tree, state(1))
    finally:
        mgr.close()


def test_double_failure_delta_chain(tmp_path):
    """Same matrix cell but on a delta step: the repaired base must
    decode its descendants byte-identically."""
    mgr = make_mgr(
        tmp_path, codec="zstd+delta", delta_every=4, chunk_size=4096,
        partner_replication=True,
    )
    try:
        mgr.save(1, state(1))
        mgr.save(2, state(2))
        mgr.local.drop_node(1)  # home of ranks 2,3; partner of 0,1
        payloads = sorted(
            f for f in (mgr.pfs_dir / "step_00000001").glob("*")
            if f.name != "manifest.json"
        )
        b = bytearray(payloads[0].read_bytes())
        b[0] ^= 0x01
        payloads[0].write_bytes(bytes(b))
        rep = mgr.validate(1, repair=True)
        assert not rep["repair"].quarantined
        assert all(rep["post"]["pfs"].values())
        forget_memory(mgr)
        s, tree = mgr.restore(state(2))
        assert s == 2 and trees_equal(tree, state(2))
    finally:
        mgr.close()


# ------------------------------------------------------------------ serve


def test_serve_restore_retries_transient(tmp_path, monkeypatch):
    from repro_torch.serve.engine import Server

    class _TinyModel:
        pass

    class _Mgr:
        def __init__(self):
            self.calls = 0

        def restore_subtree(self, template, prefix, *, step=None, sharding_fn=None):
            self.calls += 1
            if self.calls < 3:
                raise IOError("PFS briefly unavailable")  # errno-less
            return 7, {"w": np.ones(3)}

    mgr = _Mgr()
    pol = RetryPolicy(attempts=5, base_delay=0.001, max_delay=0.002, seed=0)
    srv, step = Server.from_checkpoint(
        _TinyModel(), mgr, {"w": np.zeros(3)}, retry=pol
    )
    assert step == 7 and mgr.calls == 3
    # the caller's policy must not have been mutated
    assert pol.classify is None


# ------------------------------------------------------------------ chaos


def test_chaos_smoke_fixed_seeds(tmp_path, monkeypatch):
    """A handful of seeded FaultPlan schedules through the full
    save -> flush -> scrub -> repair -> restore loop (the benchmark
    harness runs hundreds; this is the in-suite smoke).  The harness
    is the JAX package's ``benchmarks/chaos.py``, its invariants
    unchanged, driving the port's manager, config and fault plans."""
    from pathlib import Path

    import repro_torch.core.faults as port_faults
    from repro_torch.core import CheckpointManager as PortManager

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import benchmarks.chaos as chaos
    from benchmarks.chaos import run_schedule
    assert chaos.FAULT_KINDS == port_faults.FAULT_KINDS
    assert chaos.TRANSIENT_KINDS == port_faults.TRANSIENT_KINDS
    monkeypatch.setattr(chaos, "CheckpointConfig", cpu_config)
    monkeypatch.setattr(chaos, "CheckpointManager", PortManager)
    monkeypatch.setattr(chaos, "FaultPlan", port_faults.FaultPlan)
    monkeypatch.setattr(chaos, "theta_like", theta_like)

    for seed in (3, 11, 17, 29):
        row = run_schedule(seed, root=str(tmp_path / f"s{seed}"))
        assert row["invariant_violations"] == [], (seed, row)
        assert row["restored_identical"], (seed, row)


# ----------------------------------------------------- serve x self-healing


def serve_state(step, kib=64):
    """A train state with a ``params`` subtree, as the fleet restores it."""
    return {
        "params": state(step, kib),
        "opt": {"mu": np.full((64,), step, np.float64)},
    }


def test_serve_cold_start_heals_corrupt_pfs_extents(tmp_path):
    """A fleet cold start against a step whose PFS extents are corrupt
    falls back through the ladder (chunk CRCs catch the damage, L1
    serves the bytes) and still streams byte-identical params."""
    from repro_torch.serve.stream import stream_restore

    mgr = make_mgr(tmp_path, codec="zstd", chunk_size=4 * 1024)
    try:
        mgr.save(1, serve_state(1))
        forget_memory(mgr)
        for f in (mgr.pfs_dir / "step_00000001").glob("*"):
            if f.name != "manifest.json":
                b = bytearray(f.read_bytes())
                if b:
                    b[len(b) // 2] ^= 0xFF
                    f.write_bytes(bytes(b))
        template = {k: np.zeros_like(v) for k, v in state(1).items()}
        sr = stream_restore(mgr, template)
        assert sr.step == 1
        assert trees_equal(sr.params, state(1))
    finally:
        mgr.close()


def test_serve_cold_start_from_quarantined_step_raises_cleanly(tmp_path):
    """Explicitly cold-starting from a quarantined step must raise a
    clean error naming the quarantine — never serve wrong bytes — and
    the default (newest-step) cold start falls back to the healthy
    predecessor."""
    from repro_torch.serve.stream import stream_restore

    mgr = make_mgr(tmp_path)
    try:
        mgr.save(1, serve_state(1))
        mgr.save(2, serve_state(2))
        for n in range(2):
            mgr.local.drop_node(n, 2)
        for f in (mgr.pfs_dir / "step_00000002").glob("*"):
            if f.name != "manifest.json":
                b = bytearray(f.read_bytes())
                if b:
                    b[0] ^= 0xFF
                    f.write_bytes(bytes(b))
        rep = mgr.validate(2, repair=True)
        assert rep["repair"].quarantined
        forget_memory(mgr)
        template = {k: np.zeros_like(v) for k, v in state(1).items()}
        with pytest.raises(FileNotFoundError) as ei:
            stream_restore(mgr, template, step=2)
        assert "quarantined" in str(ei.value)
        sr = stream_restore(mgr, template)  # ladder falls back to step 1
        assert sr.step == 1 and trees_equal(sr.params, state(1))
    finally:
        mgr.close()


def test_follower_skips_quarantined_step(tmp_path):
    """The hot-swap follower never adopts a step that scrub-and-repair
    quarantined: it keeps serving the old step until a genuinely
    healthy newer step lands, then adopts that."""
    from repro_torch.serve import FleetConfig, ServeFleet

    class _NoModel:
        def decode_step(self, p, c, t):  # never traced in this test
            raise AssertionError("decode unused")

    mgr = make_mgr(tmp_path)
    fleet = None
    try:
        mgr.save(1, serve_state(1))
        mgr.save(2, serve_state(2))
        for n in range(2):
            mgr.local.drop_node(n, 2)
        for f in (mgr.pfs_dir / "step_00000002").glob("*"):
            if f.name != "manifest.json":
                b = bytearray(f.read_bytes())
                if b:
                    b[0] ^= 0xFF
                    f.write_bytes(bytes(b))
        assert mgr.validate(2, repair=True)["repair"].quarantined
        forget_memory(mgr)
        template = {k: np.zeros_like(v) for k, v in state(1).items()}
        fleet = ServeFleet(
            _NoModel(), mgr, template,
            cfg=FleetConfig(n_servers=1, poll_interval=0.02),
        )
        fleet.cold_start(step=1)
        fleet.start_follower()
        time.sleep(0.3)
        assert fleet.current_step == 1        # quarantined step 2 skipped
        mgr.save(3, serve_state(3))           # healthy newer step
        deadline = time.monotonic() + 30
        while fleet.current_step != 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fleet.current_step == 3
        assert trees_equal(fleet.servers[0].params, state(3))
    finally:
        if fleet is not None:
            fleet.stop()
        mgr.close()


def test_serve_from_checkpoint_non_io_error_raises_immediately(tmp_path):
    """Regression: ``from_checkpoint(retry=...)`` used to classify EVERY
    exception transient, so a programming error (bad template, typo'd
    prefix → TypeError/KeyError) burned the whole retry deadline.  Now
    only I/O errors (OSError/StorageError) retry; anything else raises
    on the first attempt."""
    from repro_torch.serve.engine import Server

    class _TinyModel:
        pass

    class _Mgr:
        def __init__(self, exc):
            self.exc = exc
            self.calls = 0

        def restore_subtree(self, template, prefix, *, step=None, sharding_fn=None):
            self.calls += 1
            raise self.exc

    pol = RetryPolicy(attempts=5, base_delay=0.001, max_delay=0.002, seed=0)
    for exc in (TypeError("template is not a pytree"), KeyError("['params']['w']")):
        mgr = _Mgr(exc)
        with pytest.raises(type(exc)):
            Server.from_checkpoint(_TinyModel(), mgr, {"w": np.zeros(3)}, retry=pol)
        assert mgr.calls == 1, "non-I/O errors must not retry"
    # while genuine I/O failures (StorageError is an OSError) still do
    mgr = _Mgr(StorageError("pfs", 1, 0, "/gone", OSError(errno.EIO, "eio")))
    with pytest.raises(StorageError):
        Server.from_checkpoint(_TinyModel(), mgr, {"w": np.zeros(3)}, retry=pol)
    assert mgr.calls == 5, "I/O errors retry to the attempt budget"


def test_retry_policy_non_oserror_respects_classify():
    """Non-OSErrors are never retried — a classify override only
    widens retries *within* the OSError family.  That is the contract
    ``Server.from_checkpoint``'s transient-I/O classifier relies on:
    programming errors propagate on the first call, while the
    ``FileNotFoundError`` the restore ladder raises during a PFS
    brown-out (an OSError subclass) is re-pulled."""
    calls = {"n": 0}

    def flaky_default():
        calls["n"] += 1
        raise ValueError("not I/O")

    pol = RetryPolicy(attempts=4, base_delay=0.001, max_delay=0.002, seed=0)
    with pytest.raises(ValueError):
        pol.run(flaky_default)
    assert calls["n"] == 1                    # not caught: no retry, ever

    calls["n"] = 0

    def flaky_fnf():
        calls["n"] += 1
        if calls["n"] < 3:
            raise FileNotFoundError("no restorable checkpoint yet")
        return "ok"

    wide = RetryPolicy(
        attempts=5, base_delay=0.001, max_delay=0.002, seed=0,
        classify=lambda e: "transient",
    )
    assert wide.run(flaky_fnf) == "ok"
    assert calls["n"] == 3
