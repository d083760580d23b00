"""The port's adaptive flush runtime: supersession, throttling,
resumable flushes (the cases of ``tests/test_flush_runtime.py`` through
``repro_torch.core``, with ``device="cpu"`` managers).

The scheduler edge cases:

* a superseded step's restore falls back to L1 (byte-identical);
* a resumed flush is byte-identical to an uninterrupted one, across
  all five strategies, rewriting only the unjournaled remainder;
* delta-base steps (full snapshots under ``zstd+delta``) are never
  superseded;
* ``flush_errors`` surfaces a mid-flush cancellation *correctly* —
  i.e. not at all: cancellation is a scheduling outcome, not a failure;
* ``close()`` never drops queued flushes silently — lost steps are
  enumerated and remain resumable.

Plus unit coverage for the runtime primitives (token bucket, progress
journal) and the sim/executor throttle-pricing agreement.
"""
import functools
import logging
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import (
    CheckpointConfig,
    CheckpointManager,
    FlushJournal,
    Manifest,
    TokenBucket,
    make_plan,
    simulate_flush,
    theta_like,
)
from repro_torch.core.storage import CancelToken, FlushCancelled
from repro_torch.utils.treelib import flatten_with_names

ALL_STRATEGIES = ["file_per_process", "posix", "mpiio", "stripe_aligned", "gio_sync"]
MiB = 1 << 20

cpu_config = functools.partial(CheckpointConfig, device="cpu")


def state_tree(step=0):
    return {
        "params": {
            "w": torch.arange(3000, dtype=torch.float32).reshape(60, 50) + step,
            "b": torch.full((64,), step, dtype=torch.bfloat16),
        },
        "opt": {"mu": torch.ones((40, 50), dtype=torch.float32) * step,
                "count": torch.tensor(step, dtype=torch.int32)},
    }


def target_tree():
    return state_tree()


def assert_tree_equal(a, b):
    fa, fb = flatten_with_names(a)[0], flatten_with_names(b)[0]
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (n, x), (_, y) in zip(fa, fb):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        assert x.dtype == y.dtype and torch.equal(x, y), n


# ---------------------------------------------------------------------------
# runtime primitives: token bucket + progress journal
# ---------------------------------------------------------------------------


def test_token_bucket_enforces_long_run_rate():
    tb = TokenBucket(rate=8 * MiB, burst=1 * MiB)
    t0 = time.perf_counter()
    waited = 0.0
    for _ in range(8):                 # 4 MiB through an 8 MiB/s bucket
        waited += tb.acquire(MiB // 2)
    elapsed = time.perf_counter() - t0
    # burst covers the first MiB; the remaining 3 MiB must take ~0.375 s
    assert elapsed >= 0.2
    assert waited > 0.0
    assert tb.wait_total >= waited - 1e-6


def test_token_bucket_cancel_aborts_throttled_acquire():
    tb = TokenBucket(rate=1024.0, burst=1024.0)
    tb.acquire(1 << 20)                # drive the bucket deep into debt
    token = CancelToken()
    token.cancel()
    with pytest.raises(FlushCancelled):
        tb.acquire(1, cancel=token)


def test_flush_journal_roundtrip_coverage_and_torn_tail(tmp_path):
    p = tmp_path / "flush_journal.bin"
    j = FlushJournal(p, flush_every=1)
    j.record(0, 0, 100)
    j.record(0, 100, 50)               # adjacent: merges with the first
    j.record(1, 10, 5)
    j.flush()
    # a torn trailing record (process death mid-append) must be ignored
    with open(p, "ab") as f:
        f.write(b"\x01\x02\x03")
    j2 = FlushJournal(p)
    assert len(j2.done) == 3
    assert j2.completed_bytes == 155
    assert j2.covers(0, 0, 150)        # merged interval
    assert j2.covers(0, 25, 100)
    assert not j2.covers(0, 100, 51)
    assert j2.covers(1, 10, 5)
    assert not j2.covers(1, 9, 5)
    assert not j2.covers(2, 0, 1)
    j2.unlink()
    assert not p.exists()
    assert len(FlushJournal(p).done) == 0


def test_flush_journal_pre_sync_runs_before_records_persist(tmp_path):
    """A journal record is a durability claim: the data-fd fsync hook
    must run strictly before each batch of records hits the file."""
    p = tmp_path / "flush_journal.bin"
    order = []
    j = FlushJournal(p, flush_every=2)
    j.pre_sync = lambda: order.append(("sync", p.stat().st_size if p.exists() else 0))
    j.record(0, 0, 10)
    assert not p.exists()                # buffered, no claim yet
    j.record(0, 10, 10)                  # batch full -> pre_sync + write
    assert order == [("sync", 0)]        # synced before any record landed
    assert p.stat().st_size == 2 * FlushJournal.RECORD
    j.record(1, 0, 5)
    j.flush()
    assert order[-1] == ("sync", 2 * FlushJournal.RECORD)


# ---------------------------------------------------------------------------
# supersession
# ---------------------------------------------------------------------------


def test_supersession_skips_stale_and_restore_falls_back_to_l1(tmp_path):
    """Saves faster than the drain: stale queued flushes are skipped,
    the newest step still reaches flush_done, superseded steps are not
    errors, and restoring a superseded step works from L1."""
    def slow(_w):
        time.sleep(0.05)

    mgr = CheckpointManager(
        cpu_config(
            root=str(tmp_path), cluster=theta_like(2, 2),
            strategy="stripe_aligned", supersede_stale=True,
            max_pending_flushes=4,
        ),
        fault_hook=slow,
    )
    for s in range(1, 7):
        mgr.save(s, state_tree(s))
    mgr.wait()
    assert mgr.flush_errors == []
    skipped = mgr.superseded_steps
    assert skipped                      # the cadence outran the drain
    assert 6 not in skipped             # the newest step is never stale
    assert 6 in mgr.steps("pfs")
    by_step = {st.step: st for st in mgr.stats}
    for s in skipped:
        assert by_step[s].superseded
        assert by_step[s].flush is None
    # superseded-step restore: no flush_done PFS manifest -> L1 ladder
    mgr._l0 = None
    s = skipped[0]
    step, got = mgr.restore(target_tree(), step=s)
    assert step == s
    assert_tree_equal(got, state_tree(s))
    mgr.close()


def test_mid_flush_cancellation_is_not_a_flush_error(tmp_path):
    """A flush cancelled mid-flight by supersession stops at a request
    boundary, is recorded as superseded (status="superseded" on disk),
    and never lands in flush_errors."""
    started = threading.Event()
    gate = threading.Event()

    def hook(_w):
        started.set()
        gate.wait(timeout=30)

    # 32 single-rank nodes -> 32 uncoalescable rows, more than the
    # 16-thread pool: cancellation lands between the two waves.
    mgr = CheckpointManager(
        cpu_config(
            root=str(tmp_path), cluster=theta_like(32, 1),
            strategy="posix", supersede_stale=True, max_pending_flushes=2,
        ),
        fault_hook=hook,
    )
    small = {"x": torch.ones((32 * 1024,), dtype=torch.float32)}
    mgr.save(1, small)
    assert started.wait(timeout=10)     # step 1's flush is mid-flight
    mgr.save(2, small)                  # supersedes + cancels step 1
    gate.set()
    mgr.wait()
    assert mgr.flush_errors == []       # cancellation is not an error
    assert mgr.superseded_steps == [1]
    assert mgr.steps("pfs") == [2]
    man1 = Manifest.from_json(
        (mgr.pfs_dir / "step_00000001" / "manifest.json").read_text()
    )
    assert man1.status == "superseded"
    # and resume_flushes leaves the superseded partial alone
    assert mgr.resume_flushes() == {}
    mgr._l0 = None
    step, got = mgr.restore(small, step=1)
    assert step == 1
    assert_tree_equal(got, small)
    mgr.close()


def test_delta_base_steps_are_never_superseded(tmp_path):
    """Full snapshots under zstd+delta anchor every delta chain: the
    scheduler must flush them even when stale."""
    def slow(_w):
        time.sleep(0.03)

    mgr = CheckpointManager(
        cpu_config(
            root=str(tmp_path), cluster=theta_like(2, 2),
            strategy="stripe_aligned", codec="zstd+delta", delta_every=3,
            supersede_stale=True, max_pending_flushes=4,
        ),
        fault_hook=slow,
    )
    for s in range(1, 8):
        mgr.save(s, state_tree(s))
    mgr.wait()
    assert mgr.flush_errors == []
    full_steps = {1, 4, 7}              # delta_every=3 cadence anchors
    assert not (set(mgr.superseded_steps) & full_steps)
    pfs = set(mgr.steps("pfs"))
    assert full_steps <= pfs
    # every superseded delta still restores through the ladder
    mgr._l0 = None
    mgr._last_full = None
    for s in mgr.superseded_steps:
        step, got = mgr.restore(target_tree(), step=s)
        assert step == s
        assert_tree_equal(got, state_tree(s))
    mgr.close()


def test_live_delta_window_survives_total_l1_loss(tmp_path):
    """Regression (confirmed repro): deltas chain through their
    predecessors, so pending steps inside the live delta window must
    never be superseded — otherwise a flush_done delta's base chain is
    missing from the PFS and node loss (the exact case L2 exists for)
    makes it unrestorable."""
    def slow(_w):
        time.sleep(0.03)

    cluster = theta_like(2, 2)
    mgr = CheckpointManager(
        cpu_config(
            root=str(tmp_path), cluster=cluster, strategy="stripe_aligned",
            codec="zstd+delta", delta_every=8, supersede_stale=True,
            max_pending_flushes=4,
        ),
        fault_hook=slow,
    )
    for s in range(1, 5):
        mgr.save(s, state_tree(s))
    mgr.wait()
    assert mgr.flush_errors == []
    assert mgr.superseded_steps == []     # all four share one live window
    assert mgr.steps("pfs") == [1, 2, 3, 4]
    for n in range(cluster.n_nodes):      # total L1 loss
        mgr.local.drop_node(n)
    mgr._l0 = None
    mgr._last_full = None
    step, got = mgr.restore(target_tree())  # PFS-only, full base chain
    assert step == 4
    assert_tree_equal(got, state_tree(4))
    mgr.close()


def test_full_app_net_load_still_throttles(tmp_path):
    """load -> 1.0 must floor the derived cap at the sim's 1e-3 derate,
    not flip the boundary value to 'unthrottled'."""
    from repro_torch.core import ClusterSpec, NodeSpec

    cluster = ClusterSpec(
        n_nodes=2, procs_per_node=1, node=NodeSpec(app_net_load=1.0)
    )
    mgr = CheckpointManager(
        cpu_config(root=str(tmp_path), cluster=cluster,
                   strategy="stripe_aligned", async_flush=False)
    )
    assert mgr._limiter is not None
    assert mgr._limiter.rate == pytest.approx(2 * cluster.node.nic_bw * 1e-3)
    mgr.close()


def test_keep_n_pins_steps_against_supersession(tmp_path):
    """Steps inside the keep_n newest window are retention-pinned: with
    keep_n covering every save, nothing may be superseded even under a
    slow drain."""
    def slow(_w):
        time.sleep(0.02)

    mgr = CheckpointManager(
        cpu_config(
            root=str(tmp_path), cluster=theta_like(2, 2),
            strategy="stripe_aligned", supersede_stale=True,
            max_pending_flushes=4, keep_n=10,
        ),
        fault_hook=slow,
    )
    for s in range(1, 6):
        mgr.save(s, state_tree(s))
    mgr.wait()
    assert mgr.flush_errors == []
    assert mgr.superseded_steps == []
    assert mgr.steps("pfs") == [1, 2, 3, 4, 5]
    mgr.close()


def test_gc_reaps_superseded_steps(tmp_path):
    """Under supersession + keep_n, the L1 blobs, local manifests and
    partial PFS leavings of superseded steps must not accumulate past
    the retention window."""
    def slow(_w):
        time.sleep(0.03)

    mgr = CheckpointManager(
        cpu_config(
            root=str(tmp_path), cluster=theta_like(2, 2),
            strategy="stripe_aligned", supersede_stale=True,
            max_pending_flushes=4, keep_n=2,
        ),
        fault_hook=slow,
    )
    for s in range(1, 9):
        mgr.save(s, state_tree(s))
    mgr.wait()
    assert mgr.flush_errors == []
    assert mgr.superseded_steps          # cadence outran the drain
    kept = mgr.steps("pfs")
    assert kept[-1] == 8
    reaped = [s for s in mgr.superseded_steps if s < min(kept)]
    assert reaped                        # something below the window
    for s in reaped:
        assert not mgr.local.has_blob(0, s, 0)
        assert not (mgr.root / "local" / "manifests"
                    / f"step_{s:08d}.json").exists()
        assert not (mgr.pfs_dir / f"step_{s:08d}").exists()
    for s in kept:                       # kept steps stay on both levels
        assert (mgr.root / "local" / "manifests"
                / f"step_{s:08d}.json").exists()
        assert (mgr.pfs_dir / f"step_{s:08d}" / "manifest.json").exists()
    mgr.close()


def test_gc_never_deletes_delta_bases_of_superseded_chains(tmp_path):
    """The GC base-chain walk must traverse superseded/partial
    manifests too: with delta + supersession + keep_n, the kept step's
    chain runs through superseded steps whose only durable copy is L1
    — deleting them would make every checkpoint unrestorable after
    restart."""
    def slow(_w):
        time.sleep(0.03)

    cfg = dict(cluster=theta_like(2, 2), strategy="stripe_aligned",
               codec="zstd+delta", delta_every=6)
    mgr = CheckpointManager(
        cpu_config(root=str(tmp_path), supersede_stale=True,
                   max_pending_flushes=4, keep_n=1, **cfg),
        fault_hook=slow,
    )
    for s in range(1, 7):
        mgr.save(s, state_tree(s))
    mgr.wait()
    assert mgr.flush_errors == []
    mgr.close()
    # a fresh manager over the same root must restore the newest step
    mgr2 = CheckpointManager(cpu_config(root=str(tmp_path), **cfg))
    step, got = mgr2.restore(target_tree())
    assert step == 6
    assert_tree_equal(got, state_tree(6))
    mgr2.close()


# ---------------------------------------------------------------------------
# crash-resumable flushes
# ---------------------------------------------------------------------------


def test_fresh_flush_never_reuses_a_stale_journal(tmp_path):
    """A journal left by a previous incarnation of a step describes
    different bytes: a new flush of that step must ignore it entirely
    (fresh journal) or it would skip writes and mark corrupt data
    flush_done."""
    mgr = CheckpointManager(
        cpu_config(root=str(tmp_path), cluster=theta_like(2, 2),
                   strategy="stripe_aligned", async_flush=False)
    )
    jp = mgr._journal_path(1)
    jp.parent.mkdir(parents=True, exist_ok=True)
    stale = FlushJournal(jp, flush_every=1)
    stale.record(0, 0, 1 << 30)          # "everything already written"
    stale.flush()
    st = mgr.save(1, state_tree(1))
    assert st.flush is not None
    assert st.flush.bytes_skipped == 0   # the stale cursor was discarded
    assert st.flush.bytes_written > 0
    # the PFS copy alone must round-trip (CRC-verified on arrival)
    for n in range(2):
        mgr.local.drop_node(n)
    mgr._l0 = None
    step, got = mgr.restore(target_tree(), step=1)
    assert step == 1
    assert_tree_equal(got, state_tree(1))
    mgr.close()


@pytest.mark.parametrize("async_flush", [True, False])
@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_every_flush_commits_its_write_set_before_the_first_byte(
    tmp_path, pkg, async_flush
):
    """Journaling is unconditional: when the first PFS write starts
    the step's manifest is already at ``flush_partial`` with its
    placement, and the executor holds the step's journal; once the
    flush drains the manifest reads ``flush_done`` and the journal is
    gone.  The journal's file appears only with its first batch of
    records, each a durability claim made after the data's fsync, so
    it is the journal handed to the executor that is checked.  The port
    is held to the JAX package on it."""
    import repro.core as R
    import repro_torch.core as T
    from repro_torch.utils.convert import tree_to_numpy

    core = R if pkg == "repro" else T
    man_path = tmp_path / "pfs" / "step_00000001" / "manifest.json"
    seen, journals = [], []
    lock = threading.Lock()

    def hook(_w):
        with lock:
            if not seen:
                man = core.Manifest.from_json(man_path.read_text())
                seen.append((man.status, man.placement is not None))

    cfg = dict(root=str(tmp_path), cluster=core.theta_like(2, 2),
               strategy="stripe_aligned", async_flush=async_flush)
    if pkg == "repro_torch":
        cfg["device"] = "cpu"
    mgr = core.CheckpointManager(core.CheckpointConfig(**cfg), fault_hook=hook)
    execute = mgr.executor.execute

    def spy(plan, step, **kw):
        journals.append(kw["journal"].path)
        return execute(plan, step, **kw)

    mgr.executor.execute = spy
    state = state_tree(1) if pkg == "repro_torch" else tree_to_numpy(state_tree(1))
    mgr.save(1, state)
    mgr.wait()
    assert seen == [("flush_partial", True)]
    assert journals == [mgr._journal_path(1)]
    assert core.Manifest.from_json(man_path.read_text()).status == "flush_done"
    assert not mgr._journal_path(1).exists()
    assert not mgr.flush_errors
    mgr.close()


def _pfs_payload_files(root):
    step_dirs = sorted((root / "pfs").glob("step_*"))
    out = {}
    for d in step_dirs:
        for p in sorted(d.iterdir()):
            if p.suffix == ".json" or p.name == "flush_journal.bin":
                continue
            out[f"{d.name}/{p.name}"] = p.read_bytes()
    return out


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
def test_interrupted_flush_resumes_byte_identical(tmp_path, strategy):
    """Fault-hook interruption after ~80% of the bytes: the journal
    makes resume rewrite < 25% of the checkpoint, and the resumed PFS
    tree is byte-identical to an uninterrupted flush's."""
    tree = state_tree(5)
    cluster = theta_like(4, 2)
    kw = dict(
        cluster=cluster, strategy=strategy, async_flush=False,
        verify_on_restore=True,
    )
    ref_root = tmp_path / "ref"
    mgr_ref = CheckpointManager(cpu_config(root=str(ref_root), **kw))
    mgr_ref.save(5, tree)
    mgr_ref.close()
    sizes = [r.stored_size for r in mgr_ref._manifest_pfs(5).ranks]
    total = sum(sizes)

    # deterministic interruption: exactly K of the plan's N coalesced
    # rows land, every later row fails (the hook is the serialization
    # point, so worker scheduling cannot change the journaled fraction)
    from repro_torch.core.plan import coalesce_write_columns

    n_rows = len(coalesce_write_columns(
        make_plan(strategy, cluster, sizes).ensure_arrays().writes
    ))
    k_pass = min(n_rows - 1, max(1, int(np.ceil(0.8 * n_rows))))
    seen = {"rows": 0, "armed": True}
    hook_lock = threading.Lock()

    def hook(w):
        with hook_lock:
            if seen["armed"] and seen["rows"] >= k_pass:
                raise IOError("injected interruption")
            seen["rows"] += 1

    int_root = tmp_path / "interrupted"
    mgr = CheckpointManager(
        cpu_config(root=str(int_root), **kw), fault_hook=hook
    )
    with pytest.raises(IOError):
        mgr.save(5, tree)
    man = Manifest.from_json(
        (mgr.pfs_dir / "step_00000005" / "manifest.json").read_text()
    )
    assert man.status == "flush_partial"
    assert (mgr.pfs_dir / "step_00000005" / "flush_journal.bin").exists()
    # not restorable from the PFS yet: the ladder falls back to L1
    assert mgr.steps("pfs") == []
    mgr._l0 = None
    step, got = mgr.restore(target_tree(), step=5)
    assert step == 5
    assert_tree_equal(got, state_tree(5))

    seen["armed"] = False
    results = mgr.resume_flushes()
    assert list(results) == [5]
    res = results[5]
    assert res.bytes_written + res.bytes_skipped == total
    assert res.bytes_written < 0.25 * total      # the acceptance bound
    assert res.bytes_skipped > 0.75 * total
    assert not (mgr.pfs_dir / "step_00000005" / "flush_journal.bin").exists()
    assert mgr.steps("pfs") == [5]

    assert _pfs_payload_files(int_root) == _pfs_payload_files(ref_root)
    mgr._l0 = None
    step, got = mgr.restore(target_tree(), step=5)
    assert step == 5
    assert_tree_equal(got, state_tree(5))
    mgr.close()


def test_resume_uses_partner_replicas_after_home_node_loss(tmp_path):
    """An interrupted flush must stay finishable through partner
    replicas — node loss is the exact case partner_replication covers,
    and resume reads the same L1 ladder restore does."""
    tree = state_tree(5)
    cluster = theta_like(3, 2)
    seen = {"rows": 0, "armed": True}
    hook_lock = threading.Lock()

    def hook(w):
        with hook_lock:
            if seen["armed"] and seen["rows"] >= 1:  # almost nothing lands
                raise IOError("injected interruption")
            seen["rows"] += 1

    mgr = CheckpointManager(
        cpu_config(
            root=str(tmp_path), cluster=cluster, strategy="stripe_aligned",
            async_flush=False, partner_replication=True,
        ),
        fault_hook=hook,
    )
    with pytest.raises(IOError):
        mgr.save(5, tree)
    seen["armed"] = False
    mgr.local.drop_node(0)               # home of ranks 0-1 is gone
    results = mgr.resume_flushes()
    assert list(results) == [5]
    assert mgr.steps("pfs") == [5]
    mgr._l0 = None
    for n in range(cluster.n_nodes):     # PFS-only round trip
        mgr.local.drop_node(n)
    step, got = mgr.restore(target_tree(), step=5)
    assert step == 5
    assert_tree_equal(got, state_tree(5))
    mgr.close()


def test_resume_survives_manager_restart(tmp_path):
    """Process-death shape: interrupt, build a *fresh* manager over the
    same root, resume there."""
    tree = state_tree(3)
    seen = {"rows": 0, "limit": 1 << 30}
    hook_lock = threading.Lock()

    def hook(w):
        with hook_lock:
            if seen["rows"] >= seen["limit"]:
                raise IOError("injected death")
            seen["rows"] += 1

    cfg = dict(cluster=theta_like(3, 2), strategy="stripe_aligned",
               async_flush=False)
    mgr = CheckpointManager(
        cpu_config(root=str(tmp_path), **cfg), fault_hook=hook
    )
    # step 1 flushes unimpeded (and tells us the plan's row count)
    mgr.save(1, state_tree(1))
    n_rows = seen["rows"]
    seen["rows"], seen["limit"] = 0, max(1, (2 * n_rows) // 3)
    with pytest.raises(IOError):
        mgr.save(3, tree)
    mgr.close()

    mgr2 = CheckpointManager(cpu_config(root=str(tmp_path), **cfg))
    results = mgr2.resume_flushes()
    assert list(results) == [3]
    assert results[3].bytes_skipped > 0
    assert sorted(mgr2.steps("pfs")) == [1, 3]
    step, got = mgr2.restore(target_tree())
    assert step == 3
    assert_tree_equal(got, state_tree(3))
    mgr2.close()


def test_close_enumerates_and_preserves_undrained_flushes(tmp_path, caplog):
    """The seed bug: close() joined with a timeout, then dropped the
    queue.  Now: pending steps are enumerated in an error log, the
    in-flight flush is cancelled at a request boundary with journaled
    progress, and resume_flushes() finishes it."""
    started = threading.Event()
    gate = threading.Event()

    def hook(_w):
        started.set()
        gate.wait(timeout=15)

    mgr = CheckpointManager(
        cpu_config(
            root=str(tmp_path), cluster=theta_like(32, 1), strategy="posix",
        ),
        fault_hook=hook,
    )
    small = {"x": torch.ones((32 * 1024,), dtype=torch.float32)}
    mgr.save(1, small)
    assert started.wait(timeout=10)
    with caplog.at_level(logging.ERROR, logger="repro_torch.ckpt"):
        t = threading.Thread(target=lambda: (time.sleep(0.6), gate.set()))
        t.start()
        mgr.close(timeout=0.3)
        t.join()
    msgs = [r.getMessage() for r in caplog.records]
    assert any("still busy" in m and "[1]" in m for m in msgs)
    # the interrupted flush is resumable on a fresh manager
    if 1 not in mgr.steps("pfs"):      # cancelled before completion
        assert mgr.interrupted_steps == [1]
        mgr2 = CheckpointManager(
            cpu_config(root=str(tmp_path), cluster=theta_like(32, 1),
                       strategy="posix")
        )
        assert list(mgr2.resume_flushes()) == [1]
        assert mgr2.steps("pfs") == [1]
        mgr2.close()


# ---------------------------------------------------------------------------
# interference-aware throttling
# ---------------------------------------------------------------------------


def test_real_flush_observes_flush_bw_cap(tmp_path):
    cap = 8 * MiB
    mgr = CheckpointManager(
        cpu_config(
            root=str(tmp_path), cluster=theta_like(2, 2),
            strategy="stripe_aligned", flush_bw_cap=float(cap),
        )
    )
    state = {"x": torch.zeros((MiB,), dtype=torch.float32)}   # 4 MiB
    t0 = time.perf_counter()
    st = mgr.save(1, state)
    blocking = time.perf_counter() - t0
    mgr.wait()
    assert mgr.flush_errors == []
    # 4 MiB through an 8 MiB/s bucket with a 1 MiB burst: >= ~0.3 s of
    # drain, all of it off the blocking window
    assert st.flush is not None
    assert st.flush.duration >= 0.25
    assert st.flush.throttle_wait > 0.0
    assert blocking < st.flush.duration  # save() returned before the drain
    mgr.close()


def test_app_net_load_derives_cap_policy(tmp_path):
    from repro_torch.core import NodeSpec, ClusterSpec

    cluster = ClusterSpec(
        n_nodes=2, procs_per_node=2,
        node=NodeSpec(app_net_load=0.5),
    )
    mgr = CheckpointManager(
        cpu_config(root=str(tmp_path), cluster=cluster,
                   strategy="stripe_aligned", async_flush=False)
    )
    assert mgr._limiter is not None
    expected = 2 * cluster.node.nic_bw * 0.5
    assert mgr._limiter.rate == pytest.approx(expected)
    # explicit cap wins over the derived policy
    mgr2 = CheckpointManager(
        cpu_config(root=str(tmp_path / "b"), cluster=cluster,
                   strategy="stripe_aligned", async_flush=False,
                   flush_bw_cap=123.0)
    )
    assert mgr2._limiter is not None and mgr2._limiter.rate == 123.0
    mgr.close()
    mgr2.close()


@pytest.mark.parametrize("strategy", ["stripe_aligned", "mpiio"])
def test_sim_prices_flush_bw_cap_consistently(strategy):
    """The simulator's flush_bw_cap is the same policy the executor's
    token bucket enforces: a cap well below the machine's bandwidth
    makes flush_time converge to total_bytes / cap (event-driven and
    barrier strategies alike)."""
    cluster = theta_like(8, 4)
    sizes = [4 * MiB] * cluster.world_size
    plan = make_plan(strategy, cluster, sizes)
    base = simulate_flush(plan, io_threads=4)
    cap = plan.total_bytes / (base.flush_time * 10)  # 10x slower than free
    capped = simulate_flush(plan, io_threads=4, flush_bw_cap=cap)
    assert capped.flush_bw_cap == pytest.approx(cap)
    assert capped.flush_time > base.flush_time
    assert capped.flush_time >= 0.8 * plan.total_bytes / cap
    # a cap far above the machine's bandwidth changes nothing material
    uncapped = simulate_flush(
        plan, io_threads=4, flush_bw_cap=1e3 * plan.total_bytes / base.flush_time
    )
    assert uncapped.flush_time == pytest.approx(base.flush_time, rel=0.05)


def test_concurrent_cold_start_during_flush_and_supersession(tmp_path):
    """Fleet stress: N threads cold-start from a settled step while a
    newer step's flush is mid-flight AND a supersession cancels that
    flush under them.  Every cold start must return byte-identical
    params (pinned to the settled step) and nothing may deadlock —
    reads share the executor's worker pool with the throttled writers.

    A tiny ``flush_bw_cap`` makes the mid-flight window deterministic:
    the newer flush's writers sit in ``TokenBucket.acquire`` (which a
    fired CancelToken aborts with FlushCancelled) while restore reads —
    which are never throttled — proceed on the free pool workers."""
    from repro_torch.serve.stream import stream_restore

    armed = threading.Event()
    started = threading.Event()

    def hook(_w):
        if armed.is_set():
            started.set()

    def big(step):
        return {
            "params": {"w": torch.full((1 << 20,), step, dtype=torch.float32)},
            "opt": {"mu": torch.full((64,), step, dtype=torch.float32)},
        }

    mgr = CheckpointManager(
        cpu_config(
            root=str(tmp_path), cluster=theta_like(8, 1),
            strategy="posix", supersede_stale=True,
            max_pending_flushes=2, flush_bw_cap=2 * MiB,
        ),
        fault_hook=hook,
    )
    try:
        mgr.save(1, big(1))
        mgr.wait()                          # step 1 settled on the PFS
        armed.set()
        mgr.save(2, big(2))                 # 4 MiB at 2 MiB/s: ~2 s window
        assert started.wait(timeout=10)     # step 2's flush is mid-flight

        n = 6
        results = [None] * n
        errors = []
        template = {"w": np.zeros((1 << 20,), np.float32)}

        def cold(i):
            try:
                sr = stream_restore(mgr, template, "['params']", step=1)
                results[i] = sr.params
            except Exception as e:  # pragma: no cover - failure reporting
                errors.append(e)

        threads = [threading.Thread(target=cold, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        mgr.save(3, big(3))                 # supersession fires on step 2
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "cold start deadlocked"
        mgr.wait()

        assert not errors
        ref = np.full((1 << 20,), 1, np.float32)
        for params in results:
            np.testing.assert_array_equal(params["w"], ref)
        assert mgr.flush_errors == []       # cancellation is not an error
        assert 2 in mgr.superseded_steps
        done = mgr.steps("pfs")
        assert 1 in done and 3 in done and 2 not in done
    finally:
        mgr.close()
