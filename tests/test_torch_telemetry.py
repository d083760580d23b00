"""``repro_torch.utils.telemetry``: the recorder alone, then its spans and
counters inside a CPU ``CheckpointManager``'s stage, save, flush and
restore, and inside ``build_train_step``."""
import threading

import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs import get_smoke_config
from repro_torch.core import CheckpointConfig, CheckpointManager, theta_like
from repro_torch.core.engine import pinned_restore
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import get_model
from repro_torch.train import OptConfig, TrainConfig, build_train_step, init_train_state
from repro_torch.utils import telemetry
from repro_torch.utils.treelib import tree_leaves

CHUNK = 16 * 1024


@pytest.fixture(autouse=True)
def recorder():
    telemetry.disable()
    telemetry.drain()
    yield
    telemetry.disable()
    telemetry.drain()


def secs(sp):
    return (sp.end_ns - sp.start_ns) / 1e9


def by_name(spans):
    out = {}
    for sp in spans:
        out.setdefault(sp.name, []).append(sp)
    return out


# -- the recorder -------------------------------------------------------------


def test_off_records_nothing_and_span_is_the_shared_noop():
    assert not telemetry.enabled()
    a, b = telemetry.span("x", step=3), telemetry.span("y")
    assert a is telemetry.NOOP and b is telemetry.NOOP
    with a:
        telemetry.count("c", 5)
    with telemetry.Timer("t", step=1) as t:
        pass
    assert t.seconds >= 0 and t.end_ns >= t.start_ns > 0
    assert telemetry.drain() == ([], {})


def test_nesting_gives_parents_threads_and_steps():
    telemetry.enable()
    with telemetry.span("outer", step=7):
        with telemetry.span("inner"):
            with telemetry.Timer("innermost", step=8):
                pass
        seen = {}

        def other():
            with telemetry.span("elsewhere", step=7):
                pass
            seen["thread"] = threading.get_ident()

        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    telemetry.count("n", 2)
    telemetry.count("n", 3)
    spans, counts = telemetry.drain()
    s = {sp.name: sp for sp in spans}
    assert set(s) == {"outer", "inner", "innermost", "elsewhere"}
    me = threading.get_ident()
    assert s["outer"].parent is None and s["outer"].step == 7
    assert s["inner"].parent == s["outer"].id and s["inner"].step is None
    assert s["innermost"].parent == s["inner"].id and s["innermost"].step == 8
    assert {s[n].thread for n in ("outer", "inner", "innermost")} == {me}
    assert s["elsewhere"].thread == seen["thread"] != me
    assert s["elsewhere"].parent is None and s["elsewhere"].step == 7
    assert len({sp.id for sp in spans}) == 4
    assert s["outer"].start_ns <= s["inner"].start_ns <= s["innermost"].start_ns
    assert s["innermost"].end_ns <= s["inner"].end_ns <= s["outer"].end_ns
    assert counts == {"n": 5}


def test_switching_inside_a_span_records_only_what_began_and_ended_on():
    with telemetry.Timer("begun off") as off:
        telemetry.enable()
        with telemetry.span("inner") as inner:
            telemetry.disable()
        with telemetry.span("after"):
            pass
    telemetry.enable()
    with telemetry.span("next"):
        pass
    (sp,), _ = telemetry.drain()
    # neither the span begun while off nor the one ended while off, and
    # the thread's stack of open spans is left empty
    assert sp.name == "next" and sp.parent is None
    assert off.seconds >= inner.seconds >= 0


def test_a_profiler_session_records_while_it_runs():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert telemetry.enabled()
        with telemetry.span("traced", step=1):
            telemetry.count("c", 2)
    assert not telemetry.enabled()
    assert telemetry.span("after") is telemetry.NOOP
    spans, counts = telemetry.drain()
    assert [(sp.name, sp.step) for sp in spans] == [("traced", 1)] and counts == {"c": 2}


def test_a_timer_without_a_name_is_a_clock_alone():
    telemetry.enable()
    with telemetry.span("outer"):
        with telemetry.Timer() as clock:
            with telemetry.span("inner"):
                pass
    spans, counts = telemetry.drain()
    s = {sp.name: sp for sp in spans}
    assert set(s) == {"outer", "inner"} and counts == {}
    assert s["inner"].parent == s["outer"].id
    assert clock.seconds >= secs(s["inner"]) >= 0


def test_drain_empties_and_the_buffer_stays_bounded():
    telemetry.enable()
    for _ in range(telemetry.MAX_SPANS + 10):
        with telemetry.span("s"):
            pass
    telemetry.count("c", 1)
    spans, counts = telemetry.drain()
    assert len(spans) == telemetry.MAX_SPANS and counts == {"c": 1}
    assert spans[0].id < spans[-1].id    # the newest are kept
    assert telemetry.drain() == ([], {})
    telemetry.disable()
    with telemetry.span("late"):
        telemetry.count("c", 1)
    assert telemetry.drain() == ([], {})


# -- the checkpoint path ------------------------------------------------------


def state(step):
    g = torch.Generator().manual_seed(step)
    return {
        "params": {"w": torch.randn(96, 300, generator=g),
                   "b": torch.full((37,), 0.5 * step)},
        "opt": {"count": torch.tensor(step, dtype=torch.int32)},
    }


def manager(root):
    return CheckpointManager(CheckpointConfig(
        root=str(root), cluster=theta_like(2, 2), device="cpu",
        device_precodec=True, codec="zstd+delta", chunk_size=CHUNK,
        strategy="stripe_aligned"))


def staged_save(mgr, step, tree):
    mgr.stage(step, tree)
    st = mgr.save(step, tree)
    mgr.wait()
    return st, telemetry.drain()


def test_save_and_flush_spans_and_counters(tmp_path):
    mgr = manager(tmp_path)
    try:
        telemetry.enable()
        me = threading.get_ident()
        for step in (1, 2):
            st, (spans, counts) = staged_save(mgr, step, state(step))
            s = by_name(spans)
            assert {n: len(v) for n, v in s.items()} == {
                "stage": 1, "stage.device_pass": 1, "save": 1, "save.wait_staged": 1,
                "save.encode": 1, "save.l1_sync": 1, "flush": 1}
            s = {n: v[0] for n, v in s.items()}
            assert all(sp.step == step for sp in s.values())
            for n in ("stage", "save", "save.wait_staged", "save.encode", "save.l1_sync"):
                assert s[n].thread == me, n
            assert s["stage.device_pass"].thread != me and s["flush"].thread != me
            assert s["stage"].parent is None and s["save"].parent is None
            assert s["save.encode"].parent == s["save"].id
            assert s["save.l1_sync"].parent == s["save"].id
            assert s["save.wait_staged"].parent == s["save.encode"].id
            assert s["stage.device_pass"].parent is None and s["flush"].parent is None
            assert s["save.encode"].end_ns <= s["save.l1_sync"].start_ns
            # one pair of clock reads for each stats field and its span
            assert st.encode_time == secs(s["save.encode"])
            assert st.local_time == secs(s["save.l1_sync"])
            assert st.stage_s == secs(s["stage.device_pass"])
            assert st.stage_wait_s == secs(s["save.wait_staged"])
            n_chunks = -(-st.raw_bytes // CHUNK)
            dirty = n_chunks if step == 1 else counts["stage.dirty_chunks"]
            assert 0 < dirty <= n_chunks
            assert counts == {"stage.dirty_chunks": dirty}
            # the executor's writes, inside the flush job
            assert 0 < st.flush.duration <= secs(s["flush"])
    finally:
        mgr.close()


def test_sync_flush_span_nests_in_the_save(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(
        root=str(tmp_path), cluster=theta_like(2, 2), device="cpu", async_flush=False))
    try:
        telemetry.enable()
        st = mgr.save(4, state(4))
        spans, counts = telemetry.drain()
    finally:
        mgr.close()
    s = {sp.name: sp for sp in spans}
    assert set(s) == {"save", "save.encode", "save.l1_sync", "flush"}
    assert s["flush"].parent == s["save"].id and s["flush"].step == 4
    assert counts == {} and st.flush.bytes_written > 0


def test_restore_spans_and_counters(tmp_path):
    saver = manager(tmp_path)
    try:
        stats = [saver.save(step, state(step)) for step in (1, 2)]
        saver.wait()
        assert stats[1].flush is not None
    finally:
        saver.close()
    mgr = manager(tmp_path)
    try:
        for n in range(2):
            mgr.local.drop_node(n)
        telemetry.enable()
        me = threading.get_ident()
        for step, base in ((1, None), (2, 1)):
            got, tree = mgr.restore(state(0), step=step)
            spans, counts = telemetry.drain()
            assert got == step
            s = by_name(spans)
            want = {"restore": 1, "restore.read": 1 if base is None else 2,
                    "restore.decode": 1, "restore.place": 1}
            if base is not None:
                want["restore.base"] = 1
            assert {n: len(v) for n, v in s.items()} == want
            assert all(sp.thread == me for sp in spans)
            top = s["restore"][0]
            assert top.parent is None and top.step == step
            dec, place = s["restore.decode"][0], s["restore.place"][0]
            assert dec.parent == place.parent == top.id
            assert dec.step == place.step == step
            reads = sorted(s["restore.read"], key=lambda sp: sp.start_ns)
            assert reads[0].parent == top.id and reads[0].step == step
            if base is not None:
                b = s["restore.base"][0]
                assert b.parent == top.id and b.step == base
                assert reads[1].parent == b.id and reads[1].step == base
            rr = mgr.last_read_result
            assert 0 < rr.duration <= secs(reads[-1])
            # every byte of both read plans (a delta's and its base's)
            # preadv'd straight into its destination
            read = sum(stats[k - 1].stored_bytes for k in (step, base) if k is not None)
            assert counts == {"restore.h2d_bytes": sum(t.nbytes for t in tree_leaves(tree)),
                              "pfs.read_direct_bytes": read, "pfs.read_copied_bytes": 0}
            assert rr.bytes_read == stats[0].stored_bytes   # a delta's base is read last
        # a scrub's reads are no restore's
        report = mgr.validate(2)
        assert report["pfs"] and all(report["pfs"].values())
        assert [sp.name for sp in telemetry.drain()[0]] == []
    finally:
        mgr.close()


def test_pinned_restore_only_where_the_host_tree_is_transient():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert pinned_restore(cuda, None, "none")
    assert not pinned_restore(cpu, None, "none")
    assert not pinned_restore(cuda, lambda name, t: t, "none")
    assert not pinned_restore(cuda, None, "int8")


@pytest.mark.gpu
def test_restores_onto_the_card_decode_into_pinned_views(tmp_path):
    """Two restores in a row onto the card (an anchor, then a delta of
    it): byte-exact, every host leaf a view of the pinned block the
    chunks decoded into, and the three counters equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: page-locked memory and the copy to the card")
    saver = manager(tmp_path)
    try:
        stats = [saver.save(step, state(step)) for step in (1, 2)]
        saver.wait()
        assert not saver.flush_errors
    finally:
        saver.close()
    mgr = CheckpointManager(CheckpointConfig(
        root=str(tmp_path), cluster=theta_like(2, 2), device="cuda",
        codec="zstd+delta", chunk_size=CHUNK, strategy="stripe_aligned"))
    hosts = []
    place = mgr._place

    def spy(tree, sharding_fn, step=None):
        hosts.append(tree_leaves(tree))
        return place(tree, sharding_fn, step)

    mgr._place = spy
    try:
        for n in range(2):
            mgr.local.drop_node(n)
        telemetry.enable()
        for step in (1, 2):
            got, tree = mgr.restore(state(0), step=step)
            counts = telemetry.drain()[1]
            assert got == step
            want = tree_leaves(state(step))
            placed = tree_leaves(tree)
            assert all(t.device.type == "cuda" for t in placed)
            assert all(torch.equal(a.cpu(), b) for a, b in zip(placed, want))
            assert all(t.is_pinned() for t in hosts[-1])
            assert len({t.untyped_storage().data_ptr() for t in hosts[-1]}) == 1
            n = sum(t.nbytes for t in want)
            read = sum(stats[k].stored_bytes for k in range(step))  # step 2 reads its base too
            assert counts == {"restore.h2d_bytes": n, "restore.view_bytes": n,
                              "restore.pinned_bytes": n,
                              "pfs.read_direct_bytes": read, "pfs.read_copied_bytes": 0}
    finally:
        mgr.close()


# -- the train step -----------------------------------------------------------


class _Ops(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


def test_train_step_spans_and_no_device_reads():
    model = get_model(get_smoke_config("tinyllama-1.1b"))
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3))
    batch = SyntheticTokens(DataConfig(vocab_size=256, seq_len=16, global_batch=2),
                            device="cpu").next()
    step = build_train_step(model, tcfg)
    ops = {}
    for on in (False, True):
        if on:
            telemetry.enable()
        st = init_train_state(model, torch.Generator().manual_seed(0), tcfg, "cpu")
        with _Ops() as mode:
            step(st, batch)
        ops[on] = mode.names
    spans, counts = telemetry.drain()
    # the recorder adds no tensor operation: nothing read from the device
    assert ops[True] == ops[False] and len(ops[True]) > 0
    assert [sp.name for sp in spans] == ["train.loss_and_grads", "train.update"]
    assert all(sp.step is None and sp.parent is None for sp in spans)
    assert spans[0].end_ns <= spans[1].start_ns and counts == {}
