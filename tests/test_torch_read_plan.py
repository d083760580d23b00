"""``RealExecutor.execute_read_plan`` held against the bytes of the files
it reads: plans of many rows per request across two files, zero-size
requests, a truncated file, a transient fault under a retry policy, the
arrival hook, hedged plans whose hedge wins, the counters that say
whether the bytes were read straight into their destination or copied
there from a temporary, and a destination the caller gives (on the
card, a block of PyTorch's pinned host cache)."""
import time
from zlib import crc32

import numpy as np
import pytest
import torch

from repro_torch.core import CheckpointConfig, CheckpointManager, engine, theta_like
from repro_torch.core.faults import FaultPlan, FaultSpec
from repro_torch.core.plan import FileLayout, build_read_plan
from repro_torch.core.storage import HedgePolicy, LocalStore, RealExecutor, RetryPolicy
from repro_torch.utils import telemetry

STEP = 1
NAMES = ["a.dat", "b.dat"]


@pytest.fixture(autouse=True)
def recorder():
    telemetry.disable()
    telemetry.drain()
    yield
    telemetry.disable()
    telemetry.drain()


def two_files(tmp_path, n_extents=24, seed=0, **kw):
    """An executor over two files whose extents take turns in stored
    space; returns it, the layout and the stored bytes."""
    rng = np.random.default_rng(seed)
    size = rng.integers(1, 4096, n_extents)
    start = np.concatenate([[0], np.cumsum(size)[:-1]])
    file_id = np.arange(n_extents) % 2
    file_offset = np.zeros(n_extents, np.int64)
    for f in (0, 1):
        mine = file_id == f
        file_offset[mine] = np.concatenate([[0], np.cumsum(size[mine])[:-1]])
    stored = rng.integers(0, 256, int(size.sum()), dtype=np.uint8).tobytes()
    files = {}
    sdir = tmp_path / "pfs" / f"step_{STEP:08d}"
    sdir.mkdir(parents=True)
    for f, name in enumerate(NAMES):
        parts = [stored[a : a + n] for a, n, i in zip(start, size, file_id) if i == f]
        data = b"".join(parts)
        (sdir / name).write_bytes(data)
        files[name] = len(data)
    layout = FileLayout(
        file_names=list(NAMES), files=files, start=start, size=size,
        file_id=file_id, file_offset=file_offset, total=len(stored),
    )
    ex = RealExecutor(tmp_path / "pfs", LocalStore(tmp_path / "l1", 4), **kw)
    return ex, layout, stored


def want(stored, rp):
    return [stored[a : a + n] for a, n in zip(rp.req_start.tolist(), rp.req_size.tolist())]


def assert_bufs(bufs, rp, stored):
    assert len(bufs) == rp.n_requests
    for b, w in zip(bufs, want(stored, rp)):
        assert isinstance(b, memoryview) and not b.readonly and len(b) == len(w)
        assert bytes(b) == w


@pytest.mark.parametrize("n_readers,io_threads", [(1, 1), (4, 1), (4, 4)])
@pytest.mark.parametrize("coalesce", [True, False])
def test_many_rows_per_request_across_two_files(tmp_path, n_readers, io_threads, coalesce):
    ex, layout, stored = two_files(tmp_path, io_threads=io_threads)
    try:
        rng = np.random.default_rng(1)
        cuts = np.sort(rng.choice(np.arange(1, layout.total), 7, replace=False))
        edges = np.concatenate([[0], cuts, [layout.total]])
        starts, sizes = edges[:-1], np.diff(edges)
        order = rng.permutation(len(starts))  # requests in any order
        rp = build_read_plan(layout, starts[order], sizes[order],
                             np.arange(len(starts)) % n_readers, coalesce=coalesce)
        assert len(rp.reads) > 2 * rp.n_requests  # rows cross extents and files
        bufs, res = ex.execute_read_plan(rp, STEP)
        assert_bufs(bufs, rp, stored)
        assert res.bytes_read == layout.total and res.n_reads == len(rp.reads)
        assert res.n_readers == n_readers
    finally:
        ex.close()


def test_zero_size_requests_fire_first_and_read_nothing(tmp_path):
    ex, layout, stored = two_files(tmp_path, io_threads=1)
    try:
        seen = []

        def on_request(i, buf):
            seen.append((i, len(buf)))

        rp = build_read_plan(layout, [0, 100, 5000, 7], [0, 3000, 0, 2000])
        bufs, res = ex.execute_read_plan(rp, STEP, on_request=on_request)
        assert_bufs(bufs, rp, stored)
        assert sorted(seen[:2]) == [(0, 0), (2, 0)]  # before any pread
        assert sorted(seen[2:]) == [(1, 3000), (3, 2000)]
        assert res.bytes_read == 5000

        seen.clear()
        rp = build_read_plan(layout, [0, 9], [0, 0])
        assert len(rp.reads) == 0
        bufs, res = ex.execute_read_plan(rp, STEP, on_request=on_request)
        assert [len(b) for b in bufs] == [0, 0] and sorted(seen) == [(0, 0), (1, 0)]
        assert (res.bytes_read, res.n_reads, res.n_readers) == (0, 0, 0)
    finally:
        ex.close()


def test_truncated_file_is_a_short_read(tmp_path):
    ex, layout, _ = two_files(tmp_path, io_threads=2)
    try:
        path = ex.step_dir(STEP) / NAMES[1]
        path.write_bytes(path.read_bytes()[: layout.files[NAMES[1]] // 2])
        rp = build_read_plan(layout, [0], [layout.total], [0])
        with pytest.raises(IOError, match="short PFS read"):
            ex.execute_read_plan(rp, STEP)
    finally:
        ex.close()


def test_transient_eio_is_retried_into_the_same_buffer(tmp_path):
    faults = FaultPlan([FaultSpec(kind="transient_eio", domain="pfs", op="read",
                                  index=1, count=2, phase="verify")])
    retry = RetryPolicy(attempts=5, base_delay=0.001, max_delay=0.002, seed=0)
    ex, layout, stored = two_files(tmp_path, io_threads=2, faults=faults, retry=retry)
    try:
        faults.arm("verify")
        rp = build_read_plan(layout, [0, 9000], [9000, layout.total - 9000], [0, 1])
        bufs, res = ex.execute_read_plan(rp, STEP)
        assert_bufs(bufs, rp, stored)
        assert res.io_retries == 2 and res.io_giveups == 0
        assert [k for k, *_ in faults.fired] == ["transient_eio"] * 2
    finally:
        ex.close()


def test_on_request_fires_once_per_request_with_the_whole_buffer(tmp_path):
    ex, layout, stored = two_files(tmp_path, io_threads=4)
    try:
        step = layout.total // 6
        starts = np.arange(6) * step
        sizes = np.full(6, step)
        sizes[-1] = layout.total - starts[-1]
        rp = build_read_plan(layout, starts, sizes, np.arange(6) % 3)
        got = {}

        def on_request(i, buf):
            assert i not in got
            got[i] = (len(buf), crc32(buf))

        bufs, _ = ex.execute_read_plan(rp, STEP, on_request=on_request)
        assert got == {i: (len(w), crc32(w)) for i, w in enumerate(want(stored, rp))}
        assert_bufs(bufs, rp, stored)
    finally:
        ex.close()


@pytest.mark.parametrize("alt", ["faithful", "marked"])
def test_hedge_wins_and_the_losing_primary_never_writes(tmp_path, alt):
    """Every primary pread straggles; the hedge claims its row. With a
    ``marked`` alternate copy (each byte inverted) the claimed buffers
    must keep the hedge's bytes after the losing preads have ended."""
    delay = 0.3
    faults = FaultPlan([FaultSpec(kind="straggler", domain="pfs", op="read",
                                  node=0, delay=delay, phase="verify")])
    ex, layout, stored = two_files(tmp_path, io_threads=4, faults=faults)
    files = {f: (ex.step_dir(STEP) / n).read_bytes() for f, n in enumerate(NAMES)}

    def alt_read(fid, foff, size):
        data = files[fid][foff : foff + size]
        return data if alt == "faithful" else bytes(x ^ 0xFF for x in data)

    try:
        # four requests of one row each, one worker each
        idx = [0, 3, 6, 9]
        rp = build_read_plan(layout, layout.start[idx], layout.size[idx], [0] * 4)
        assert len(rp.reads) == 4
        faults.arm("verify")
        bufs, res = ex.execute_read_plan(
            rp, STEP, hedge=HedgePolicy(alt_read=alt_read, min_delay_s=0.01, poll_s=0.002))
        assert res.hedge_wins > 0 and res.bytes_read == int(layout.size[idx].sum())
        claimed = [bytes(b) for b in bufs]
        time.sleep(delay + 0.3)  # the losing preads end meanwhile
        assert [bytes(b) for b in bufs] == claimed
        w = want(stored, rp)
        if alt == "faithful":
            assert claimed == w
        else:
            marked = [bytes(x ^ 0xFF for x in c) == v for c, v in zip(claimed, w)]
            assert all(m or c == v for m, c, v in zip(marked, claimed, w))
            assert sum(marked) == res.hedge_wins
    finally:
        ex.close()


@pytest.mark.parametrize("hedged", [False, True])
def test_counters_say_whether_the_bytes_were_copied(tmp_path, hedged):
    ex, layout, stored = two_files(tmp_path, io_threads=2)
    files = {f: (ex.step_dir(STEP) / n).read_bytes() for f, n in enumerate(NAMES)}
    hedge = (HedgePolicy(alt_read=lambda fid, foff, size: files[fid][foff : foff + size])
             if hedged else None)
    try:
        rp = build_read_plan(layout, [0, 5000], [5000, layout.total - 5000], [0, 1])
        telemetry.enable()
        bufs, res = ex.execute_read_plan(rp, STEP, hedge=hedge)
        counts = telemetry.drain()[1]
        assert_bufs(bufs, rp, stored)
        assert res.bytes_read == layout.total
        direct, copied = (0, res.bytes_read) if hedged else (res.bytes_read, 0)
        assert counts == {"pfs.read_direct_bytes": direct, "pfs.read_copied_bytes": copied}
    finally:
        ex.close()


def test_reads_land_in_the_destination_the_caller_gives(tmp_path):
    ex, layout, stored = two_files(tmp_path, io_threads=2)
    try:
        rp = build_read_plan(layout, [0, 7000, 3000], [3000, layout.total - 7000, 4000],
                             [0, 1, 0])
        out = np.zeros(layout.total, np.uint8)
        bufs, res = ex.execute_read_plan(rp, STEP, out=out)
        assert_bufs(bufs, rp, stored)
        # the buffers are out's consecutive slices, in request order
        assert out.tobytes() == b"".join(want(stored, rp))
        for bad in (np.zeros(layout.total - 1, np.uint8), np.zeros(layout.total, np.int8),
                    np.zeros(2 * layout.total, np.uint8)[::2]):
            with pytest.raises(ValueError, match="read destination"):
                ex.execute_read_plan(rp, STEP, out=bad)
    finally:
        ex.close()


@pytest.mark.gpu
def test_restores_onto_the_card_read_into_cached_pinned_blocks(tmp_path, monkeypatch):
    """Three restores onto the card from the PFS: each read plan's
    destination is page-locked, and from the second restore on it is a
    block the first restore had pinned (its read's or its decode's),
    back from PyTorch's host cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: page-locked memory")
    state = {"w": torch.arange(300_000, dtype=torch.float32), "b": torch.ones(77)}
    cfg = dict(root=str(tmp_path), cluster=theta_like(2, 2), strategy="stripe_aligned")
    saver = CheckpointManager(CheckpointConfig(device="cpu", **cfg))
    try:
        saver.save(1, state)
        saver.wait()
        assert not saver.flush_errors
    finally:
        saver.close()
    reads, decodes = [], []
    decode_state = engine.decode_state

    def spy_decode(*args, **kw):
        decodes.append(kw["into"].data_ptr())
        return decode_state(*args, **kw)

    monkeypatch.setattr(engine, "decode_state", spy_decode)
    for _ in range(3):
        mgr = CheckpointManager(CheckpointConfig(device="cuda", **cfg))
        read = mgr.executor.execute_read_plan

        def spy_read(rp, step, **kw):
            out = kw["out"]
            reads.append((torch.from_numpy(out).is_pinned(), out.ctypes.data))
            return read(rp, step, **kw)

        mgr.executor.execute_read_plan = spy_read
        try:
            for n in range(2):
                mgr.local.drop_node(n)
            step, tree = mgr.restore({k: torch.zeros_like(v) for k, v in state.items()})
            assert step == 1
            assert all(torch.equal(tree[k].cpu(), v) for k, v in state.items())
        finally:
            mgr.close()
    assert [pinned for pinned, _ in reads] == [True] * 3 and len(decodes) == 3
    assert {ptr for _, ptr in reads[1:]} <= {reads[0][1], decodes[0]}
