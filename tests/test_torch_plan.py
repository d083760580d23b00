"""Flush plans, validation, file layouts and read plans are the same in
the port as in the JAX package, on the seeded geometries of
tests/test_plan_arrays.py and tests/test_read_plan.py."""
import numpy as np
import pytest

import repro.core as R
import repro.core.plan as RP
import repro_torch.core as T
import repro_torch.core.plan as TP

MiB = 1 << 20
STRATEGIES = ["file_per_process", "posix", "mpiio", "stripe_aligned", "gio_sync"]
W_COLS = ("backend", "file_id", "file_offset", "size", "src_rank", "src_offset", "round")
S_COLS = ("src_backend", "dst_backend", "src_rank", "src_offset", "size", "round")
R_COLS = ("reader", "file_id", "file_offset", "size", "dst_req", "dst_offset")
KWARGS = {
    "file_per_process": [{}],
    "posix": [{}, {"write_chunk": 700_001}],
    "mpiio": [{}, {"chunk_stripes": 3}],
    "stripe_aligned": [{}, {"pipeline_chunk": 3 * MiB},
                       {"n_leaders": 2, "capacity_regions": True}],
    "gio_sync": [{}, {"chunk_stripes": 2}],
}
READ_SIZES = [3_000_001, 1_500_000, 0, 2_000_000, 777, 4_000_000, 123_456, 999_999]


def _cases(pkg):
    """tests/test_plan_arrays.py::_clusters_and_sizes, per package."""
    rng = np.random.default_rng(7)
    cases = []
    for nodes, ppn in [(4, 3), (5, 2), (1, 1), (2, 4)]:
        c = pkg.theta_like(nodes, ppn)
        n = c.world_size
        cases.append((c, [4 * MiB] * n))
        cases.append((c, [(i % 5 + 1) * MiB + i * 1000 + 1 for i in range(n)]))
        cases.append((c, [0 if i % 3 == 0 else 2 * MiB + i for i in range(n)]))
        cases.append((c, rng.integers(0, 5 * MiB, n).tolist()))
    c = pkg.theta_like(6, 2).with_(node_load=[0.7, 0.0, 0.3, 0.0, 0.9, 0.0])
    cases.append((c, rng.integers(MiB, 8 * MiB, c.world_size).tolist()))
    cases.append((c, [0] * c.world_size))
    return cases


def _assert_cols(a, b, cols, ctx):
    for col in cols:
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col), err_msg=f"{ctx}/{col}")


def _assert_plans_equal(ref, got, ctx):
    pa, pb = ref.ensure_arrays(), got.ensure_arrays()
    assert pa.file_names == pb.file_names, ctx
    _assert_cols(pa.writes, pb.writes, W_COLS, ctx)
    _assert_cols(pa.sends, pb.sends, S_COLS, ctx)
    assert ref.files == got.files, ctx
    assert ref.n_rounds == got.n_rounds and ref.meta == got.meta, ctx


def _assert_layouts_equal(a, b, ctx):
    assert a.file_names == b.file_names and a.files == b.files, ctx
    _assert_cols(a, b, ("start", "size", "file_id", "file_offset"), ctx)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_flush_plans_and_layouts_match(strategy):
    for (rc, sizes), (tc, _) in zip(_cases(R), _cases(T)):
        for kw in KWARGS[strategy]:
            ctx = f"{strategy}/{kw}/{rc.n_nodes}x{rc.procs_per_node}/{sizes[:2]}"
            ref = R.make_plan(strategy, rc, sizes, **kw)
            got = T.make_plan(strategy, tc, sizes, **kw)
            _assert_plans_equal(ref, got, ctx)
            R.validate_plan(ref)
            T.validate_plan(got)
            T.validate_plan_reference(got)
            if sum(sizes):
                _assert_layouts_equal(
                    R.FileLayout.from_flush_plan(ref),
                    T.FileLayout.from_flush_plan(got),
                    ctx,
                )


def _fresh(pkg, strategy):
    c = pkg.theta_like(4, 2)
    return pkg.make_plan(strategy, c, [(i % 3 + 1) * MiB for i in range(c.world_size)])


def _drop_write(plan):
    plan.writes.pop()


def _move_write(plan):
    w = plan.writes[1]
    plan.writes[1] = type(w)(
        backend=w.backend, file=w.file, file_offset=plan.writes[0].file_offset,
        size=w.size, src_rank=w.src_rank, src_offset=w.src_offset, round=w.round,
    )


def _ghost_file(plan):
    w = plan.writes[0]
    plan.writes[0] = type(w)(
        backend=w.backend, file="ghost.dat", file_offset=w.file_offset,
        size=w.size, src_rank=w.src_rank, src_offset=w.src_offset,
    )


@pytest.mark.parametrize("strategy", ["posix", "mpiio", "stripe_aligned"])
@pytest.mark.parametrize("break_it", [None, _drop_write, _move_write, _ghost_file])
def test_validators_agree_across_packages(strategy, break_it):
    verdicts = []
    for pkg, plan_mod in ((R, RP), (T, TP)):
        plan = _fresh(pkg, strategy)
        if break_it is not None:
            break_it(plan)
        verdict = []
        for validate in (pkg.validate_plan, pkg.validate_plan_reference):
            try:
                validate(plan)
                verdict.append("ok")
            except plan_mod.PlanError:
                verdict.append("rejected")
        verdicts.append(verdict)
    assert verdicts[0] == verdicts[1]
    assert verdicts[0] == (["ok", "ok"] if break_it is None else ["rejected"] * 2)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_read_plans_match(strategy):
    rng = np.random.default_rng(7)
    layouts = []
    for pkg in (R, T):
        plan = pkg.make_plan(strategy, pkg.theta_like(4, 2), READ_SIZES, chunk_stripes=4)
        layouts.append(pkg.FileLayout.from_flush_plan(plan))
    _assert_layouts_equal(*layouts, strategy)
    total = layouts[0].total
    starts = np.sort(rng.integers(0, total, 40)).astype(np.int64)
    sz = np.minimum(rng.integers(0, 200_000, 40), total - starts).astype(np.int64)
    starts = np.concatenate([starts, [0, 0]])
    sz = np.concatenate([sz, [0, total]])
    readers = rng.integers(0, 3, len(starts))
    rps = []
    for pkg, layout in zip((R, T), layouts):
        rp = pkg.build_read_plan(layout, starts, sz, readers)
        pkg.validate_read_plan(rp, layout)
        rps.append(rp)
    a, b = rps
    assert a.file_names == b.file_names and a.files == b.files
    _assert_cols(a.reads, b.reads, R_COLS, strategy)
    for col in ("req_start", "req_size", "req_reader"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))
    assert a.meta == b.meta
    offs = R.stored_space_offsets(READ_SIZES)
    np.testing.assert_array_equal(offs, T.stored_space_offsets(READ_SIZES))
    np.testing.assert_array_equal(
        R.assign_readers(READ_SIZES, 3), T.assign_readers(READ_SIZES, 3)
    )
