"""Columnar planner equivalence on the port: PlanArrays builders == seed
item planners, and the port's item planners == the JAX package's.

The cases of ``tests/test_plan_arrays.py`` run through ``repro_torch``:
the columnar strategy builders in repro_torch.core.strategies must
produce byte-identical coalesced write/send sets to the item-loop
planners in repro_torch.core.strategies_ref, for every strategy, on
small clusters covering mixed sizes, zero-size ranks and loaded nodes;
PlanArrays <-> item-list round-trips must be lossless, and the columnar
validate_plan must accept/reject exactly like the item-loop reference
validator. Then, for every strategy and each of those clusters, the
port's ``make_plan_reference`` and ``repro``'s produce equal coalesced
write/send sets, files, rounds and meta (tolerance zero).
"""
import numpy as np
import pytest

import repro.core as R
import repro.core.strategies_ref as R_ref
from repro_torch.core import (
    PlanArrays,
    make_plan,
    theta_like,
    validate_plan,
    validate_plan_reference,
)
from repro_torch.core.plan import (
    PlanError,
    SendItem,
    WriteItem,
    coalesce_send_columns,
    coalesce_write_columns,
)
from repro_torch.core.strategies import STRATEGIES
from repro_torch.core.strategies_ref import (
    REFERENCE_STRATEGIES,
    _coalesce_sends_ref,
    _coalesce_writes_ref,
    make_plan_reference,
)

MiB = 1 << 20


def _wkey(w: WriteItem):
    return (w.round, w.backend, w.file, w.file_offset, w.size, w.src_rank, w.src_offset)


def _skey(s: SendItem):
    return (s.round, s.src_backend, s.dst_backend, s.src_rank, s.src_offset, s.size)


def _clusters_and_sizes(theta_like=theta_like):
    rng = np.random.default_rng(7)
    cases = []
    for nodes, ppn in [(4, 3), (5, 2), (1, 1), (2, 4)]:
        c = theta_like(nodes, ppn)
        n = c.world_size
        cases.append((c, [4 * MiB] * n, "uniform"))
        cases.append((c, [(i % 5 + 1) * MiB + i * 1000 + 1 for i in range(n)], "ragged"))
        cases.append((c, [0 if i % 3 == 0 else 2 * MiB + i for i in range(n)], "zeros"))
        cases.append((c, rng.integers(0, 5 * MiB, n).tolist(), "random"))
    # loaded nodes exercise election criterion 2 and capacity regions
    c = theta_like(6, 2).with_(node_load=[0.7, 0.0, 0.3, 0.0, 0.9, 0.0])
    n = c.world_size
    cases.append((c, rng.integers(MiB, 8 * MiB, n).tolist(), "loaded"))
    cases.append((c, [0] * n, "allzero"))
    return cases


CASES = _clusters_and_sizes()
KWARGS = {
    "file_per_process": [{}],
    "posix": [{}, {"write_chunk": 700_001}],
    "mpiio": [{}, {"chunk_stripes": 3}],
    "stripe_aligned": [{}, {"pipeline_chunk": 3 * MiB},
                       {"n_leaders": 2, "capacity_regions": True}],
    "gio_sync": [{}, {"chunk_stripes": 2}],
}


def test_registry_parity():
    assert sorted(STRATEGIES) == sorted(REFERENCE_STRATEGIES)


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_columnar_matches_reference(strategy):
    for c, sizes, tag in CASES:
        for kw in KWARGS[strategy]:
            got = make_plan(strategy, c, sizes, **kw)
            ref = make_plan_reference(strategy, c, sizes, **kw)
            ctx = f"{strategy}/{tag}/{kw}/{c.n_nodes}x{c.procs_per_node}"
            assert sorted(map(_wkey, got.writes)) == sorted(map(_wkey, ref.writes)), ctx
            assert sorted(map(_skey, got.sends)) == sorted(map(_skey, ref.sends)), ctx
            assert got.files == ref.files, ctx
            assert got.n_rounds == ref.n_rounds and got.meta == ref.meta, ctx
            # both validators accept both plans
            validate_plan_reference(got)
            validate_plan(ref)


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_plan_arrays_roundtrip_lossless(strategy):
    c = theta_like(4, 3)
    sizes = [(i % 4 + 1) * MiB + 37 * i for i in range(c.world_size)]
    plan = make_plan(strategy, c, sizes)
    pa = plan.ensure_arrays()
    # arrays -> items -> arrays -> items is identity
    items_w, items_s = pa.to_write_items(), pa.to_send_items()
    pa2 = PlanArrays.from_items(items_w, items_s, file_names=pa.file_names)
    assert pa2.file_names == pa.file_names
    for col in ("backend", "file_id", "file_offset", "size", "src_rank",
                "src_offset", "round"):
        np.testing.assert_array_equal(getattr(pa2.writes, col), getattr(pa.writes, col))
    for col in ("src_backend", "dst_backend", "src_rank", "src_offset",
                "size", "round"):
        np.testing.assert_array_equal(getattr(pa2.sends, col), getattr(pa.sends, col))
    assert pa2.to_write_items() == items_w
    assert pa2.to_send_items() == items_s


def test_columnar_coalesce_matches_reference():
    rng = np.random.default_rng(11)
    for trial in range(20):
        writes, sends = [], []
        pos = {}
        for _ in range(rng.integers(1, 60)):
            backend = int(rng.integers(0, 3))
            rank = int(rng.integers(0, 4))
            rnd = int(rng.integers(0, 2))
            key = (backend, rank, rnd)
            off = pos.get(key, 0)
            # randomly leave gaps so only some neighbours merge
            off += int(rng.integers(0, 2)) * 100
            size = int(rng.integers(1, 50))
            writes.append(WriteItem(backend=backend, file="f", file_offset=off,
                                    size=size, src_rank=rank, src_offset=off,
                                    round=rnd))
            sends.append(SendItem(src_backend=backend, dst_backend=(backend + 1) % 3,
                                  src_rank=rank, src_offset=off, size=size,
                                  round=rnd))
            pos[key] = off + size
        pa = PlanArrays.from_items(writes, sends, file_names=["f"])
        got_w = PlanArrays(pa.file_names, coalesce_write_columns(pa.writes),
                           pa.sends).to_write_items()
        got_s = PlanArrays(pa.file_names, pa.writes,
                           coalesce_send_columns(pa.sends)).to_send_items()
        assert sorted(map(_wkey, got_w)) == sorted(map(_wkey, _coalesce_writes_ref(writes)))
        assert sorted(map(_skey, got_s)) == sorted(map(_skey, _coalesce_sends_ref(sends)))


# ---------------------------------------------------------------------------
# Validator agreement: columnar validate_plan rejects exactly what the
# item-loop reference rejects.
# ---------------------------------------------------------------------------


def _fresh(strategy="stripe_aligned", **kw):
    c = theta_like(4, 2)
    sizes = [(i % 3 + 1) * MiB for i in range(c.world_size)]
    return make_plan_reference(strategy, c, sizes, **kw)


def _both_reject(plan):
    with pytest.raises(PlanError):
        validate_plan_reference(plan)
    # no cache reset needed: validate_plan re-reads mutated item lists
    with pytest.raises(PlanError):
        validate_plan(plan)


def test_validators_agree_on_good_plans():
    for strategy in sorted(STRATEGIES):
        plan = _fresh(strategy)
        validate_plan_reference(plan)
        validate_plan(plan)


def test_validate_rereads_mutated_items():
    # mutating the item view after a validate must not be masked by the
    # cached columnar arrays
    plan = _fresh("posix")
    validate_plan(plan)  # caches plan.arrays
    plan.writes.pop()
    with pytest.raises(PlanError):
        validate_plan(plan)


def test_validate_rereads_mutated_sends():
    plan = _fresh("mpiio")
    validate_plan(plan)
    assert plan.sends
    plan.sends.pop()  # mutate only the sends view
    with pytest.raises(PlanError):
        validate_plan(plan)


def test_validate_after_partial_materialization():
    # touching only .writes on a columnar-built plan must not make the
    # validator forget the (never-materialized) sends
    c = theta_like(4, 4)
    plan = make_plan("stripe_aligned", c, [1000] * c.world_size)
    assert plan.arrays.n_sends > 0
    _ = plan.writes  # materialize writes only
    validate_plan(plan)  # must still pass


def test_validators_reject_missing_write():
    plan = _fresh()
    plan.writes.pop()
    _both_reject(plan)


def test_validators_reject_src_overlap():
    plan = _fresh()
    w = plan.writes[0]
    plan.writes.append(WriteItem(backend=w.backend, file=w.file,
                                 file_offset=w.file_offset + (1 << 40),
                                 size=w.size, src_rank=w.src_rank,
                                 src_offset=w.src_offset, round=w.round))
    plan.files[w.file] = (1 << 40) + plan.files[w.file]
    _both_reject(plan)


def test_validators_reject_file_overlap():
    plan = _fresh("posix")
    w = plan.writes[1]
    plan.writes[1] = WriteItem(backend=w.backend, file=w.file,
                               file_offset=plan.writes[0].file_offset,
                               size=w.size, src_rank=w.src_rank,
                               src_offset=w.src_offset, round=w.round)
    _both_reject(plan)


def test_validators_reject_undeclared_file():
    plan = _fresh("file_per_process")
    w = plan.writes[0]
    plan.writes[0] = WriteItem(backend=w.backend, file="ghost.dat",
                               file_offset=w.file_offset, size=w.size,
                               src_rank=w.src_rank, src_offset=w.src_offset)
    _both_reject(plan)


def test_validators_reject_write_past_declared_size():
    plan = _fresh("posix")
    fname = next(iter(plan.files))
    plan.files[fname] -= 1
    _both_reject(plan)


def test_validators_reject_missing_send():
    plan = _fresh("mpiio")
    assert plan.sends
    plan.sends.pop()
    _both_reject(plan)


def test_validators_reject_send_from_wrong_home():
    plan = _fresh("mpiio")
    s = plan.sends[0]
    plan.sends[0] = SendItem(src_backend=(s.src_backend + 1) % 4,
                             dst_backend=s.dst_backend, src_rank=s.src_rank,
                             src_offset=s.src_offset, size=s.size, round=s.round)
    _both_reject(plan)


def test_validators_reject_false_stripe_disjoint_claim():
    c = theta_like(4, 2)
    sizes = [3 * MiB + 12345] * c.world_size  # unaligned => stripes shared
    plan = make_plan_reference("posix", c, sizes)
    plan.stripe_disjoint = True  # false claim -> both validators must catch
    _both_reject(plan)


def test_validators_reject_bad_rank():
    plan = _fresh("file_per_process")
    w = plan.writes[0]
    plan.writes[0] = WriteItem(backend=w.backend, file=w.file,
                               file_offset=w.file_offset, size=w.size,
                               src_rank=10_000, src_offset=w.src_offset)
    _both_reject(plan)


# ---------------------------------------------------------------------------
# Cross-package: the port's item-loop planners equal the JAX package's.
# ---------------------------------------------------------------------------

JAX_CASES = _clusters_and_sizes(R.theta_like)


def _plan_key(plan):
    return (sorted(map(_wkey, plan.writes)), sorted(map(_skey, plan.sends)),
            dict(plan.files), plan.n_rounds, plan.meta)


def test_reference_registries_equal():
    assert sorted(REFERENCE_STRATEGIES) == sorted(R_ref.REFERENCE_STRATEGIES)


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_reference_planners_equal_across_packages(strategy):
    for (c, sizes, tag), (rc, rsizes, _) in zip(CASES, JAX_CASES):
        assert sizes == rsizes
        for kw in KWARGS[strategy]:
            got = make_plan_reference(strategy, c, sizes, **kw)
            ref = R_ref.make_plan_reference(strategy, rc, rsizes, **kw)
            ctx = f"{strategy}/{tag}/{kw}/{c.n_nodes}x{c.procs_per_node}"
            assert _plan_key(got) == _plan_key(ref), ctx
            assert got.stripe_disjoint == ref.stripe_disjoint, ctx


def test_reference_coalescers_equal_across_packages():
    rng = np.random.default_rng(11)
    for trial in range(20):
        writes, sends = [], []
        for _ in range(rng.integers(1, 60)):
            backend, rank = int(rng.integers(0, 3)), int(rng.integers(0, 4))
            rnd, off = int(rng.integers(0, 2)), int(rng.integers(0, 400))
            size = int(rng.integers(1, 50))
            writes.append(WriteItem(backend=backend, file="f", file_offset=off,
                                    size=size, src_rank=rank, src_offset=off,
                                    round=rnd))
            sends.append(SendItem(src_backend=backend, dst_backend=(backend + 1) % 3,
                                  src_rank=rank, src_offset=off, size=size,
                                  round=rnd))
        rw = [R.WriteItem(**w.__dict__) for w in writes]
        rs = [R.SendItem(**x.__dict__) for x in sends]
        assert (sorted(map(_wkey, _coalesce_writes_ref(writes)))
                == sorted(map(_wkey, R_ref._coalesce_writes_ref(rw))))
        assert (sorted(map(_skey, _coalesce_sends_ref(sends)))
                == sorted(map(_skey, R_ref._coalesce_sends_ref(rs))))
