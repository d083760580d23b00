"""Restore correctness properties on the port: byte-identical elastic
restore for every strategy under geometry change, and
corrupt-aggregated-file fallback to L1 (the cases of
``tests/test_restore_properties.py`` through ``repro_torch.core``, with
``device="cpu"`` managers and the same values built with torch).

These are the read-side acceptance properties from the paper's framing:
aggregated checkpoints must be *accessible as a whole* — from any
consumer geometry, and degraded gracefully when the aggregate is
damaged.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import CheckpointConfig, CheckpointManager, theta_like
from repro_torch.utils.treelib import flatten_with_names

STRATEGIES = ["file_per_process", "posix", "mpiio", "stripe_aligned", "gio_sync"]

# (save geometry, restore geometry) with M != N everywhere
GEOMETRIES = [((4, 2), (3, 1)), ((2, 3), (5, 2))]

cpu_config = functools.partial(CheckpointConfig, device="cpu")


def state_tree(step=0):
    return {
        "params": {
            "w": torch.arange(3000, dtype=torch.float32).reshape(60, 50) + step,
            "b": torch.full((64,), step, dtype=torch.bfloat16),
        },
        "opt": {"mu": torch.ones((60, 50), dtype=torch.float32) * step,
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


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("geoms", GEOMETRIES, ids=["4x2->3x1", "2x3->5x2"])
def test_elastic_restore_byte_identical(tmp_path, strategy, geoms):
    """N-rank save -> M-rank restore (M != N), PFS only, every strategy."""
    (n1, p1), (n2, p2) = geoms
    mgr = CheckpointManager(
        cpu_config(root=str(tmp_path), cluster=theta_like(n1, p1),
                   strategy=strategy)
    )
    mgr.save(7, state_tree(7))
    mgr.wait()
    assert not mgr.flush_errors
    mgr.close()

    mgr2 = CheckpointManager(
        cpu_config(root=str(tmp_path), cluster=theta_like(n2, p2),
                   strategy="posix")
    )
    for n in range(n1):
        mgr2.local.drop_node(n)  # the old allocation's L1 is gone
    step, restored = mgr2.restore(target_tree())
    assert step == 7
    assert_tree_equal(restored, state_tree(7))
    # the restore went through the aggregated ranged-read path
    rr = mgr2.last_read_result
    assert rr is not None and rr.bytes_read > 0
    assert rr.n_readers <= n2
    # partial restore agrees under the same geometry change
    s2, params = mgr2.restore_subtree(target_tree()["params"], "['params']")
    assert s2 == 7
    assert_tree_equal(params, state_tree(7)["params"])
    mgr2.close()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_corrupt_aggregated_file_falls_back_to_l1(tmp_path, strategy):
    """Flip a byte in every aggregated file: PFS restore must fail the
    CRC and fall back to the intact node-local (L1) copies."""
    mgr = CheckpointManager(
        cpu_config(root=str(tmp_path), cluster=theta_like(3, 2),
                   strategy=strategy)
    )
    mgr.save(4, state_tree(4))
    mgr.wait()
    assert not mgr.flush_errors
    for agg in (mgr.pfs_dir / "step_00000004").glob("*.dat"):
        data = bytearray(agg.read_bytes())
        if len(data):
            data[len(data) // 2] ^= 0xFF
            agg.write_bytes(bytes(data))
    mgr._l0 = None
    step, restored = mgr.restore(target_tree())
    assert step == 4                       # served from L1
    assert_tree_equal(restored, state_tree(4))
    # with L1 also gone there is nothing valid left
    for n in range(3):
        mgr.local.drop_node(n)
    with pytest.raises(FileNotFoundError):
        mgr.restore(target_tree())
    mgr.close()


def test_truncated_aggregated_file_falls_back_to_l1(tmp_path):
    """Truncation (not just bit flips) is caught as a short read."""
    mgr = CheckpointManager(
        cpu_config(root=str(tmp_path), cluster=theta_like(2, 2),
                   strategy="stripe_aligned")
    )
    mgr.save(3, state_tree(3))
    mgr.wait()
    assert not mgr.flush_errors
    agg = mgr.pfs_dir / "step_00000003" / "aggregate.dat"
    with open(agg, "r+b") as f:
        f.truncate(agg.stat().st_size // 2)
    mgr._l0 = None
    step, restored = mgr.restore(target_tree())
    assert step == 3
    assert_tree_equal(restored, state_tree(3))
    mgr.close()


def test_partial_restore_uses_partner_replica(tmp_path):
    """Node loss + no PFS copy: restore_leaves must find the partner
    replica just like the full restore path does."""
    mgr = CheckpointManager(
        cpu_config(
            root=str(tmp_path), cluster=theta_like(3, 2),
            strategy="file_per_process", partner_replication=True,
            async_flush=False,
        ),
        fault_hook=lambda w: (_ for _ in ()).throw(IOError("pfs down")),
    )
    with pytest.raises(IOError):
        mgr.save(2, state_tree(2))        # flush fails -> L1 only
    mgr.local.drop_node(1)                # and a node dies
    mgr._l0 = None
    step, got = mgr.restore_leaves(["['params']['w']"])
    assert step == 2
    np.testing.assert_array_equal(
        got["['params']['w']"], np.asarray(state_tree(2)["params"]["w"])
    )
    mgr.close()


def test_validate_scrub_flags_corrupt_rank_only(tmp_path):
    """The integrity scrub reads the PFS through one aggregated plan and
    still reports per-rank health; truncation degrades to the per-rank
    fallback without marking intact ranks unhealthy."""
    mgr = CheckpointManager(
        cpu_config(root=str(tmp_path), cluster=theta_like(2, 2),
                   strategy="file_per_process")
    )
    mgr.save(1, state_tree(1))
    mgr.wait()
    assert not mgr.flush_errors
    rep = mgr.validate(1)
    assert all(rep["pfs"].values()) and all(rep["local"].values())
    # flip a byte in rank 2's file: exactly that rank goes unhealthy
    man = mgr._manifest_pfs(1)
    fname = man.placement.by_rank()[2][0][0]
    p = mgr.pfs_dir / "step_00000001" / fname
    data = bytearray(p.read_bytes())
    data[0] ^= 0xFF
    p.write_bytes(bytes(data))
    rep = mgr.validate(1)
    assert rep["pfs"][2] is False
    assert rep["pfs"][0] and rep["pfs"][1] and rep["pfs"][3]
    # truncate it: the aggregated read fails, per-rank fallback keeps
    # the other ranks healthy
    with open(p, "r+b") as f:
        f.truncate(1)
    rep = mgr.validate(1)
    assert rep["pfs"][2] is False
    assert rep["pfs"][0] and rep["pfs"][1] and rep["pfs"][3]
    mgr.close()


# ---------------------------------------------------------------------------
# property test: random geometries and leaf shapes (hypothesis-gated)
# ---------------------------------------------------------------------------

try:  # the rest of the module must still run without hypothesis
    from hypothesis import HealthCheck, given, settings, strategies as st

    _HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - optional test dep
    _HAVE_HYPOTHESIS = False


if _HAVE_HYPOTHESIS:

    @settings(
        max_examples=8, deadline=None,
        suppress_health_check=[HealthCheck.function_scoped_fixture],
    )
    @given(
        n1=st.integers(1, 4), p1=st.integers(1, 3),
        n2=st.integers(1, 4), p2=st.integers(1, 3),
        strategy=st.sampled_from(STRATEGIES),
        n_elems=st.integers(1, 5000),
        seed=st.integers(0, 2**31 - 1),
    )
    def test_restore_roundtrip_random_geometry(
        tmp_path_factory, n1, p1, n2, p2, strategy, n_elems, seed
    ):
        rng = np.random.default_rng(seed)
        state = {
            "a": torch.from_numpy(rng.standard_normal(n_elems).astype(np.float32)),
            # int32, as jnp.asarray gives it without x64
            "b": torch.from_numpy(
                rng.integers(0, 1 << 30, max(1, n_elems // 7), np.int64).astype(np.int32)
            ),
        }
        target = state
        root = tmp_path_factory.mktemp("ckpt")
        mgr = CheckpointManager(
            cpu_config(root=str(root), cluster=theta_like(n1, p1),
                       strategy=strategy, async_flush=False)
        )
        mgr.save(1, state)
        assert not mgr.flush_errors
        mgr.close()
        mgr2 = CheckpointManager(
            cpu_config(root=str(root), cluster=theta_like(n2, p2),
                       strategy="file_per_process")
        )
        for n in range(n1):
            mgr2.local.drop_node(n)
        step, restored = mgr2.restore(target)
        assert step == 1
        assert_tree_equal(restored, target)
        mgr2.close()
