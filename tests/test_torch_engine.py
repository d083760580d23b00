"""Cross-package checkpoint round trips: a step saved by either package
restores byte-identically in the other.

Covers every strategy under codecs none / zstd / zstd+delta on the host
path, the device pre-codec under precodec none and int8, an elastic
2x2 -> 3x1 restore with L1 dropped, and partial restores. The port runs
with ``device="cpu"`` (the kernels' plain versions); the JAX package
with Pallas in interpret mode.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
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
