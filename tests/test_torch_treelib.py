"""The port's pytree helpers give JAX's leaf order and names, and
convert.py carries NumPy states into torch tensors and back exactly."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from collections import OrderedDict
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.utils.treelib import flatten_with_names as jax_flatten
from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy
from repro_torch.utils.treelib import flatten_with_names, tree_map, unflatten


class _Cache(NamedTuple):
    k: object
    v: object
    pos: object


def _shuffled(d, rng):
    keys = list(d)
    rng.shuffle(keys)
    return {k: d[k] for k in keys}


def _trees():
    rng = np.random.default_rng(0)
    counter = iter(range(1000))
    leaf = lambda: np.full((2,), next(counter), np.int32)
    state = {
        "step": leaf(),
        "params": {
            "layers": [{"w": leaf(), "b": leaf()}, {"w": leaf(), "b": leaf()}],
            "embed": leaf(),
            "norm": (leaf(), None, leaf()),
        },
        "opt": {"mu": {"z": leaf(), "a": leaf()}, "count": leaf()},
    }
    trees = {
        "train_state": state,
        "shuffled": _shuffled(
            {k: _shuffled(v, rng) if isinstance(v, dict) else v for k, v in state.items()},
            rng,
        ),
        "int_keys": {3: leaf(), 1: [leaf(), {10: leaf(), 2: leaf()}], 0: None},
        "tuple_root": (leaf(), [leaf(), (leaf(),)], {"y": leaf(), "x": leaf()}),
        "ordered": OrderedDict([("b", leaf()), ("a", leaf())]),
        "empty_nodes": {"a": [], "b": {}, "c": (), "d": leaf()},
        "scalar": leaf(),
        # a serving snapshot: JAX names a NamedTuple's children by field
        # (".k"), not by index, and unflatten must give the type back
        "namedtuple": {
            "cache": _Cache(leaf(), leaf(), leaf()),
            "tok": leaf(),
            "nested": [_Cache([leaf(), None], {"b": leaf(), "a": leaf()}, (leaf(),))],
        },
    }
    return trees


TREES = _trees()


@pytest.mark.parametrize("name", sorted(TREES))
def test_names_and_order_match_jax(name):
    tree = TREES[name]
    got, treedef = flatten_with_names(tree)
    ref, _ = jax_flatten(tree)
    assert [n for n, _ in got] == [n for n, _ in ref]
    assert all(a is b for (_, a), (_, b) in zip(got, ref))
    # the treedef rebuilds the same structure
    back = unflatten(treedef, [l for _, l in got])
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    if name == "namedtuple":
        assert "['cache'].k" in [n for n, _ in got]
        assert type(back["cache"]) is _Cache and type(back["nested"][0]) is _Cache


def test_dict_order_is_sorted_not_insertion():
    tree = {"step": 1, "params": 2, "opt": 3}
    assert [n for n, _ in flatten_with_names(tree)[0]] == [
        "['opt']", "['params']", "['step']"
    ]


def test_unflatten_rejects_extra_leaves():
    _, treedef = flatten_with_names({"a": 1})
    with pytest.raises(ValueError):
        unflatten(treedef, [1, 2])


def test_tree_map_is_leafwise():
    out = tree_map(lambda x: x * 2, {"b": [1, (2, None)], "a": 3})
    assert out == {"a": 6, "b": [2, (4, None)]}


def _numpy_state():
    rng = np.random.default_rng(1)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "bf16": np.asarray(jnp.asarray(rng.standard_normal((4, 7)), jnp.bfloat16)),
        "f16": rng.standard_normal(9).astype(np.float16),
        "i32": rng.integers(-5, 5, (2, 2)).astype(np.int32),
        "u8": rng.integers(0, 255, 6).astype(np.uint8),
        "flag": rng.random(5) < 0.5,
        "scalar": np.array(3, np.int32),
        "f64": rng.standard_normal(4),
    }


def test_convert_round_trip():
    state = _numpy_state()
    t = tree_from_numpy(state, "cpu")
    assert t["bf16"].dtype == torch.bfloat16
    assert t["flag"].dtype == torch.bool
    assert t["scalar"].shape == () and t["scalar"].dtype == torch.int32
    back = tree_to_numpy(t)
    for k, v in state.items():
        assert back[k].dtype == v.dtype, k
        assert back[k].shape == v.shape, k
        assert back[k].tobytes() == v.tobytes(), k


def test_convert_bf16_values():
    x = np.asarray(jnp.asarray([1.5, -2.25, 3.0e38, 1e-40], jnp.bfloat16))
    t = tree_from_numpy(x, "cpu")
    np.testing.assert_array_equal(
        t.float().numpy(), x.astype(np.float32)
    )


def test_convert_copies():
    a = np.zeros(4, np.float32)
    t = tree_from_numpy(a, "cpu")
    a[0] = 1
    assert float(t[0]) == 0.0
