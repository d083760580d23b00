"""Streams, leaf tables, rank blobs and manifests of the port's encoder
are byte-identical to the JAX package's, for every codec and framing,
on a state holding f32, bf16, bool and int32 leaves."""
import os
from dataclasses import astuple

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.serialize as RS
import repro.core.serialize_ref as RSR
import repro_torch.core.serialize as TS
import repro_torch.core.serialize_ref as TSR
from repro.core.cluster import theta_like as r_theta
from repro_torch.core.cluster import theta_like as t_theta
from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy


def numpy_state(step):
    rng = np.random.default_rng(100 + step)
    return {
        "params": {
            "w": (rng.standard_normal((96, 300)) + step).astype(np.float32),
            "h": np.asarray(jnp.asarray(rng.standard_normal((40, 130)), jnp.bfloat16)),
            "b": np.full((37,), 0.5 * step, np.float32),
        },
        "mask": rng.random(513) < 0.5,
        "ids": rng.integers(-1000, 1000, (7, 11)).astype(np.int32),
        "step": np.array(step, np.int32),
    }


def _rows(leaves):
    """Leaf table rows; the two packages' LeafEntry classes never compare equal."""
    return [astuple(l) for l in leaves]


def _encode_both(codec, chunk_size, chunk_aligned):
    """Encode steps 1 and 2 (2 a small update of 1) in both packages."""
    out = []
    for pkg, theta, conv in (
        (RS, r_theta, lambda s: s),
        (TS, t_theta, lambda s: tree_from_numpy(s, "cpu")),
    ):
        cluster = theta(2, 3)
        s1 = numpy_state(1)
        s2 = dict(s1, step=np.array(2, np.int32))
        s2["params"] = dict(s1["params"], b=s1["params"]["b"] + 1)
        e1 = pkg.encode_state(1, conv(s1), cluster, codec=codec,
                              chunk_size=chunk_size, chunk_aligned=chunk_aligned)
        e2 = pkg.encode_state(2, conv(s2), cluster, codec=codec, base=e1,
                              chunk_size=chunk_size, chunk_aligned=chunk_aligned)
        out.append((e1, e2))
    return out


@pytest.mark.parametrize("codec", ["none", "zstd", "zstd+delta"])
@pytest.mark.parametrize(
    "chunk_size,chunk_aligned",
    [(0, False), (4096, False), (4096, True), (1 << 20, False), (1 << 20, True)],
)
def test_encoded_state_matches(codec, chunk_size, chunk_aligned):
    ref, got = _encode_both(codec, chunk_size, chunk_aligned)
    for r, t in zip(ref, got):
        assert bytes(r.stream) == bytes(t.stream)
        assert _rows(r.manifest.leaves) == _rows(t.manifest.leaves)
        assert r.manifest.to_json() == t.manifest.to_json()
        assert [bytes(b) for b in r.blobs] == [bytes(b) for b in t.blobs]
    if codec == "zstd+delta":
        assert got[1].manifest.base_step == 1


def test_serialize_reference_matches_fast_path():
    state = tree_from_numpy(numpy_state(3), "cpu")
    stream, leaves = TS.serialize_tree(state)
    ref_stream, ref_leaves = TSR.serialize_tree_reference(state)
    assert bytes(stream) == ref_stream and leaves == ref_leaves
    jstream, jleaves = RSR.serialize_tree_reference(numpy_state(3))
    assert ref_stream == jstream and _rows(ref_leaves) == _rows(jleaves)


def test_bf16_leaf_entry_and_decode():
    state = tree_from_numpy(numpy_state(4), "cpu")
    stream, leaves = TS.serialize_tree(state)
    entry = next(l for l in leaves if l.name == "['params']['h']")
    assert entry.dtype == "bfloat16" and entry.shape == (40, 130)
    back = TS.deserialize_tree(stream, leaves, state)
    assert back["params"]["h"].dtype == torch.bfloat16
    for a, b in zip(
        TS.flatten_with_names(tree_to_numpy(back))[0],
        TS.flatten_with_names(numpy_state(4))[0],
    ):
        assert a[1].dtype == b[1].dtype and a[1].tobytes() == b[1].tobytes()


def test_decode_state_of_reference_checkpoint():
    """A stream the JAX package encoded decodes in the port."""
    cluster = r_theta(2, 2)
    enc = RS.encode_state(5, numpy_state(5), cluster, codec="zstd", chunk_size=4096)
    target = tree_from_numpy(numpy_state(0), "cpu")
    back = TS.decode_state(TS.Manifest.from_json(enc.manifest.to_json()),
                           enc.blobs, target)
    want = numpy_state(5)
    got = tree_to_numpy(back)
    for (n, a), (_, b) in zip(TS.flatten_with_names(got)[0],
                              TS.flatten_with_names(want)[0]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), n


def test_deserialize_rejects_wrong_names():
    state = tree_from_numpy(numpy_state(1), "cpu")
    stream, leaves = TS.serialize_tree(state)
    with pytest.raises(ValueError):
        TS.deserialize_tree(stream, leaves, {"other": state["params"], "x": 1,
                                             "y": 2, "z": 3})
